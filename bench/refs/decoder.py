"""Plain reference of the dense and MoE decoders the port serves and trains
(``bench/configs/*.json`` with ``"reference": "bench/refs/decoder.py"``).

Written from the layer equations, in float32 (``precision="f32"``, TF32
off), with no kernel, no cache and no batching:

- embedding lookup; per layer ``x += attn(rms(x) * g1)``, ``x += ffn(rms(x)
  * g2)``; logits ``rms(x) * g_f @ unemb``;
- ``rms(x) = x / sqrt(mean(x^2) + eps)``;
- attention: ``q, k, v = x Wq, x Wk, x Wv``; rotary embedding on q and k by
  halves (``[x1 cos - x2 sin, x1 sin + x2 cos]``, frequencies ``theta^(-2j /
  hd)``) at positions ``0 .. S-1``; q head ``h`` reads kv head ``h // (H /
  Hkv)``; causal softmax of ``q k^T / sqrt(hd)``; ``out Wo``;
- gated FFN ``(x Wi * silu(x Wg)) Wo``;
- MoE: router ``softmax(x Wr)`` in float32, the ``k`` largest (the lower
  index first among equals), renormalised to sum 1; each routed pair's
  expert output summed with its weight;
- expert capacity, as the configuration states it (``moe_capacity``:
  ``factor``, ``multiple``, ``min``): rows routed together as one group
  of ``T`` tokens (a prompt's prefill, ``T`` its page) give each expert
  ``C = max(min, multiple * ceil(floor(T k / E * factor) / multiple))``
  places, taken by the group's pairs in row order; a pair past them adds
  nothing (its weight is not renormalised). Rows in no group (the served
  tokens, decoded beside other requests the reference does not see) and a
  configuration with no ``moe_capacity`` are dropless.

``precision="fp8"`` is the control: every weight product takes its inputs
rounded to ``float8_e4m3fn`` (weights at one scale a tensor or an expert,
activations one a row; the router and the attention's own products stay
float32), and :func:`train_steps` keeps the parameters in ``float8_e4m3fn``
between steps. The weights come from a callable the harness hands over
(``get(prefix)`` yields ``(name, tensor)`` of the leaves under ``prefix``);
this file imports ``torch`` alone.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

Getter = Callable[[str], Iterable[Tuple[str, torch.Tensor]]]

FP8_MAX = 448.0


def set_exact_matmul() -> Tuple[bool, bool]:
    """Turn TF32 off for float32 products (returns the old flags)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def restore_matmul(old: Tuple[bool, bool]) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fake_fp8(t: torch.Tensor, dims=None) -> torch.Tensor:
    """``t`` rounded to ``float8_e4m3fn`` at the scale that maps its
    largest magnitude (over ``dims``; all of it for ``None``) to 448, back
    in float32."""
    a = (t.detach().abs().amax() if dims is None
         else t.detach().abs().amax(dim=dims, keepdim=True))
    s = torch.clamp(a.float(), min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    # the gradient passes through the rounding unchanged (straight-through)
    return t + (q - t).detach() if t.requires_grad else q


def _hd(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd], pos [S]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Layer:
    """One layer's weights in float32 (and, for the control, the weights
    rounded to fp8 once)."""

    def __init__(self, m: Dict, leaves: Dict[str, torch.Tensor],
                 precision: str):
        self.m, self.precision = m, precision
        self.w = leaves
        self.q: Dict[str, torch.Tensor] = {}

    def weight(self, name: str, dims=None) -> torch.Tensor:
        w = self.w[name]
        if self.precision != "fp8":
            return w
        if name not in self.q:
            self.q[name] = fake_fp8(w, dims)
        return self.q[name]

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x, -1) if self.precision == "fp8" else x


def _attention(L: Layer, x: torch.Tensor) -> torch.Tensor:
    """x [S, d] of one sequence -> [S, d]."""
    m = L.m
    S, d = x.shape
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    xa = L.act(x)
    q = (xa @ L.weight("attn/wq").reshape(d, H * hd)).view(S, H, hd)
    k = (xa @ L.weight("attn/wk").reshape(d, Hkv * hd)).view(S, Hkv, hd)
    v = (xa @ L.weight("attn/wv").reshape(d, Hkv * hd)).view(S, Hkv, hd)
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    G = H // Hkv
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return L.act(o) @ L.weight("attn/wo").reshape(H * hd, d)


def _ffn(L: Layer, x: torch.Tensor, wi: str, wg: str, wo: str,
         e: Optional[int] = None) -> torch.Tensor:
    dims = None if e is None else (1, 2)

    def w(n):
        t = L.weight(n, dims)
        return t if e is None else t[e]
    xa = L.act(x)
    a, g = xa @ w(wi), xa @ w(wg)
    act = F.silu(g) if L.m.get("act", "silu") == "silu" else F.gelu(
        g, approximate="tanh")
    return L.act(a * act) @ w(wo)


def capacity(m: Dict, tokens: int) -> int:
    """Places a group of ``tokens`` tokens gives each expert."""
    c = m["moe_capacity"]
    n = int(tokens * m["experts_per_token"] / m["n_experts"] * c["factor"])
    return max(c["min"], -(-n // c["multiple"]) * c["multiple"])


def _moe(L: Layer, x: torch.Tensor,
         groups: Sequence[Tuple[int, int, int]] = ()) -> torch.Tensor:
    """x [T, d] -> [T, d]. ``groups``: ``(first row, end row, places an
    expert)`` of each group of rows routed together."""
    m = L.m
    k, E = m["experts_per_token"], m["n_experts"]
    probs = torch.softmax(x @ L.w["mlp/router"], dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :k], order[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    for a, b, places in groups:
        hot = F.one_hot(idx[a:b], E).sum(dim=1)           # [rows, E]
        earlier = torch.cumsum(hot, dim=0) - hot
        w[a:b] = w[a:b] * (earlier.gather(1, idx[a:b]) < places)
    y = torch.zeros_like(x)
    for e in range(E):
        hit = idx == e
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (w * hit)[rows].sum(dim=-1, keepdim=True)
        y.index_add_(0, rows, we * _ffn(L, x[rows], "mlp/experts/wi",
                                        "mlp/experts/wg", "mlp/experts/wo",
                                        e))
    return y


def _mlp(L: Layer, x: torch.Tensor,
         groups: Sequence[Tuple[int, int, int]] = ()) -> torch.Tensor:
    if L.m["family"] == "moe":
        return _moe(L, x, groups)
    return _ffn(L, x, "mlp/wi", "mlp/wg", "mlp/wo")


def _layer_f32(get: Getter, prefix: str) -> Dict[str, torch.Tensor]:
    return {n: t.float() for n, t in get(prefix)}


def _leaf(get: Getter, path: str) -> torch.Tensor:
    """The one leaf at ``path``, in float32."""
    return next(t for n, t in get(path) if n == "").float()


def serve_logits(m: Dict, get: Getter, seqs: Sequence[torch.Tensor],
                 want: Sequence[torch.Tensor],
                 groups: Sequence[Tuple[int, int]],
                 precisions: Sequence[str] = ("f32",)
                 ) -> Dict[str, List[torch.Tensor]]:
    """Logits [len(want[i]), vocab_size] of each token sequence ``seqs[i]``
    (a whole prompt with its served tokens, starting at position 0) at the
    positions ``want[i]``, for each precision; the layers one at a time,
    every sequence through each (the weights are drawn once a layer).
    ``groups[i] = (rows, tokens)``: the first ``rows`` rows of ``seqs[i]``
    are routed as one group of ``tokens`` tokens (its prompt's prefill)."""
    eps = m.get("norm_eps", 1e-5)
    spans, start = [], 0
    for s, (rows, tokens) in zip(seqs, groups):
        if m["family"] == "moe" and m.get("moe_capacity"):
            spans.append((start, start + rows, capacity(m, tokens)))
        start += len(s)
    emb = _leaf(get, "emb")
    h = {pr: [emb[s.long()] for s in seqs] for pr in precisions}
    del emb
    for i in range(m["n_layers"]):
        leaves = _layer_f32(get, f"layers/{i}/")
        for pr in precisions:
            L = Layer(m, leaves, pr)
            xs = []
            for x in h[pr]:
                x = x + _attention(L, rms(x, leaves["ln1"], eps))
                xs.append(x)
            lens = [x.shape[0] for x in xs]
            flat = torch.cat(xs)
            flat = flat + _mlp(L, rms(flat, leaves["ln2"], eps), spans)
            h[pr] = list(torch.split(flat, lens))
            del L
        del leaves
    head = _leaf(get, "ln_f")
    unemb = (_leaf(get, "emb").T if m.get("tie_embeddings")
             else _leaf(get, "unemb"))
    out = {}
    V = m["vocab_size"]
    for pr in precisions:
        w = fake_fp8(unemb) if pr == "fp8" else unemb
        rows = []
        for x, pos in zip(h[pr], want):
            z = rms(x[pos.long()], head, eps)
            z = fake_fp8(z, -1) if pr == "fp8" else z
            rows.append((z @ w)[:, :V])
        out[pr] = rows
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _train_layer(m: Dict, precision: str, x: torch.Tensor,
                 *flat: torch.Tensor) -> torch.Tensor:
    names = _LAYER_NAMES[m["family"]]
    L = Layer(m, dict(zip(names, flat)), precision)
    eps = m.get("norm_eps", 1e-5)
    out = []
    for b in range(x.shape[0]):
        xb = x[b]
        xb = xb + _attention(L, rms(xb, L.w["ln1"], eps))
        out.append(xb + _mlp(L, rms(xb, L.w["ln2"], eps)))
    return torch.stack(out)


_LAYER_NAMES = {
    "dense": ("ln1", "ln2", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
              "mlp/wi", "mlp/wg", "mlp/wo"),
}


def loss(m: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens [B, S + 1]`` over all
    ``B * S`` labels; ``params`` by path (``emb``, ``layers/0/attn/wq``,
    ...), float32. Each layer is recomputed in the backward."""
    if m["family"] not in _LAYER_NAMES:
        raise ValueError(f"no training reference for {m['family']!r}")
    eps = m.get("norm_eps", 1e-5)
    inputs, labels = tokens[:, :-1].long(), tokens[:, 1:].long()
    x = params["emb"][inputs]
    names = _LAYER_NAMES[m["family"]]
    for i in range(m["n_layers"]):
        flat = [params[f"layers/{i}/{n}"] for n in names]
        x = checkpoint.checkpoint(_train_layer, m, precision, x, *flat,
                                  use_reentrant=False)
    z = rms(x, params["ln_f"], eps)
    w = params["emb"].T if m.get("tie_embeddings") else params["unemb"]
    if precision == "fp8":
        z, w = fake_fp8(z, -1), fake_fp8(w)
    tot = torch.zeros((), device=x.device)
    B, S = labels.shape
    zf, lf = z.reshape(B * S, -1), labels.reshape(-1)
    for i in range(0, B * S, 1024):
        tot = tot + checkpoint.checkpoint(
            lambda zc, lc: F.cross_entropy(zc @ w, lc, reduction="sum"),
            zf[i:i + 1024], lf[i:i + 1024], use_reentrant=False)
    return tot / (B * S)


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_frac * lr`` at ``decay_steps`` (step counted from 1)."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    frac = min(max((step - warm) / max(opt["decay_steps"] - warm, 1), 0.0),
               1.0)
    mf = opt["min_lr_frac"]
    return lr * (mf + (1 - mf) * 0.5 * (1 + math.cos(math.pi * frac)))


def _store(t: torch.Tensor, dtype: torch.dtype, precision: str
           ) -> torch.Tensor:
    """A parameter as the configuration keeps it between steps."""
    if precision == "fp8":
        return fake_fp8(t)
    return t.to(dtype).float()


def train_steps(m: Dict, opt: Dict, get: Getter,
                batches: Sequence[torch.Tensor], precision: str = "f32"
                ) -> Dict:
    """AdamW steps over ``batches`` from the parameters ``get("")`` yields
    (by path, in the configuration's dtype), computed in float32 and kept
    between steps in that dtype (the control: in fp8). Returns the losses,
    the first step's global gradient norm before clipping, each leaf's norm
    of the first gradient as the update takes it (after clipping), and
    each leaf's norm of the change after all the steps (the parameters
    drawn again to compare)."""
    store_dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "float32": torch.float32}[m["dtype"]]
    p = {n: _store(t.float(), store_dtype, precision).requires_grad_()
         for n, t in get("")}
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    vel = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    out = {"losses": [], "grad1_norm": None, "grad1_leaf": {}}
    for step, tokens in enumerate(batches, start=1):
        lv = loss(m, p, tokens, precision)
        grads = torch.autograd.grad(lv, list(p.values()))
        out["losses"].append(float(lv.detach()))
        with torch.no_grad():
            gn = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
            scale = min(opt["clip_norm"] / max(gn, 1e-9), 1.0)
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for (n, t), g in zip(p.items(), grads):
                g = g * scale
                if step == 1:
                    out["grad1_leaf"][n] = float(torch.linalg.vector_norm(g))
                mom[n].mul_(b1).add_(g, alpha=1 - b1)
                vel[n].mul_(b2).add_(g * g, alpha=1 - b2)
                delta = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2) + eps)
                if t.ndim >= 2:
                    delta = delta + wd * t
                t.copy_(_store(t - lr * delta, store_dtype, precision))
            if step == 1:
                out["grad1_norm"] = gn
            del grads
    del mom, vel
    with torch.no_grad():
        out["change_leaf"] = {
            n: float(torch.linalg.vector_norm(p[n] - t0.float()))
            for n, t0 in get("")}
    return out
