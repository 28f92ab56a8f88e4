"""Attention: chunked online-softmax forward and GQA, with per-slot KV
caches for decode, MLA with absorbed decode, and cross-attention.

:func:`chunked_attention` dispatches on its arguments, as the reference's
``chunked_attention`` picks its flash path. What the hand-written flash
kernel computes, the same function with the same outputs, goes to
:func:`repro_torch.kernels.ops.flash_attention_op` with the tiles
:func:`flash_tiles` picks: CUDA tensors at query offset 0, with no kv mask
and no window that masks a key, causal or not. That is

- causal prefill self-attention (the dense, MoE and hybrid trunks, the VLM
  and enc-dec decoders), for any sequence length (a ragged last tile runs
  masked);
- non-causal attention over a whole memory: the enc-dec encoder's
  self-attention (``Sq = Skv = F``), cross-attention at prefill (``Sq`` the
  prompt, ``Skv = F``) and cross-attention at each decode step (``Sq = 1``),
  whose keys come from the cache and are never masked.

A window of ``w`` keys masks nothing while ``Sq <= w``, causal or not: the
farthest key a query at offset 0 must reach is ``Sq - 1`` positions back
(RecurrentGemma's local attention at every prompt up to its 2048-token
window). At ``Sq > w`` it masks keys, which the kernel does not do, and the
call takes the plain route; so do query offsets and kv masks (the decode
self-attention over a cache of written rows). That is the kernel's
contract, not a fallback on failure: what the kernels are not built for
(head dims above 256, float16) raises in their wrapper; every head dim up
to 256 runs at its head-dim class. Every call on CPU tensors takes
the plain blocked online softmax,
:func:`repro_torch.kernels.flash_attention.flash_attention_plain`.

Decode writes each new K/V row into the cache in place (``index_copy_`` /
index assignment on the cache tensors) and returns the same tensors; a
cache of ``window`` slots is a ring (slot ``pos % window``).

MLA (DeepSeek-V3): prefill decompresses per-head K and V from the latent
and goes through :func:`chunked_attention` with q/k head dim
``qk_nope + qk_rope`` and v head dim ``v_head_dim`` (192 and 128 at full
width: both kernels' ``(192, 128)`` instantiation; 24 and 16 in the
reduced config, the ``(32, 32)`` class); decode is the
absorbed form over the ``(c_kv, k_rope)`` cache, in plain PyTorch, as the
reference computes it outside any kernel.

Cross-attention (VLM, enc-dec): queries from the decoder, keys and values
from the memory (the frontend, or the encoder's output), no rope, no bias,
non-causal over the whole memory; :func:`cross_attention` also returns the
memory's K and V, which decode reads from the cache.

Training: the flash kernel has no backward. While autograd records (grad
enabled and q, k or v requiring grad), a call at offset 0 without a kv
mask, causal or not, windowed or not, goes on every device to
:class:`FlashAttention`: the plain blocked online softmax in f32 forward,
keeping only ``(q, k, v, out, lse)``, and a backward that recomputes p a
block at a time from ``lse`` (the reference's ``_flash`` custom_vjp). A
recording call at a query offset or with a kv mask takes the plain route,
and autograd runs through its loops. Calls that record nothing (serving,
``torch.no_grad()``) route as above.

Tensor parallelism (a mesh that splits ``heads`` over two or more ranks,
:func:`repro_torch.models.common.sharding_ctx`): each rank holds the
columns of ``wq`` (and ``wk`` / ``wv`` where the kv heads split too) of its
own q heads and the matching rows of ``wo``, so q, k and v are rank-local
heads, attention (the flash kernel on the card) runs on them alone, and
the output projection's partial sums are all-reduced over ``model`` (the
input enters through ``copy_to``, the output leaves through
``reduce_from``: Megatron's f / g). Where the kv heads do not split
(``nkv % tp != 0``) every rank holds all of them, computes them all (the
cache keeps them all, as the reference's replicated cache spec says), and
attends its q head ``h`` to kv head ``h // G``; those weights pass through
``copy_to`` too, since each rank's gradient of them covers its own heads
only. Cross-attention and the enc-dec encoder's non-causal self-attention
split the same way, the cross-attention's memory entering through
``copy_to`` as its queries' input does. MLA splits its heads the same way;
its latent path (``wq_a``,
``wkv_a``, the norms, the shared rope key) is replicated, and the latent
activations enter the head-split products through ``copy_to``.

Under a sequence split (``seq``, the training trunks' and the encoder's
under the rule ``seq -> model``) the input is this rank's rows: it is
gathered whole on the way in (``gather_to``; MLA ``gather_from``, since its
latents' ``copy_to`` makes its gradient whole) and the output's partial
sums are reduce-scattered back onto the rows (``reduce_scatter_from``), so
attention itself runs on this rank's heads over the whole sequence, on the
card through the flash kernel as on the local path.

A decode cache split over the sequence (``Runtime.decode_cache_shard=
"seq"``: the kv heads do not split over ``model``, or MLA's latent cache)
holds positions ``[r M / tp, (r + 1) M / tp)`` on rank ``r`` of the group
given as ``seq_group``. Decode then writes a new row only on the rank that
owns its position, and attends flash-decoding's way: q gathered over the
head split, each rank's f32 partials over its own positions (the row max,
the sum of ``exp(s - max)`` and the unnormalised ``P V``), the maxima
all-reduced over ``model``, the rescaled sums reduce-scattered back onto
each rank's own heads, then normalised. A rank that holds no valid
position contributes exactly nothing (max ``-inf``, sums 0).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import (ParamMaker, apply_rope, axis_group,
                                       axis_size, enter, leave, rms_norm,
                                       shard)
from repro_torch.parallel import collectives as coll

NEG_INF = -1e30

#: the flash kernel's tiles on the model's prefill path, by dtype: for bf16
#: the fastest tile of the wgmma kernel at the served model's prefill shape
#: (and at head dim 160, where 128 x 128 keeps only two stages), for f32 the
#: fastest tile of the 3xTF32 kernel at the SPACES shape, both on the H100
#: (PERF.md); the f32 tile is the one that fits at every head-dim class (at
#: (256, 256) it is the only one), the bf16 tile at every class but (256,
#: 256)
FLASH_TILES = {torch.bfloat16: (128, 64), torch.float32: (32, 64)}
#: the tiles at a head-dim class ``(D, Dv)`` (``fa.head_dim_class``) where
#: FLASH_TILES' are not built, or are slower: at (256, 256) the bf16 kernel
#: has 64 x 64 only (its 128 x 64 would spill, ``fa.BF16_SPILLING_TILES``);
#: the f32 kernel's fastest tile at 4 x 1024 tokens of 16 heads at (96, 96)
#: (1.40x 32 x 64) and (192, 192) (1.17x), and at MLA's prefill (1.21x),
#: on the H100 (tools/flash_head_dims_check.py; PERF.md §6)
FLASH_TILES_BY_HEAD_DIMS = {(torch.bfloat16, 256, 256): (64, 64),
                            (torch.float32, 96, 96): (128, 64),
                            (torch.float32, 192, 192): (64, 64),
                            (torch.float32, 192, 128): (64, 64)}
#: the tiles of a non-causal call at a head-dim class ``(D, Dv)`` where
#: they beat the causal ones: bf16 at 128 and 64, where every q tile walks
#: every kv tile, 128 x 128 beat 128 x 64 beyond the spread of five rounds
#: on the H100 (the VLM's cross-attention at prefill by 7.2 %, the enc-dec's
#: encoder by 5.2 %; PERF.md §6)
NONCAUSAL_FLASH_TILES = {(torch.bfloat16, 128, 128): (128, 128),
                         (torch.bfloat16, 64, 64): (128, 128)}
#: a non-causal bf16 call whose query fits in this many rows (a decode
#: step's cross-attention, Sq = 1) takes q tiles of this many rows: a
#: 128-row tile runs its second consumer warpgroup on zero rows (64 x 128
#: beat 128 x 64 by 10.6 % / 18 % at the VLM's / enc-dec's decode step)
SHORT_QUERY_BLOCK_Q = 64

IntOrTensor = Union[int, torch.Tensor]


def _pick_chunk(n: int, pref: int) -> int:
    c = min(pref, n)
    while c > 1 and n % c:
        c //= 2
    if n % c:  # odd sizes: fall back to divisor search
        for c in range(min(pref, n), 0, -1):
            if n % c == 0:
                return c
    return max(c, 1)


def flash_tiles(dtype: torch.dtype,
                head_dims: Optional[Tuple[int, int]] = None,
                causal: bool = True,
                seq_q: Optional[int] = None) -> Tuple[int, int]:
    """The kernel's ``(block_q, block_k)`` for a call of ``dtype`` (at
    ``head_dims`` ``(D, Dv)``, whose head-dim class
    :data:`FLASH_TILES_BY_HEAD_DIMS` and, for a non-causal call,
    :data:`NONCAUSAL_FLASH_TILES` may name; a non-causal bf16 query of
    ``seq_q <= SHORT_QUERY_BLOCK_Q`` rows in q tiles of that many rows), at
    every length: the kernel masks a ragged last tile (and a tile longer
    than the sequence). For every pair ``1 <= D, Dv <= 256`` of a dtype the
    kernels take, ``fa.unsupported`` accepts the tile. A dtype or head dims
    the kernels do not take get the default tiles, and the kernel's wrapper
    refuses them."""
    tiles = FLASH_TILES.get(dtype, (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K))
    cls = None if head_dims is None else fa.head_dim_class(*head_dims)
    if cls is not None:
        key = (dtype, *cls)
        tiles = FLASH_TILES_BY_HEAD_DIMS.get(key, tiles)
        if not causal:
            tiles = NONCAUSAL_FLASH_TILES.get(key, tiles)
    if (dtype == torch.bfloat16 and not causal and seq_q is not None
            and seq_q <= SHORT_QUERY_BLOCK_Q):
        tiles = (SHORT_QUERY_BLOCK_Q, tiles[1])
    return tiles


def _on_card(q: torch.Tensor) -> bool:
    return q.is_cuda


def _kernel_case(q, q_offset, kv_valid_len, window: int) -> bool:
    """What the flash kernel computes, causal or not: CUDA tensors, offset
    0, no kv mask, and no window or one that masks no key (``Sq <=
    window``: the farthest key a query at offset 0 must reach is ``Sq - 1``
    positions back)."""
    return (_on_card(q) and kv_valid_len is None
            and (not window or q.shape[1] <= window)
            and isinstance(q_offset, int) and q_offset == 0)


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, window: int,
               scale: float, qc: int, kc: int):
    """The attention's backward from ``(q, k, v, out, lse)`` and ``dout``,
    all in f32: ``D_i = rowsum(dO * O)``; for each (q chunk, kv chunk)
    pair, p recomputed from ``lse`` and ``ds = p (dp - D_i) scale``. dq
    sums over the kv chunks, dk and dv over the q chunks (in those orders,
    as the reference's two scans); the G query heads of a kv group sum into
    it. A pair the causal or window mask covers wholly is skipped: its p is
    exactly 0. Never holds more than one ``[qc, kc]`` block of scores."""
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    dev = q.device
    qg = q.float().reshape(B, Sq, Hkv, G, Dk)
    dog = dout.float().reshape(B, Sq, Hkv, G, Dv)
    Dterm = torch.einsum("bshgd,bshgd->bhgs", dog,
                         out.float().reshape(B, Sq, Hkv, G, Dv))
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Sq, Hkv, G, Dk), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Hkv, Dk), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Skv, Hkv, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, qc):
        q1 = min(q0 + qc, Sq)
        qch, do_i = qg[:, q0:q1], dog[:, q0:q1]
        lse_i, D_i = lse[..., q0:q1, None], Dterm[..., q0:q1, None]
        qpos = torch.arange(q0, q1, dtype=torch.int32, device=dev)
        for k0 in range(0, Skv, kc):
            k1 = min(k0 + kc, Skv)
            if (causal and k0 > q1 - 1) or (window and k1 - 1 <= q0 - window):
                continue
            kch, vch = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qch, kch) * scale
            kpos = torch.arange(k0, k1, dtype=torch.int32, device=dev)
            mask = fa._block_mask(qpos, kpos, causal, window, None)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse_i)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do_i, vch)
            ds = p * (dp - D_i) * scale
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kch)
            dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qch)
            dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, do_i)
    return (dq.reshape(B, Sq, Hq, Dk).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention at offset 0 without a kv mask, differentiable: the plain
    blocked online softmax forward in f32 (out in v's dtype), saving
    ``(q, k, v, out, lse)`` and nothing of size ``Sq x Skv``;
    :func:`_flash_bwd` backward. The reference's ``_flash`` /
    ``_flash_fwd`` / ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float,
                qc: int, kc: int):
        out, lse = fa.flash_attention_plain(
            q, k, v, causal=causal, scale=scale, block_q=qc, block_k=kc,
            window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, qc, kc)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(
    q: torch.Tensor,                 # [B, Sq, Hq, Dk]
    k: torch.Tensor,                 # [B, Skv, Hkv, Dk]
    v: torch.Tensor,                 # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: IntOrTensor = 0,       # absolute position of q[0]
    kv_valid_len: Optional[torch.Tensor] = None,  # mask kv positions >= this
    window: int = 0,                 # 0 = global; >0 = local attention width
    softmax_scale: Optional[float] = None,
    q_chunk: int = 2048,
    kv_chunk: int = 1024,
    impl: str = "kernel",
) -> torch.Tensor:
    """Doubly-chunked online-softmax attention; f32 accumulation.

    ``impl="kernel"`` sends the flash kernel's case on the card to the
    kernel (see the module docstring); ``impl="plain"`` keeps every call on
    the plain version (the route the end-to-end check compares against).
    While autograd records, ``impl`` is not read: a call at offset 0
    without a kv mask goes to :class:`FlashAttention`, any other to the
    plain version."""
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, Dv = v.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    scale = softmax_scale if softmax_scale is not None else Dk ** -0.5
    qc, kc = _pick_chunk(Sq, q_chunk), _pick_chunk(Skv, kv_chunk)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if (grad and kv_valid_len is None and isinstance(q_offset, int)
            and q_offset == 0):
        return FlashAttention.apply(q, k, v, causal, window, scale, qc, kc)
    if (not grad and impl == "kernel"
            and _kernel_case(q, q_offset, kv_valid_len, window)):
        from repro_torch.kernels import ops
        bq, bk = flash_tiles(q.dtype, (Dk, Dv), causal, Sq)
        return ops.flash_attention_op(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk, scale=scale)
    return fa.flash_attention_plain(
        q, k, v, causal=causal, scale=scale, block_q=qc, block_k=kc,
        q_offset=q_offset, window=window, kv_valid_len=kv_valid_len)


# ---------------------------------------------------------------------------
# Standard GQA attention block (dense / hybrid / vlm / encdec trunks)
# ---------------------------------------------------------------------------
def attention_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
                     tp: int = 1, cross: bool = False) -> Dict:
    """``wq``, ``wk``, ``wv``, ``wo`` and, where ``cfg.qkv_bias``, the
    biases; a cross-attention block (``cross``) has none."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    h_ax = "heads" if nh % max(tp, 1) == 0 and tp > 1 else None
    kv_ax = "kv_heads" if (tp > 1 and nkv % tp == 0) else None
    p = {
        "wq": mk(f"{prefix}.wq", (d, nh, hd), ("dmodel", h_ax, None)),
        "wk": mk(f"{prefix}.wk", (d, nkv, hd), ("dmodel", kv_ax, None)),
        "wv": mk(f"{prefix}.wv", (d, nkv, hd), ("dmodel", kv_ax, None)),
        "wo": mk(f"{prefix}.wo", (nh, hd, d), (h_ax, None, "dmodel")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = mk(f"{prefix}.bq", (nh, hd), (h_ax, None), init="zeros")
        p["bk"] = mk(f"{prefix}.bk", (nkv, hd), (kv_ax, None), init="zeros")
        p["bv"] = mk(f"{prefix}.bv", (nkv, hd), (kv_ax, None), init="zeros")
    return p


def head_split(cfg: ModelConfig):
    """``(group, kv_heads)`` of the installed mesh's split of the q heads:
    the model-axis group, and where the kv heads do not split, the kv
    heads this rank's q heads attend to (q head ``h`` to kv head ``h //
    G``; a run of equal heads collapses into one, so the local group ratio
    stays ``G`` or divides it). ``(None, None)`` without a split: no mesh,
    one rank on ``heads``, or q heads that do not divide over it."""
    tp = axis_size("heads")
    if tp < 2 or cfg.padded_heads(tp) % tp:
        return None, None
    grp = axis_group("heads")
    nh, nkv = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    if cfg.use_mla or nkv % tp == 0:
        return grp, None
    hq, G, r = nh // tp, nh // nkv, coll.rank(grp)
    idx = [(r * hq + j) // G for j in range(hq)]
    uniq = sorted(set(idx))
    rep = hq // len(uniq)
    if hq % len(uniq) == 0 and idx == [h for h in uniq for _ in range(rep)]:
        return grp, uniq
    return grp, idx


def _pick(t: torch.Tensor, heads) -> torch.Tensor:
    """``t [B, S, H, D]`` at the kv heads ``heads`` (all of them for
    ``None``)."""
    return t if heads is None else t[:, :, heads]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _qkv(p: Dict, x: torch.Tensor, kv_src: Optional[torch.Tensor] = None,
         kv_group=None):
    """q from ``x``; k and v from ``kv_src`` (default ``x``). ``kv_group``:
    the group over which the (replicated) kv weights' gradients are summed
    (:func:`head_split`'s, where the kv heads do not split)."""
    src = x if kv_src is None else kv_src
    wk, wv = (coll.copy_to(p[n], kv_group) for n in ("wk", "wv"))
    q, k, v = _proj(x, p["wq"]), _proj(src, wk), _proj(src, wv)
    if "bq" in p:
        bk, bv = (coll.copy_to(p[n], kv_group) for n in ("bk", "bv"))
        q, k, v = q + p["bq"], k + bk, v + bv
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def self_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: int = 0,
                   use_rope: bool = True, return_cache: bool = False,
                   impl: str = "kernel", causal: bool = True, seq=None):
    """Training / prefill self-attention over a full sequence (``causal``
    ``False``: the enc-dec encoder's, over the whole sequence).
    ``return_cache`` additionally returns the (roped) K and V for caching.
    Under a head split the heads are this rank's (module docstring).
    ``seq``: ``x`` is this rank's rows of a sequence split over the head
    split's ranks, gathered whole on the way in and reduce-scattered back
    onto the rows on the way out (``positions`` span the whole
    sequence)."""
    grp, sel = head_split(cfg)
    x = enter(x, grp, seq)
    q, k, v = _qkv(p, x, kv_group=grp if sel is not None else None)
    shard(q, "batch", None, "heads", full=(None, None, cfg.padded_heads(
        axis_size("heads")), None))
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, _pick(k, sel), _pick(v, sel), causal=causal,
                            window=window, impl=impl)
    y = leave(_out_proj(out, p["wo"]), grp, seq)
    if return_cache:
        return y, (k, v)
    return y


def cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor, return_cache: bool = False,
                    impl: str = "kernel", seq=None):
    """Queries from ``x [B, S, d]``, keys and values from ``memory [B, F,
    d]``: no rope, non-causal over the whole memory (on the card the flash
    kernel's case). ``return_cache`` additionally returns the memory's K
    and V, which decode reads from the cache. Under a head split the heads
    are this rank's, as in :func:`self_attention`; the memory is replicated
    and enters through ``copy_to`` as ``x`` does. ``seq``: ``x`` alone is
    this rank's rows of a sequence split, as in :func:`self_attention`;
    the memory is whole."""
    grp, sel = head_split(cfg)
    x, memory = enter(x, grp, seq), coll.copy_to(memory, grp)
    q, k, v = _qkv(p, x, kv_src=memory,
                   kv_group=grp if sel is not None else None)
    out = chunked_attention(q, _pick(k, sel), _pick(v, sel), causal=False,
                            impl=impl)
    y = leave(_out_proj(out, p["wo"]), grp, seq)
    if return_cache:
        return y, (k, v)
    return y


def decode_cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                           cache: Dict, impl: str = "kernel") -> torch.Tensor:
    """One-token cross-attention: q from ``x [B, 1, d]`` against the
    memory's K and V held in ``cache`` (``{"k", "v": [B, F, Hkv, hd]}``),
    never recomputed; non-causal over the whole memory (on the card the
    flash kernel at ``Sq = 1``). Under a head split the cache holds this
    rank's kv heads, or all of them where they do not split, and this
    rank's q heads pick theirs."""
    grp, sel = head_split(cfg)
    q = _proj(x, p["wq"])
    out = chunked_attention(q, _pick(cache["k"], sel), _pick(cache["v"], sel),
                            causal=False, impl=impl)
    return coll.reduce_from(_out_proj(out, p["wo"]), grp)


# --- KV caches --------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                  window: int = 0, dtype=torch.bfloat16,
                  device=None) -> Dict:
    from repro_torch import as_device
    nkv, hd = cfg.padded_kv_heads(tp), cfg.resolved_head_dim
    slots = min(window, max_len) if window else max_len
    dev = as_device(device)
    return {
        "k": torch.zeros((batch, slots, nkv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, slots, nkv, hd), dtype=dtype, device=dev),
    }


def _dense_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Single-einsum decode attention. q: [B,1,Hq,Dk]; k/v: [B,S,Hkv,D*];
    valid: scalar or per-sequence [B]."""
    B, S, Hkv, Dk = k.shape
    G = q.shape[2] // Hkv
    qg = q.reshape(B, 1, Hkv, G, Dk)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * scale
    kv_pos = torch.arange(S, dtype=torch.int32, device=k.device)
    if valid.ndim == 1:
        mask = (kv_pos[None, :] < valid[:, None])[:, None, None, None, :]
    else:
        mask = (kv_pos < valid)[None, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, 1, q.shape[2], v.shape[-1])


def _batch_scatter(cache: torch.Tensor, new: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
    """Per-sequence cache write, in place: cache [B,S,...], new [B,1,...],
    slot [B]. Returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def _owned_write(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor, lo: int) -> None:
    """Write ``new [B, 1, ...]`` at the global positions ``pos [B]`` into
    this rank's shard ``cache [B, Ms, ...]`` of positions ``[lo, lo +
    Ms)``, in place: a sequence whose position another rank owns keeps its
    rows as they are."""
    Ms = cache.shape[1]
    local = pos.long() - lo
    mine = (local >= 0) & (local < Ms)
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = local.clamp(0, Ms - 1)
    old = cache[rows, idx]
    keep = mine.reshape((-1,) + (1,) * (old.ndim - 1))
    cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype), old)


def _local_softmax_parts(s: torch.Tensor, valid: torch.Tensor):
    """``(m, p)`` of scores ``s [B, ..., Ms]`` (f32) over a shard's
    positions, of which the first ``valid [B]`` are written: the row max
    (``-inf`` where none is) and ``exp(s - m)``, 0 at every masked
    position and on a row with none."""
    Ms = s.shape[-1]
    kv_pos = torch.arange(Ms, device=s.device)
    mask = (kv_pos[None, :] < valid[:, None]).reshape(
        (s.shape[0],) + (1,) * (s.ndim - 2) + (Ms,))
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m, torch.exp(s - m_safe[..., None])


def _combine_over_seq(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                      grp, seq_group) -> torch.Tensor:
    """Flash-decoding's combine of the ranks' partials over ``seq_group``:
    ``m``, ``l`` ``[B, H]`` and ``o [B, H, D]`` over all ``H`` q heads,
    rescaled to the max over the ranks and summed; under a head split
    (``grp``) reduce-scattered onto this rank's heads. Returns the
    normalised ``[B, 1, H_local, D]`` (f32). Rank 0 always holds position
    0, so the max over the ranks is finite."""
    top = coll.all_reduce(m, seq_group, op="max")
    a = torch.exp(m - top)                 # 0 where this rank holds none
    part = torch.cat([o * a[..., None], (l * a)[..., None]], dim=-1)
    part = (coll.all_reduce(part, seq_group) if grp is None
            else coll.reduce_scatter(part, 1, seq_group))
    return (part[..., :-1] / part[..., -1:])[:, None]


def _shard_positions(cache: torch.Tensor, pos: torch.Tensor, seq_group):
    """``(lo, pos [B], valid [B])``: the first global position of this
    rank's shard, each sequence's position, and how many of the shard's
    positions each sequence has written once ``pos`` is."""
    B, Ms = cache.shape[:2]
    lo = coll.rank(seq_group) * Ms
    posb = pos.reshape(-1).expand(B) if pos.ndim == 0 else pos
    valid = (posb.long() + 1 - lo).clamp(0, Ms)
    return lo, posb, valid


def _seq_split_attend(q, k, v, ck, cv, pos, grp, seq_group, scale):
    """The GQA decode attention over a cache split over the sequence
    (module docstring): the new rows written by their owner, q ``[B, 1,
    H_local, Dk]`` gathered over the heads, this rank's partials over its
    positions with every kv head whole, combined over ``seq_group``."""
    B, Ms, Hkv, Dk = ck.shape
    lo, posb, valid = _shard_positions(ck, pos, seq_group)
    _owned_write(ck, k, posb, lo)
    _owned_write(cv, v, posb, lo)
    qa = coll.all_gather(q, 2, grp)[:, 0]               # [B, Hq, Dk]
    Hq = qa.shape[1]
    qg = qa.reshape(B, Hkv, Hq // Hkv, Dk).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, ck.float()) * scale
    m, pr = _local_softmax_parts(s, valid)
    o = torch.einsum("bhgs,bshd->bhgd", pr, cv.float())
    out = _combine_over_seq(m.reshape(B, Hq), pr.sum(-1).reshape(B, Hq),
                            o.reshape(B, Hq, -1), grp, seq_group)
    return out.to(cv.dtype)


def decode_self_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          cache: Dict, pos: torch.Tensor, window: int = 0,
                          use_rope: bool = True, impl: str = "chunked",
                          seq_group=None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. ``pos`` is the absolute position — a 0-d tensor for
    lock-step batches, or a per-sequence ``[B]`` vector (slot-pool decode:
    each sequence ropes, writes and masks at its own position). Keys are
    roped at write time; local attention uses a ring buffer of ``window``.
    The new K/V rows are written into ``cache`` in place; under a head
    split the heads are this rank's (module docstring). ``seq_group``: the
    group the cache's sequence dim is split over (``None``: whole), with
    no window."""
    per_seq = pos.ndim == 1
    grp, sel = head_split(cfg)
    q, k, v = _qkv(p, x)                      # [B, 1, H(kv), hd]
    if use_rope:
        if per_seq:
            posm = pos.to(torch.int32)[:, None]              # [B, 1]
        else:
            posm = pos.reshape(1).to(torch.int32)[None, :]   # [1, 1]
        q = apply_rope(q, posm, cfg.rope_theta)
        k = apply_rope(k, posm, cfg.rope_theta)
    if coll.size(seq_group) > 1:
        if window:
            raise ValueError("a ring cache of a window does not split "
                             "over the sequence")
        out = _seq_split_attend(q, k, v, cache["k"], cache["v"], pos, grp,
                                seq_group, cfg.resolved_head_dim ** -0.5)
        y = coll.reduce_from(_out_proj(out, p["wo"]), grp)
        return y, cache
    slots = cache["k"].shape[1]
    slot = pos % slots
    ck, cv = cache["k"], cache["v"]
    if per_seq:
        _batch_scatter(ck, k, slot)
        _batch_scatter(cv, v, slot)
    else:
        idx = slot.reshape(1).long()
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
    # Ring semantics: every written slot is within the window by
    # construction, so masking only needs "slot has been written".
    valid = torch.clamp(pos + 1, max=slots)
    scale = cfg.resolved_head_dim ** -0.5
    ka, va = _pick(ck, sel), _pick(cv, sel)
    if impl == "dense" or per_seq:
        out = _dense_decode_attend(q, ka, va, valid, scale)
    else:
        out = chunked_attention(q, ka, va, causal=False, kv_valid_len=valid,
                                softmax_scale=scale)
    y = coll.reduce_from(_out_proj(out, p["wo"]), grp)
    return y, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mla_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
               tp: int = 1) -> Dict:
    d = cfg.d_model
    nh = cfg.padded_heads(tp)
    h_ax = "heads" if tp > 1 else None
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        # query low-rank path
        "wq_a": mk(f"{prefix}.wq_a", (d, cfg.q_lora_rank), ("dmodel", None)),
        "q_norm": mk(f"{prefix}.q_norm", (cfg.q_lora_rank,), (None,),
                     init="ones"),
        "wq_b": mk(f"{prefix}.wq_b", (cfg.q_lora_rank, nh, qk),
                   (None, h_ax, None)),
        # kv latent path (+ shared rope key)
        "wkv_a": mk(f"{prefix}.wkv_a", (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                    ("dmodel", None)),
        "kv_norm": mk(f"{prefix}.kv_norm", (cfg.kv_lora_rank,), (None,),
                      init="ones"),
        "wk_b": mk(f"{prefix}.wk_b", (cfg.kv_lora_rank, nh, cfg.qk_nope_dim),
                   (None, h_ax, None)),
        "wv_b": mk(f"{prefix}.wv_b", (cfg.kv_lora_rank, nh, cfg.v_head_dim),
                   (None, h_ax, None)),
        "wo": mk(f"{prefix}.wo", (nh, cfg.v_head_dim, d),
                 (h_ax, None, "dmodel")),
    }


def _mla_q(p: Dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, grp=None):
    qa = coll.copy_to(rms_norm(x @ p["wq_a"], p["q_norm"]), grp)
    q = _proj(qa, p["wq_b"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]   # shared across heads
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def mla_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, return_cache: bool = False,
                  impl: str = "kernel", seq=None):
    """Train/prefill MLA: decompress per-head K/V from the latent. On the
    card the causal attention is the flash kernel's case at head dims
    ``(qk_nope + qk_rope, v_head_dim)``. Under a head split the heads are
    this rank's; the latent path is replicated (module docstring).
    ``seq``: ``x`` is this rank's rows of a sequence split, gathered whole
    before ``wq_a`` and ``wkv_a`` (so they and the latent norms see the
    whole sequence; its gradient, whole once the latents' ``copy_to`` has
    summed it, is cut back, ``gather_from``), and the output is
    reduce-scattered back onto the rows."""
    grp, _ = head_split(cfg)
    x = enter(x, None, seq)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, grp)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    ck, kr = coll.copy_to(c_kv, grp), coll.copy_to(k_rope, grp)
    k_nope = _proj(ck, p["wk_b"])
    v = _proj(ck, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None].expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    out = chunked_attention(q, k, v, causal=True,
                            softmax_scale=_mla_scale(cfg), impl=impl)
    y = leave(_out_proj(out, p["wo"]), grp, seq)
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict:
    from repro_torch import as_device
    dev = as_device(device)
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=dev),
    }


def _mla_seq_split(p: Dict, cfg: ModelConfig, q_nope, q_rope, c_new,
                   kr_new, ck, kr, pos, grp, seq_group) -> torch.Tensor:
    """The absorbed MLA decode over a latent cache split over the sequence
    (module docstring): the new rows written by their owner, ``q_lat`` and
    ``q_rope`` gathered over the heads, this rank's f32 partial of
    ``o_lat`` over its positions, combined over ``seq_group`` before
    ``wv_b``."""
    lo, posb, valid = _shard_positions(ck, pos, seq_group)
    _owned_write(ck, c_new, posb, lo)
    _owned_write(kr, kr_new, posb, lo)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
    ql = coll.all_gather(q_lat, 2, grp)[:, 0].float()       # [B, H, r]
    qr = coll.all_gather(q_rope, 2, grp)[:, 0].float()      # [B, H, rope]
    s = (torch.einsum("bhr,btr->bht", ql, ck.float())
         + torch.einsum("bhk,btk->bht", qr, kr.float())) * _mla_scale(cfg)
    m, pr = _local_softmax_parts(s, valid)
    o_lat = _combine_over_seq(m, pr.sum(-1),
                              torch.einsum("bht,btr->bhr", pr, ck.float()),
                              grp, seq_group).to(ck.dtype)
    return torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"])


def mla_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor, seq_group=None) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matrix MLA decode: attention runs entirely in the latent
    space — the cache stores only (c_kv, k_rope) per token. ``pos`` is a
    0-d tensor, or a per-sequence ``[B]`` vector for slot-pool decode. The
    new rows are written into ``cache`` in place. Under a head split the
    heads are this rank's and the latent cache is whole on every rank, or
    split over the sequence on ``seq_group`` (module docstring)."""
    per_seq = pos.ndim == 1
    grp, _ = head_split(cfg)
    if per_seq:
        posm = pos.to(torch.int32)[:, None]                  # [B, 1]
    else:
        posm = pos.reshape(1).to(torch.int32)[None, :]       # [1, 1]
    q_nope, q_rope = _mla_q(p, cfg, x, posm)          # [B,1,H,*]
    c_new, kr_new = _mla_latent(p, cfg, x, posm)      # [B,1,r], [B,1,rope]
    ck, kr = cache["c_kv"], cache["k_rope"]
    if coll.size(seq_group) > 1:
        out = _mla_seq_split(p, cfg, q_nope, q_rope, c_new, kr_new, ck, kr,
                             pos, grp, seq_group)
        return coll.reduce_from(_out_proj(out, p["wo"]), grp), cache
    if per_seq:
        _batch_scatter(ck, c_new, pos)
        _batch_scatter(kr, kr_new, pos)
    else:
        idx = pos.reshape(1).long()
        ck.index_copy_(1, idx, c_new.to(ck.dtype))
        kr.index_copy_(1, idx, kr_new.to(kr.dtype))
    # absorb W_uk into q: q_tilde = q_nope @ W_uk^T  -> latent space
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
    valid = pos + 1
    kv_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
    s = (torch.einsum("bshr,btr->bhst", q_lat, ck.to(q_lat.dtype))
         + torch.einsum("bshk,btk->bhst", q_rope, kr.to(q_rope.dtype)))
    s = s.float() * _mla_scale(cfg)
    if per_seq:
        mask = (kv_pos[None, :] < valid[:, None])[:, None, None, :]
    else:
        mask = (kv_pos < valid)[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", a.to(ck.dtype), ck)
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"])
    y = coll.reduce_from(_out_proj(out, p["wo"]), grp)
    return y, {"c_kv": ck, "k_rope": kr}
