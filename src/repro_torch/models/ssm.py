"""Mamba2 — SSD (state-space duality) block, chunked-scan form for a whole
sequence and O(1)-state decode form (arXiv:2405.21060).

Over a sequence the SSD block decomposition runs: within a chunk of
:data:`CHUNK` positions the output is a masked quadratic form (batched
einsums over the chunk axis, where the reference vmaps over it); across
chunks a loop over the chunks carries each chunk's final state into the
next and hands every chunk the state it starts from (the reference's
``lax.scan``). Decode keeps a per-layer state ``h [B, n_heads, head_dim,
d_state]`` in f32 and a rolling window of the last ``ssm_conv_kernel - 1``
pre-conv inputs, and :func:`ssd_decode_step` writes both into the cache it
is given, in place.

Under a mesh that splits ``"lru"`` / ``"heads"`` over two or more ranks
each rank holds the shards ``ssm_params`` gives it: contiguous runs of the
fused ``w_in``'s columns and of the conv channels ``[x | B | C]``, and its
own heads' ``A_log``, ``D``, ``dt_bias``, ``norm_g`` and rows of ``w_out``.
The runs do not line up with the heads, so the projection is gathered whole
(:func:`~repro_torch.parallel.collectives.gather_to`: each rank reads other
columns of it, so its gradient is summed and cut), the conv runs on this
rank's own channels (and its own shard of the decode state's window), its
output is gathered whole again, and each rank takes its heads' ``x``, ``z``
and ``dt`` and all of ``B`` / ``C``. The scan runs on this rank's heads; the
gated RMSNorm's sum of squares is summed over the ranks, since it spans the
whole ``d_in``; the output's partial sums are all-reduced. A layer pays two
all-gathers (``[tokens, 2 d_in + 2 G d_state + H]`` and ``[tokens,
d_in + 2 G d_state]``), an all-reduce of ``[tokens, 1]`` in f32 and one of
``[tokens, d_model]`` forward, and the reduce-scatters of the two gathers'
gradients and the all-reduces of the norm's and the input's gradients
backward.

``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every ``x``;
``F.softplus`` returns ``x`` itself above its threshold of 20, so the port
takes :func:`repro_torch.models.common.softplus`, the reference's formula.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamMaker, axis_group, conv_tail,
                                       enter, leave, rms_norm, softplus)
from repro_torch.parallel import collectives as coll

CHUNK = 128


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
               tp: int = 1) -> Dict:
    d = cfg.d_model
    d_in, nheads, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_dim = d_in + 2 * G * ds
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": mk(f"{prefix}.w_in", (d, 2 * d_in + 2 * G * ds + nheads),
                   ("dmodel", "lru")),
        "conv_w": mk(f"{prefix}.conv_w", (cfg.ssm_conv_kernel, conv_dim),
                     (None, "lru"), scale=0.5),
        "conv_b": mk(f"{prefix}.conv_b", (conv_dim,), ("lru",), init="zeros"),
        "A_log": mk(f"{prefix}.A_log", (nheads,), ("lru",), init="zeros"),
        "D": mk(f"{prefix}.D", (nheads,), ("lru",), init="ones"),
        "dt_bias": mk(f"{prefix}.dt_bias", (nheads,), ("lru",), init="zeros"),
        "norm_g": mk(f"{prefix}.norm_g", (d_in,), ("lru",), init="ones"),
        "w_out": mk(f"{prefix}.w_out", (d_in, d), ("lru", "dmodel")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, nheads, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    return torch.split(zxbcdt, [d_in, d_in, G * ds, G * ds, nheads], dim=-1)


def _split_sizes(cfg: ModelConfig, grp) -> Tuple[int, int, int, int]:
    """``(rank, heads, d_in, conv channels)`` of this rank under a split of
    ``"lru"`` over ``grp`` (the whole at ``grp`` ``None``)."""
    d_in, H, _, ds = ssm_dims(cfg)
    conv_dim = d_in + 2 * cfg.ssm_n_groups * ds
    tp = coll.size(grp)
    if H % tp or conv_dim % tp:
        raise ValueError(f"{H} SSD heads and {conv_dim} conv channels do not "
                         f"split over {tp} ranks")
    return coll.rank(grp), H // tp, d_in // tp, conv_dim // tp


def _in_proj(p: Dict, cfg: ModelConfig, u: torch.Tensor, grp):
    """``(z, conv input, dt)`` of ``u @ w_in`` (gathered whole over
    ``grp``): this rank's heads' ``z`` and ``dt``, and its own conv
    channels."""
    d_in, _, _, _ = ssm_dims(cfg)
    r, hl, dl, cl = _split_sizes(cfg, grp)
    conv_dim = cl * coll.size(grp)
    zxbcdt = coll.gather_to(u @ p["w_in"], -1, grp)
    dt0 = d_in + conv_dim + r * hl
    return (zxbcdt[..., r * dl:(r + 1) * dl],
            zxbcdt[..., d_in + r * cl:d_in + (r + 1) * cl],
            zxbcdt[..., dt0:dt0 + hl])


def _conv_heads(cfg: ModelConfig, xbc: torch.Tensor, grp):
    """``(x, B, C)`` of this rank's heads from its conv output (gathered
    whole over ``grp``): ``x [..., heads * head_dim]``, ``B`` and ``C``
    ``[..., heads, d_state]``, each head reading its group's."""
    d_in, H, _, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    r, hl, dl, _ = _split_sizes(cfg, grp)
    xbc = coll.gather_to(xbc, -1, grp)
    lead = xbc.shape[:-1]
    heads = slice(r * hl, (r + 1) * hl)
    Bc = xbc[..., d_in:d_in + G * ds].reshape(*lead, G, ds)
    Cc = xbc[..., d_in + G * ds:].reshape(*lead, G, ds)
    Bh = Bc.repeat_interleave(H // G, dim=-2)[..., heads, :]
    Ch = Cc.repeat_interleave(H // G, dim=-2)[..., heads, :]
    return xbc[..., r * dl:(r + 1) * dl], Bh, Ch


def _gated_norm(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                cfg: ModelConfig, grp) -> torch.Tensor:
    """Mamba2's gated RMSNorm of ``y * silu(z)`` over the whole ``d_in``:
    under a split the sum of squares is summed over ``grp`` (its gradient
    too) and divided by the whole width."""
    v = y * F.silu(z)
    if grp is None:
        return rms_norm(v, g, cfg.norm_eps)
    vf = v.float()
    ss = coll.reduce_both((vf * vf).sum(dim=-1, keepdim=True), grp)
    var = ss / (vf.shape[-1] * coll.size(grp))
    return (vf * torch.rsqrt(var + cfg.norm_eps)).to(v.dtype) * g


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU. x: [B, S, C], w: [K, C].
    """
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                return_state: bool = False, seq=None):
    """Chunked SSD over a full sequence. u: [B, S, d_model].
    ``return_state`` additionally returns (h_final, conv_tail) for decode
    (under a split: this rank's heads and conv channels). ``seq``: ``u``
    is this rank's rows of a sequence split over the ``lru`` ranks,
    gathered whole on the way in; the output is reduce-scattered back onto
    the rows.

    A length that is not a multiple of :data:`CHUNK` runs as one chunk of
    length S, as in the reference."""
    _, _, hd, ds = ssm_dims(cfg)
    dt_act = u.dtype
    grp = axis_group("lru")
    H = _split_sizes(cfg, grp)[1]
    u = enter(u, grp, seq)
    Bsz, S, _ = u.shape
    z, xbc_raw, dt = _in_proj(p, cfg, u, grp)
    x, Bh, Ch = _conv_heads(
        cfg, _causal_conv(xbc_raw, p["conv_w"], p["conv_b"]), grp)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,S,H]
    A = -torch.exp(p["A_log"].float())                            # [H]
    xh = x.reshape(Bsz, S, H, hd)

    N = S // CHUNK if S % CHUNK == 0 else 1
    L = S // N
    dA = (dt * A).reshape(Bsz, N, L, H)                           # log decay
    xc = xh.reshape(Bsz, N, L, H, hd)
    Bb = Bh.reshape(Bsz, N, L, H, ds)
    Cb = Ch.reshape(Bsz, N, L, H, ds)
    dtc = dt.reshape(Bsz, N, L, H)
    seg = torch.cumsum(dA, dim=2)                                 # [B,N,L,H]

    # ---- intra-chunk (quadratic, attention-like), every chunk at once ----
    # M[i,j] = exp(seg_i - seg_j) * (C_i . B_j) * dt_j  for j <= i
    gram = torch.einsum("bnlhd,bnmhd->bnhlm", Cb.float(), Bb.float())
    decay = (seg[:, :, :, None, :] - seg[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)                                            # [B,N,H,L,M]
    mask = torch.ones((L, L), dtype=torch.bool, device=u.device).tril()
    # masked before the exp: above the diagonal the decay is positive and
    # its exp may overflow, and where(mask, inf, 0) has a NaN gradient
    # (0 * inf); the forward's values are the same either way
    m = torch.exp(torch.where(mask, decay, -torch.inf)) * gram
    m = m * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    intra_y = torch.einsum("bnhlm,bnmhd->bnlhd", m.to(dt_act), xc)

    # ---- per-chunk final states ----
    # state_n = sum_j exp(seg_L - seg_j) * dt_j * B_j x_j^T
    w = (torch.exp(seg[:, :, -1:, :] - seg) * dtc).to(dt_act)     # [B,N,L,H]
    states = torch.einsum("bnlhd,bnlhp->bnhpd", w[..., None] * Bb, xc)
    chunk_decay = torch.exp(seg[:, :, -1])                        # [B,N,H]

    # ---- inter-chunk recurrence over N chunks: the carry-in states ----
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for n in range(N):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None].to(h.dtype) + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                   # [B,N,H,hd,ds]

    # ---- contribution of the carried state to each position ----
    inter_w = torch.exp(seg).to(dt_act)                           # [B,N,L,H]
    inter_y = torch.einsum("bnlhd,bnhpd->bnlhp", inter_w[..., None] * Cb,
                           h_prev)
    y = (intra_y + inter_y).reshape(Bsz, S, H, hd)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(Bsz, S, H * hd)
    # gated RMSNorm (mamba2 norm-before-out)
    y = _gated_norm(y, z, p["norm_g"], cfg, grp)
    out = leave(y @ p["w_out"], grp, seq)
    if return_state:
        return out, (h.float(), conv_tail(xbc_raw, cfg.ssm_conv_kernel))
    return out


# ---------------------------------------------------------------------------
# Decode: O(1) per token
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict:
    from repro_torch import as_device
    d_in, H, hd, ds = ssm_dims(cfg)
    conv_dim = d_in + 2 * cfg.ssm_n_groups * ds
    dev = as_device(device)
    return {
        "h": torch.zeros((batch, H, hd, ds), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv_kernel - 1, conv_dim),
                            dtype=dtype, device=dev),
    }


def ssd_decode_step(p: Dict, cfg: ModelConfig, u: torch.Tensor, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
    """u: [B, 1, d_model] -> y: [B, 1, d_model]. The new ``h`` and conv
    window are written into ``cache``'s tensors in place; returns them.
    Under a split ``cache`` holds this rank's heads and conv channels."""
    Bsz = u.shape[0]
    _, _, hd, ds = ssm_dims(cfg)
    grp = axis_group("lru")
    H = _split_sizes(cfg, grp)[1]
    u = coll.copy_to(u, grp)
    z, xbc, dt = (t[:, 0] for t in _in_proj(p, cfg, u, grp))
    # rolling conv window, the conv in f32
    win = torch.cat([cache["conv"], xbc[:, None]], dim=1)        # [B,K,C]
    conv_out = (win.float() * p["conv_w"].float()).sum(dim=1)
    xbc = F.silu(conv_out + p["conv_b"].float()).to(u.dtype)
    x, Bh, Ch = _conv_heads(cfg, xbc, grp)
    x = x.reshape(Bsz, H, hd)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                        # [B,H]
    xf = x.float()
    h = cache["h"] * dA[..., None, None] + (
        (dt[..., None] * xf)[..., None] * Bh.float()[:, :, None, :])
    y = torch.einsum("bhpd,bhd->bhp", h, Ch.float())
    y = y + xf * p["D"][None, :, None].float()
    y = y.reshape(Bsz, H * hd).to(u.dtype)
    y = _gated_norm(y, z, p["norm_g"], cfg, grp)
    out = coll.reduce_from(y @ p["w_out"], grp)[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
