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

``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every ``x``;
``F.softplus`` returns ``x`` itself above its threshold of 20, so the port
takes :func:`repro_torch.models.common.softplus`, the reference's formula.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamMaker, conv_tail, rms_norm,
                                       softplus)

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
        "w_in": mk(f"{prefix}.w_in", (d, 2 * d_in + 2 * G * ds + nheads)),
        "conv_w": mk(f"{prefix}.conv_w", (cfg.ssm_conv_kernel, conv_dim),
                     scale=0.5),
        "conv_b": mk(f"{prefix}.conv_b", (conv_dim,), init="zeros"),
        "A_log": mk(f"{prefix}.A_log", (nheads,), init="zeros"),
        "D": mk(f"{prefix}.D", (nheads,), init="ones"),
        "dt_bias": mk(f"{prefix}.dt_bias", (nheads,), init="zeros"),
        "norm_g": mk(f"{prefix}.norm_g", (d_in,), init="ones"),
        "w_out": mk(f"{prefix}.w_out", (d_in, d)),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, nheads, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    return torch.split(zxbcdt, [d_in, d_in, G * ds, G * ds, nheads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU. x: [B, S, C], w: [K, C].
    """
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                return_state: bool = False):
    """Chunked SSD over a full sequence. u: [B, S, d_model].
    ``return_state`` additionally returns (h_final, conv_tail) for decode.

    A length that is not a multiple of :data:`CHUNK` runs as one chunk of
    length S, as in the reference."""
    Bsz, S, _ = u.shape
    d_in, H, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    dt_act = u.dtype
    conv_dim = d_in + 2 * G * ds
    zxbcdt = u @ p["w_in"]
    z, xbc_raw = zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x = xbc[..., :d_in]
    Bc = xbc[..., d_in:d_in + G * ds].reshape(Bsz, S, G, ds)
    Cc = xbc[..., d_in + G * ds:].reshape(Bsz, S, G, ds)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,S,H]
    A = -torch.exp(p["A_log"].float())                            # [H]
    xh = x.reshape(Bsz, S, H, hd)
    # broadcast groups to heads
    hpg = H // G
    Bh = Bc.repeat_interleave(hpg, dim=2)                         # [B,S,H,ds]
    Ch = Cc.repeat_interleave(hpg, dim=2)

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
    y = y.reshape(Bsz, S, d_in)
    # gated RMSNorm (mamba2 norm-before-out)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    out = y @ p["w_out"]
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
    window are written into ``cache``'s tensors in place; returns them."""
    Bsz = u.shape[0]
    d_in, H, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_dim = d_in + 2 * G * ds
    zxbcdt = (u @ p["w_in"])[:, 0]
    z, xbc = zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    # rolling conv window, the conv in f32
    win = torch.cat([cache["conv"], xbc[:, None]], dim=1)        # [B,K,C]
    conv_out = (win.float() * p["conv_w"].float()).sum(dim=1)
    xbc = F.silu(conv_out + p["conv_b"].float()).to(u.dtype)
    x = xbc[..., :d_in].reshape(Bsz, H, hd)
    Bc = xbc[..., d_in:d_in + G * ds].reshape(Bsz, G, ds)
    Cc = xbc[..., d_in + G * ds:].reshape(Bsz, G, ds)
    hpg = H // G
    Bh = Bc.repeat_interleave(hpg, dim=1)
    Ch = Cc.repeat_interleave(hpg, dim=1)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                        # [B,H]
    xf = x.float()
    h = cache["h"] * dA[..., None, None] + (
        (dt[..., None] * xf)[..., None] * Bh.float()[:, :, None, :])
    y = torch.einsum("bhpd,bhd->bhp", h, Ch.float())
    y = y + xf * p["D"][None, :, None].float()
    y = y.reshape(Bsz, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
