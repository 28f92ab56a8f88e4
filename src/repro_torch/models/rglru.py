"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

Recurrence:  a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with i_t = sigmoid(W_i x_t) the input gate. Over a sequence the recurrence
is a log-depth scan (the reference's ``jax.lax.associative_scan``, here a
Hillis–Steele doubling scan: ceil(log2 S) elementwise steps on ``[B, S,
w]`` in f32, so a prefill launches a few dozen kernels a layer and not S
steps' worth); decode is a single-step recurrence on a ``[B, lru_width]``
state, written into the cache in place. The full residual block is:
proj-in (2 branches) -> causal conv(4) -> RG-LRU -> gelu-gated merge ->
proj-out. The scan sums in another order than the reference's, so the two
differ in rounding only.

Under a mesh that splits ``"lru"`` over two or more ranks each rank holds
its own channels of ``w_x``, ``w_gate``, the conv, the rows of ``w_a``,
``w_i`` and ``w_out`` and of the decode state: the input enters through
``copy_to``, the gate products (row-split weights times this rank's
channels) are partial sums over the whole width, summed and cut to this
rank's channels by one reduce-scatter each
(:func:`~repro_torch.parallel.collectives.reduce_scatter_from`), the
replicated ``b_a``, ``b_i`` and ``lam`` enter through ``copy_to`` and are
cut, the gates and the scan are elementwise per channel, and the output's
partial sums are all-reduced. A layer pays two reduce-scatters of ``[tokens,
lru_width]`` in f32 and an all-reduce of ``[tokens, d_model]`` forward.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamMaker, axis_group, conv_tail,
                                       enter, leave, softplus)
from repro_torch.parallel import collectives as coll

RG_C = 8.0
CONV_K = 4


def rglru_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
                 tp: int = 1) -> Dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_x": mk(f"{prefix}.w_x", (d, w), ("dmodel", "lru")),
        "w_gate": mk(f"{prefix}.w_gate", (d, w), ("dmodel", "lru")),
        "conv_w": mk(f"{prefix}.conv_w", (CONV_K, w), (None, "lru"), scale=0.5),
        "conv_b": mk(f"{prefix}.conv_b", (w,), ("lru",), init="zeros"),
        "w_a": mk(f"{prefix}.w_a", (w, w), ("lru", None), scale=0.02),
        "b_a": mk(f"{prefix}.b_a", (w,), (None,), init="zeros"),
        "w_i": mk(f"{prefix}.w_i", (w, w), ("lru", None), scale=0.02),
        "b_i": mk(f"{prefix}.b_i", (w,), (None,), init="zeros"),
        "lam": mk(f"{prefix}.lam", (w,), (None,), init="ones"),
        "w_out": mk(f"{prefix}.w_out", (w, d), ("lru", "dmodel")),
    }


def _mine(t: torch.Tensor, grp) -> torch.Tensor:
    """This rank's channels of a replicated per-channel leaf under a split
    over ``grp`` (its gradient summed over ``grp``); ``t`` itself
    without one."""
    return t if grp is None else coll.chunk(coll.copy_to(t, grp), -1, grp)


def _gates(p: Dict, x: torch.Tensor, grp=None):
    """a_t and the gated input. x: [..., w] (f32; under a split over
    ``grp``, this rank's channels)."""
    ra = torch.sigmoid(coll.reduce_scatter_from(x @ p["w_a"].float(), -1, grp)
                       + _mine(p["b_a"], grp).float())
    log_a = -RG_C * softplus(_mine(p["lam"], grp).float()) * ra
    i = torch.sigmoid(coll.reduce_scatter_from(x @ p["w_i"].float(), -1, grp)
                      + _mine(p["b_i"], grp).float())
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    return a, gated


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, no activation. x: [B, S, w]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along axis 1: the doubling
    scan of the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, b1 a2 +
    b2), ceil(log2 S) steps."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                  return_state: bool = False, seq=None):
    """Full-sequence RG-LRU block through the doubling scan. u: [B, S, d].
    ``return_state`` additionally returns (h_final, conv_tail) for decode
    (under a split: this rank's channels). ``seq``: ``u`` is this rank's
    rows of a sequence split over the ``lru`` ranks, gathered whole on the
    way in; the output is reduce-scattered back onto the rows.
    """
    grp = axis_group("lru")
    u = enter(u, grp, seq)
    x_raw = u @ p["w_x"]
    gate = u @ p["w_gate"]
    x = _causal_conv(x_raw, p["conv_w"], p["conv_b"])
    a, gated = _gates(p, x.float(), grp)
    h = _linear_scan(a, gated)
    y = h.to(u.dtype) * F.gelu(gate, approximate="tanh")
    out = leave(y @ p["w_out"], grp, seq)
    if return_state:
        return out, (h[:, -1], conv_tail(x_raw, CONV_K))
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    from repro_torch import as_device
    w = cfg.lru_width or cfg.d_model
    dev = as_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, CONV_K - 1, w), dtype=dtype, device=dev),
    }


def rglru_decode_step(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                      cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """u: [B, 1, d] single-token step. The new ``h`` and conv window are
    written into ``cache``'s tensors in place; returns them. Under a split
    ``cache`` holds this rank's channels."""
    grp = axis_group("lru")
    u = coll.copy_to(u, grp)
    x = (u @ p["w_x"])[:, 0]
    gate = (u @ p["w_gate"])[:, 0]
    win = torch.cat([cache["conv"], x[:, None]], dim=1)           # [B,K,w]
    x = ((win.float() * p["conv_w"].float()).sum(dim=1)
         + p["conv_b"].float())
    a, gated = _gates(p, x, grp)
    h = cache["h"] * a + gated
    y = h.to(u.dtype) * F.gelu(gate, approximate="tanh")
    out = coll.reduce_from(y @ p["w_out"], grp)[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
