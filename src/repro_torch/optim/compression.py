"""Gradient compression for the data-parallel reduction.

Int8 per-tensor absmax quantization with error feedback: the quantization
residual is carried to the next step, so the accumulated update is unbiased
(the EF-SGD / EF21 argument) while the reduction's wire traffic halves (int8
against bf16). The train step applies it to the gradients
(``OptConfig.grad_compression``); one card has no reduction to carry them
over, so here it changes the numerics only, as the reference's
single-device run does.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(g: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 (``absmax``: the whole tensor's, where ``g``
    is a shard of it). Returns (q int8, scale f32 0-d)."""
    gf = g.float()
    if absmax is None:
        absmax = torch.max(torch.abs(gf))
    scale = absmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    # the f32 quotient can land on the wrong side of a half step: take the
    # neighbouring level toward g where it dequantizes nearer to g
    alt = torch.clamp(q + torch.sign(gf - q * scale), -127, 127)
    q = torch.where((alt * scale - gf).abs() < (q * scale - gf).abs(), alt, q)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Any) -> Any:
    """Zero f32 residuals shaped as ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Any, error: Any, absmax: Any = None
                   ) -> Tuple[Any, Any]:
    """Error-feedback compression: g_eff = Q(g + e); e' = (g + e) - g_eff.
    ``absmax``: a tree of each leaf's ``max |g + e|`` over the whole tensor,
    where the leaves are shards of it (tensor parallelism). Returns
    (compressed-and-dequantized grads, new error state)."""
    def one(g, e, m=None):
        acc = g.float() + e
        q, scale = quantize_int8(acc, m)
        deq = dequantize(q, scale)
        return deq.to(g.dtype), acc - deq

    out = (tree_map(one, grads, error) if absmax is None
           else tree_map(one, grads, error, absmax))
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def wire_bytes_saved(params: Any, dp_degree: int = 2) -> int:
    """Bytes a data-parallel reduction saves a step, int8 against bf16."""
    n = sum(p.numel() for p in tree_leaves(params))
    return n * (2 - 1) * max(dp_degree - 1, 1)
