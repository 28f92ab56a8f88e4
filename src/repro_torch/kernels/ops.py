"""Public wrappers around the CUDA kernels, and their launch counters.

PyTorch runs eagerly, so these are plain pass-throughs (the reference's
versions exist to jit their kernels); they are kept so that callers find
``ops.vai_op`` / ``ops.membw_op`` / ``ops.flash_attention_op`` where the
reference has them."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import membw as mb
from repro_torch.kernels import vai as vai_mod


def vai_op(a, b, c, *, loopsize: int, block_rows: int = 256):
    return vai_mod.vai(a, b, c, loopsize=loopsize, block_rows=block_rows)


def membw_op(x, *, n_chunks: int, n_iters: int):
    return mb.membw(x, n_chunks=n_chunks, n_iters=n_iters)


def flash_attention_op(q, k, v, *, causal: bool = True,
                       block_q: Optional[int] = None,
                       block_k: Optional[int] = None,
                       scale: Optional[float] = None):
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D/Dv] -> [B, Sq, Hq, Dv].
    GQA by indexing kv head ``h // (Hq // Hkv)``; nothing is repeated or
    transposed. Any head dims ``D, Dv >= 1`` in f32, bf16 and f16, as the
    reference's op takes any (``fa.unsupported`` states the kernels'
    rules; another dtype raises by name on the card); tiles the caller
    does not name are ``fa.default_tiles``'s.

    The kernel has no backward: inputs that require grad while autograd
    records raise, on every device (the output would carry no ``grad_fn``
    and cut the attention out of the gradient without a word;
    ``models.attention.FlashAttention`` is the differentiable route)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_op has no backward: its inputs require grad "
            "while autograd records; differentiate through "
            "repro_torch.models.attention.chunked_attention instead")
    return fa.flash_attention_bshd(q, k, v, causal=causal, scale=scale,
                                   block_q=block_q, block_k=block_k)


def launch_counts() -> Dict[str, int]:
    """How often each wrapper has launched its CUDA kernel so far."""
    return {"vai": vai_mod.LAUNCHES, "membw": mb.LAUNCHES,
            "flash_attention": fa.LAUNCHES}


def flash_launches_by_head_dims(by_shape: Optional[Dict[str, int]] = None
                                ) -> Dict[str, int]:
    """The flash kernel's launches by head dims and mask (``"128x128"``,
    ``"64x64/noncausal"``): ``by_shape`` (by default
    ``fa.LAUNCHES_BY_SHAPE``) summed over the call shapes."""
    out: Dict[str, int] = {}
    for shape, n in (fa.LAUNCHES_BY_SHAPE if by_shape is None
                     else by_shape).items():
        key = shape.split(" ")[0]
        out[key] = out.get(key, 0) + n
    return out


def reset_launch_counts() -> None:
    vai_mod.LAUNCHES = 0
    vai_mod.LAUNCHES_BY_SHAPE.clear()
    mb.LAUNCHES = 0
    fa.LAUNCHES = 0
    fa.LAUNCHES_BY_SHAPE.clear()
    fa.PADDED_COPIES = 0
