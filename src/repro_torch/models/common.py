"""Shared model plumbing: parameter factory, norms, rotary embeddings, gated
MLP.

The reference maps logical axes to a device mesh here (``shard``,
``ShardingRules``); the port runs on one card and has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a ``torch.dtype``."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(DTYPES)}") from None


class ParamMaker:
    """``mk(name, shape, scale, init)`` leaf constructor: every normal leaf
    is drawn in f32 from ``generator`` on ``device``, scaled, and cast to
    ``dtype`` (the reference draws the same way from its own key; the two
    generators give different numbers, so parity tests hand the reference's
    parameters over through :mod:`repro_torch.convert`)."""

    def __init__(self, generator: torch.Generator, dtype: str,
                 device: torch.device):
        self._gen = generator
        self._dtype = torch_dtype(dtype)
        self._device = device

    def __call__(self, name: str, shape: Tuple[int, ...],
                 scale: Optional[float] = None,
                 init: str = "normal") -> torch.Tensor:
        if init == "zeros":
            return torch.zeros(shape, dtype=self._dtype, device=self._device)
        if init == "ones":
            return torch.ones(shape, dtype=self._dtype, device=self._device)
        if scale is None:
            scale = shape[0] ** -0.5 if len(shape) > 1 else 0.02
        x = torch.randn(shape, generator=self._gen, device=self._device,
                        dtype=torch.float32)
        return x.mul_(scale).to(self._dtype)


# ---------------------------------------------------------------------------
# Norms / rotary / MLP
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """f32 inside, cast back to ``x``'s dtype, then ``* gamma``."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-rotation RoPE. x: [..., seq, heads, head_dim]; positions:
    [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)            # [hd/2]
    ang = positions[..., :, None].float() * freqs       # [..., s, hd/2]
    cos = torch.cos(ang)[..., :, None, :]               # [..., s, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gated_mlp_params(mk: ParamMaker, prefix: str, d: int, ff: int) -> Dict:
    return {
        "wi": mk(f"{prefix}.wi", (d, ff)),
        "wg": mk(f"{prefix}.wg", (d, ff)),
        "wo": mk(f"{prefix}.wo", (ff, d)),
    }


def gated_mlp(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = x @ p["wi"]
    g = x @ p["wg"]
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * g) @ p["wo"]
