"""Shared model plumbing: parameter factory, norms, rotary embeddings,
softplus, gated MLP.

The reference maps logical axes to a device mesh here (``shard``,
``ShardingRules``); the port runs on one card and has no counterpart.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the most elements a normal leaf draws in one f32 temporary (1 GiB)
SLAB_ELEMS = 2 ** 28


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
    parameters over through :mod:`repro_torch.convert`). A leaf is drawn in
    slabs of at most :data:`SLAB_ELEMS` elements along its first axis, so
    that the f32 temporary stays one slab (a full-width expert tensor would
    need 15 GB of it); a leaf that fits is one draw."""

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
        out = torch.empty(shape, dtype=self._dtype, device=self._device)
        step = max(1, SLAB_ELEMS // max(1, math.prod(shape[1:])))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            slab = torch.randn((rows,) + tuple(shape[1:]), generator=self._gen,
                               device=self._device, dtype=torch.float32)
            out[i:i + rows] = slab.mul_(scale)
        return out


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``, at every ``x`` (``F.softplus`` returns ``x``
    itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k - 1`` rows of ``x_raw [B, S, C]`` along the sequence,
    left-padded with zeros when ``S < k - 1``: the rolling window a
    recurrent block's causal conv of width ``k`` decodes from after a
    prefill."""
    S = x_raw.shape[1]
    if S >= k - 1:
        return x_raw[:, S - (k - 1):]
    return F.pad(x_raw, (0, 0, k - 1 - S, 0))


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
