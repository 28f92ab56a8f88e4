"""PyTorch / CUDA port of the paper's benchmark -> calibrate -> project pipeline.

Same sub-packages and public names as the JAX reference package (``core``,
``power``, ``kernels``, ``tuning``, ``configs``), written as plain functions
on ``torch`` tensors for one NVIDIA H100. This package imports ``torch`` and
``numpy`` only, and nothing of the reference package.

Device rule, the same everywhere: an entry point that *creates* data takes
``device=`` and defaults to :data:`DEFAULT_DEVICE` (the card); an entry
point that is *handed* tensors works where they already lie when ``device``
is ``None``. Nothing falls back to the CPU on its own — the CPU is used
only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "as_device", "f64"]

#: where entry points put the data they create unless told otherwise
DEFAULT_DEVICE = "cuda"

DeviceLike = Union[None, str, torch.device]


def as_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :data:`DEFAULT_DEVICE`; strings -> ``torch.device``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


def f64(x: Any, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as a float64 tensor. A tensor stays on its own device unless
    ``device`` names another; python numbers, sequences and numpy arrays go
    to ``device`` (default :data:`DEFAULT_DEVICE`)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64,
                    device=x.device if device is None else device)
    return torch.as_tensor(x, dtype=torch.float64, device=as_device(device))


def device_of(*xs: Any) -> Optional[torch.device]:
    """Device of the first tensor among ``xs`` (``None`` if there is none)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None
