"""Public wrappers around the CUDA kernels, and their launch counters.

PyTorch runs eagerly, so these are plain pass-throughs (the reference's
versions exist to jit their kernels); they are kept so that callers find
``ops.vai_op`` / ``ops.membw_op`` where the reference has them."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import membw as mb
from repro_torch.kernels import vai as vai_mod


def vai_op(a, b, c, *, loopsize: int, block_rows: int = 256):
    return vai_mod.vai(a, b, c, loopsize=loopsize, block_rows=block_rows)


def membw_op(x, *, n_chunks: int, n_iters: int):
    return mb.membw(x, n_chunks=n_chunks, n_iters=n_iters)


def launch_counts() -> Dict[str, int]:
    """How often each wrapper has launched its CUDA kernel so far."""
    return {"vai": vai_mod.LAUNCHES, "membw": mb.LAUNCHES}


def reset_launch_counts() -> None:
    vai_mod.LAUNCHES = 0
    mb.LAUNCHES = 0
