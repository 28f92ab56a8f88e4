"""VAI — Variable Arithmetic Intensity kernel (paper Algorithm 1).

The paper's OpenMP/HIP kernel walks the roofline by tuning ``LOOPSIZE``:
3 reads + 1 write per element with ``2*LOOPSIZE`` FMA flops, so arithmetic
intensity is exactly ``2*LOOPSIZE / 16`` flops/byte in f32 (AI=0 degenerates
to the stream copy c = b, as in the paper).

:func:`vai` is the wrapper: a CUDA tensor goes to the hand-written kernel in
``csrc/vai.cu`` (or the call raises), a CPU tensor to :func:`vai_plain`, the
same arithmetic step by step in plain PyTorch. Used by
:mod:`repro_torch.core.vai` to trace the power/performance roofline under
frequency and power caps.
"""
from __future__ import annotations

import collections
import operator

import torch

LANE = 128
DEFAULT_BLOCK_ROWS = 256

#: kernel launches made by :func:`vai` (only where it launches, nowhere else)
LAUNCHES = 0
#: the same launches by ``(loopsize, block_rows)``
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()


def _check_args(a, b, c, loopsize, block_rows):
    if not (a.shape == b.shape == c.shape and a.ndim == 2
            and a.shape[1] == LANE):
        raise ValueError(
            f"a, b, c must share one [rows, {LANE}] shape; got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    try:
        loopsize = operator.index(loopsize)
        block_rows = operator.index(block_rows)
    except TypeError:
        raise ValueError(
            f"loopsize and block_rows must be ints, got "
            f"loopsize={loopsize!r}, block_rows={block_rows!r}") from None
    if loopsize < 0:
        raise ValueError(
            f"loopsize must be non-negative (0 = stream copy), "
            f"got {loopsize}")
    if block_rows <= 0:
        raise ValueError(
            f"block_rows must be positive, got {block_rows}")
    rows = a.shape[0]
    br = min(block_rows, rows)
    if rows % br:
        raise ValueError(
            f"block_rows={block_rows} does not tile the {rows}-row input: "
            f"rows % {br} == {rows % br} (pick a divisor of {rows})")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(
                f"a, b, c must lie on one device; {name} is on {t.device}, "
                f"a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return loopsize, br


def vai_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
              loopsize: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``loopsize`` steps of
    ``z = a*b + z`` from ``z = c``; ``loopsize == 0`` copies ``b``."""
    if loopsize == 0:
        return b.clone()
    z = c
    for _ in range(loopsize):
        z = torch.addcmul(z, a, b)
    return z


def _launch(a, b, c, loopsize: int, block_rows: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise)."""
    global LAUNCHES
    if not a.is_cuda:
        raise ValueError(
            f"the vai kernel takes CUDA tensors (or CPU tensors for the "
            f"plain version); got device {a.device}")
    from repro_torch.kernels import build
    lib = build.load_library()
    out = torch.empty_like(c)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_vai_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 out.data_ptr(), a.shape[0], block_rows,
                                 loopsize, stream)
    build.check_launch(code, f"vai(loopsize={loopsize}, "
                             f"block_rows={block_rows})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(loopsize, block_rows)] += 1
    from repro_torch.core import hlo_cost
    hlo_cost.charge_kernel("vai", lambda: vai_flops_bytes(a.numel(),
                                                          loopsize))
    return out


def vai(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, loopsize: int,
        block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """a, b, c: [rows, 128] f32 on one device; returns the updated c.

    ``loopsize`` must be a non-negative int (0 = the stream-copy c <- b);
    ``block_rows`` (the rows one thread block owns) must be positive and,
    after clamping to ``rows``, divide the row count — all rejected with a
    ``ValueError``. CPU tensors take :func:`vai_plain`; any other tensor
    goes to the CUDA kernel, and a failed build or launch raises."""
    loopsize, br = _check_args(a, b, c, loopsize, block_rows)
    if a.device.type == "cpu":
        return vai_plain(a, b, c, loopsize=loopsize)
    return _launch(a, b, c, loopsize, br)


def vai_flops_bytes(n_elems: int, loopsize: int, itemsize: int = 4):
    """(flops, bytes) of one VAI pass — the roofline coordinates."""
    if loopsize == 0:
        return 0, 2 * n_elems * itemsize          # read b + write c
    return 2 * loopsize * n_elems, 4 * n_elems * itemsize
