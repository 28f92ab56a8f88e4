"""Memory-subsystem bandwidth probe (paper §III-B-b, GPU-benches L2 kernel).

The paper's kernel loads the same memory chunk from many blocks to measure
L2-vs-HBM bandwidth as a function of the chunk size. Here iteration ``i``
re-reads chunk ``i % n_chunks`` of the input and reduces it to one 128-wide
row, so a small working set stays resident in the card's L2 while a large
one streams from HBM every time (bandwidth-bound by construction).

:func:`membw` is the wrapper: a CUDA tensor goes to the hand-written kernel
in ``csrc/membw.cu`` (or the call raises), a CPU tensor to
:func:`membw_plain`.
"""
from __future__ import annotations

import operator

import torch

LANE = 128
#: thread blocks the wrapper aims to launch for a small problem, so that every
#: SM of the card has several blocks in flight (132 SMs x 16)
TARGET_BLOCKS = 2112
#: fewest rows a block reduces (below this the launch overhead dominates)
MIN_SLICE_ROWS = 64
#: most rows a block reduces. Blocks are numbered iteration by iteration and
#: the card starts them in that order, so with slices this short one
#: iteration of a large chunk is many more blocks than fit on the card at
#: once, and the iterations follow each other as the probe means them to:
#: a chunk larger than the L2 has left it before its next read. (With a few
#: long slices all iterations run side by side, read the same rows at the
#: same time, share them in the L2, and the probe reports more than the HBM
#: can deliver.)
MAX_SLICE_ROWS = 256
_ROW_LANES = 8

#: kernel launches made by :func:`membw` (one per call that reaches the card)
LAUNCHES = 0


def _check_args(x, n_chunks, n_iters):
    if x.ndim != 2 or x.shape[1] != LANE:
        raise ValueError(f"x must be [rows, {LANE}]; got {tuple(x.shape)}")
    try:
        n_chunks = operator.index(n_chunks)
        n_iters = operator.index(n_iters)
    except TypeError:
        raise ValueError(
            f"n_chunks and n_iters must be ints, got n_chunks={n_chunks!r}, "
            f"n_iters={n_iters!r}") from None
    if n_chunks <= 0 or n_iters <= 0:
        raise ValueError(
            f"n_chunks and n_iters must be positive, got "
            f"n_chunks={n_chunks}, n_iters={n_iters}")
    rows = x.shape[0]
    if rows == 0 or rows % n_chunks:
        raise ValueError(
            f"n_chunks={n_chunks} does not divide the {rows}-row input: "
            f"rows % n_chunks == {rows % n_chunks if rows else 0}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return n_chunks, n_iters


def slicing(chunk_rows: int, n_iters: int):
    """``(rows_per_slice, n_slices)``: how the kernel cuts a chunk's rows
    over thread blocks. A function of the shapes alone, so the order of the
    sums — and with it every bit of the result — is the same in every run."""
    want = max(1, -(-TARGET_BLOCKS // n_iters))
    rows_per_slice = min(MAX_SLICE_ROWS,
                         max(MIN_SLICE_ROWS, -(-chunk_rows // want)))
    rows_per_slice = -(-rows_per_slice // _ROW_LANES) * _ROW_LANES
    return rows_per_slice, -(-chunk_rows // rows_per_slice)


def membw_plain(x: torch.Tensor, *, n_chunks: int,
                n_iters: int) -> torch.Tensor:
    """The same function in plain PyTorch: the chunks' column sums,
    gathered so that row ``i`` is chunk ``i % n_chunks``."""
    chunk_rows = x.shape[0] // n_chunks
    sums = x.view(n_chunks, chunk_rows, LANE).sum(1)
    return sums[torch.arange(n_iters, device=x.device) % n_chunks]


def _launch(x, n_chunks: int, n_iters: int) -> torch.Tensor:
    """Launch the CUDA kernels on PyTorch's current stream (no
    synchronise). Output and scratch are allocated here."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(
            f"the membw kernel takes CUDA tensors (or CPU tensors for the "
            f"plain version); got device {x.device}")
    from repro_torch.kernels import build
    lib = build.load_library()
    chunk_rows = x.shape[0] // n_chunks
    rows_per_slice, n_slices = slicing(chunk_rows, n_iters)
    partial = torch.empty((n_iters, n_slices, LANE), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((n_iters, LANE), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_membw_f32(x.data_ptr(), partial.data_ptr(),
                                   out.data_ptr(), chunk_rows, n_chunks,
                                   n_iters, rows_per_slice, n_slices, stream)
    build.check_launch(code, f"membw(n_chunks={n_chunks}, "
                             f"n_iters={n_iters})")
    LAUNCHES += 1
    return out


def membw(x: torch.Tensor, *, n_chunks: int, n_iters: int) -> torch.Tensor:
    """x: [n_chunks * chunk_rows, 128] f32. Returns per-iteration chunk sums
    [n_iters, 128]; iteration i reads chunk (i % n_chunks). ``n_chunks``
    must divide the row count (``ValueError`` otherwise). CPU tensors take
    :func:`membw_plain`; any other tensor goes to the CUDA kernel, and a
    failed build or launch raises."""
    n_chunks, n_iters = _check_args(x, n_chunks, n_iters)
    if x.device.type == "cpu":
        return membw_plain(x, n_chunks=n_chunks, n_iters=n_iters)
    return _launch(x, n_chunks, n_iters)


def membw_bytes(chunk_bytes: int, n_iters: int) -> int:
    return chunk_bytes * n_iters
