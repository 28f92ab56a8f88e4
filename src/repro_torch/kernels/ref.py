"""Closed-form oracles for the kernels (what ``KernelSpace.validate``
compares against). These are not the kernels' plain versions: the plain
versions in :mod:`repro_torch.kernels.vai` / ``membw`` repeat the kernels'
arithmetic step by step, the oracles state the result."""
from __future__ import annotations

import torch


def vai_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            loopsize: int) -> torch.Tensor:
    """z <- a*b + z repeated ``loopsize`` times == c + loopsize * a*b;
    loopsize 0 is the stream copy c <- b."""
    if loopsize == 0:
        return b
    return c + float(loopsize) * (a * b)


def membw_ref(x: torch.Tensor, n_chunks: int, n_iters: int) -> torch.Tensor:
    rows = x.shape[0] // n_chunks
    chunks = x.reshape(n_chunks, rows, x.shape[1]).sum(dim=1)
    idx = torch.arange(n_iters, device=x.device) % n_chunks
    return chunks[idx]
