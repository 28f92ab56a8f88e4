"""Closed-form oracles for the kernels (what ``KernelSpace.validate``
compares against). These are not the kernels' plain versions: the plain
versions in :mod:`repro_torch.kernels.vai` / ``membw`` repeat the kernels'
arithmetic step by step, the oracles state the result."""
from __future__ import annotations

from typing import Optional

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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [BH, Sq, D]; naive softmax attention, f32 math."""
    BH, Sq, D = q.shape
    _, Skv, _ = k.shape
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)
