"""Collectives over one process group of a mesh: plain ones, and the
autograd-aware pairs that explicit tensor, sequence and expert parallelism
place around the model's blocks (the reference's XLA places them itself).

Every function takes ``group``, a ``torch.distributed`` process group (a
mesh axis's, :meth:`repro_torch.launch.mesh.Mesh.group`), or ``None``. On
``None`` and on a group of one rank each is the identity and calls nothing
(as Megatron's mappings skip a world of one): at world 1 the NCCL calls
cost host time on a host-bound path and compute nothing (PERF.md §6).

The autograd-aware ones are ``torch.autograd.Function`` s around the plain
``torch.distributed`` calls, which torch 2.11 and 2.13 both have (the
module ``torch.distributed.nn.functional`` is deprecated in 2.13):

============================  ==========================  ===================
function                      forward                     backward
============================  ==========================  ===================
:func:`copy_to`               identity                    all-reduce sum
:func:`reduce_from`           all-reduce sum              identity
:func:`reduce_both`           all-reduce sum              all-reduce sum
:func:`split_to`              this rank's chunk of a dim  all-gather that dim
:func:`gather_from`           all-gather a dim            this rank's chunk
:func:`gather_to`             all-gather a dim            reduce-scatter it
:func:`reduce_scatter_from`   reduce-scatter a dim        all-gather that dim
:func:`all_to_all`            all-to-all of dim 0 chunks  all-to-all
============================  ==========================  ===================

:func:`copy_to` / :func:`reduce_from` are Megatron's f / g: a replicated
activation entering a block whose ranks hold different heads or ffn columns
(its gradient arrives partial on each rank), and the block's partial output
summed back (its gradient is already whole). :func:`reduce_both` sums a
value over the data axes whose gradient the train step averages over the
same axes (a loss's numerator and count, the router's load statistics), so
each rank's share of the gradient comes out whole after the average.

:func:`gather_to` in place of :func:`gather_from`: a tensor whose ranks each
read a different part of the gathered whole (the SSD's fused projection, a
rank's own heads and all of ``B`` / ``C``), so each rank's gradient of the
whole is partial and must be summed before it is cut.
:func:`reduce_scatter_from` in place of :func:`reduce_from` then
:func:`split_to`: a partial product of which each rank needs only its own
chunk (the RG-LRU's gates, row-split weights times a column-split input).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def size(group: Group) -> int:
    """Ranks in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def _alone(group: Group) -> bool:
    return size(group) == 1


def rank(group: Group) -> int:
    """This rank's index in ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# plain collectives (out of place)
# ---------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` summed (``op="max"``: the elementwise max) over ``group``."""
    if _alone(group):
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def chunk(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (``size(group)`` equal
    chunks), contiguous."""
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of length {x.shape[dim]} does not "
                         f"split into {n} equal chunks")
    m = x.shape[dim] // n
    return x.narrow(dim, rank(group) * m, m).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's chunk along ``dim``."""
    n = size(group)
    if n == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dim {dim} of length {moved.shape[0]} does not "
                         f"split into {n} equal chunks")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _a2a(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


# ---------------------------------------------------------------------------
# autograd-aware
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.dim, ctx.group), None, None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    """all-to-all of ``x``'s dim-0 chunks, the data on the wire in
    ``wire`` (``torch.float8_e4m3fn``: cast before, cast back after, the
    bytes sent as ``uint8``, which every backend takes); the gradient goes
    back the same way, through the same wire dtype."""

    @staticmethod
    def forward(ctx, x, group, wire):
        ctx.group, ctx.wire = group, wire
        return _wire_a2a(x, group, wire)

    @staticmethod
    def backward(ctx, g):
        return _wire_a2a(g, ctx.group, ctx.wire), None, None


def _wire_a2a(x: torch.Tensor, group: Group, wire) -> torch.Tensor:
    if _alone(group):
        return x if wire is None else x.to(wire).to(x.dtype)
    if wire is None:
        return _a2a(x, group)
    w = x.to(wire)
    out = _a2a(w.view(torch.uint8), group).view(wire)
    return out.to(x.dtype)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced over
    ``group``."""
    return x if _alone(group) else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's g: ``x`` all-reduced over ``group``, gradient as it
    is."""
    return x if _alone(group) else _ReduceFrom.apply(x, group)


def reduce_both(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` all-reduced over ``group``, its gradient all-reduced too."""
    return x if _alone(group) else _ReduceBoth.apply(x, group)


def split_to(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``; the gradient gathered."""
    return x if _alone(group) else _SplitTo.apply(x, dim, group)


def gather_from(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The ranks' ``x`` gathered along ``dim``; the gradient chunked."""
    return x if _alone(group) else _GatherFrom.apply(x, dim, group)


def gather_to(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The ranks' ``x`` gathered along ``dim``; the gradient summed over
    ``group`` and cut to this rank's chunk (reduce-scatter)."""
    return x if _alone(group) else _GatherTo.apply(x, dim, group)


def reduce_scatter_from(x: torch.Tensor, dim: int,
                        group: Group) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's chunk along ``dim``; the
    gradient gathered along ``dim``."""
    return x if _alone(group) else _ReduceScatterFrom.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group: Group,
               wire: Optional[torch.dtype] = None) -> torch.Tensor:
    """All-to-all of ``x``'s ``size(group)`` dim-0 chunks: chunk ``i`` goes
    to rank ``i``, and the chunk from rank ``j`` lands at ``j``."""
    if _alone(group) and wire is None:
        return x
    return _AllToAll.apply(x, group, wire)
