"""Sharding utilities: the port's PartitionSpec, spec trees bound to a mesh,
ZeRO-1 optimizer-state specs, and per-device footprint accounting.

A spec names, for each leading dim of a tensor, the mesh axes it is split
over: ``None`` (replicated), one axis name, or a tuple of names (split over
their product, the first name outermost). Bound to a mesh
(:func:`named_sharding_tree`) a spec becomes a :class:`NamedSharding`, a
small record of the port's own that slices a full tensor to this rank's
shard and gathers a shard back into the full tensor. The port keeps its own
record rather than ``torch.distributed.tensor`` placements: the model works
on plain rank-local tensors and places every collective itself (explicit
tensor and expert parallelism), so all a spec has to do is cut and join,
and a spec that splits one dim over several axes (``("pod", "data")``) is a
tuple here as in the reference.

:func:`zero1_specs` and :func:`spec_bytes_per_device` are arithmetic over
shapes and take any mesh with ``.shape`` (axis name -> size) and
``.axis_names``, as the reference's do.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.parallel import collectives as coll
from repro_torch.tree import tree_leaves, tree_map


class P(tuple):
    """PartitionSpec: one entry per leading dim (``None``, an axis name, or
    a tuple of names). A tuple, so it compares by value with a tuple and
    with the reference's PartitionSpec, which compares equal to the tuple
    of its entries; as there, a one-name tuple is kept as the name."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def is_spec(x: Any) -> bool:
    """Leaf test for spec trees: a :class:`P` is a tuple, and a tree walk
    would otherwise descend into its axis names."""
    return isinstance(x, P)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: ``()`` for ``None``."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, name) -> int:
    """Devices behind one spec entry: ``None`` counts 1, a tuple of axis
    names multiplies."""
    return math.prod(mesh.shape[n] for n in entry_axes(name))


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` bound to ``mesh``: how this rank's shard of a tensor is cut
    from the full tensor, and how the full tensor is gathered back."""
    mesh: Any
    spec: P

    def __post_init__(self):
        # as the reference's NamedSharding refuses it when it is made
        used = [a for e in self.spec for a in entry_axes(e)]
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} names an axis twice")

    def _entries(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def local_shape(self, shape) -> Tuple[int, ...]:
        """The shard's shape of a tensor of global ``shape``."""
        out = []
        for n, e in zip(shape, self._entries(len(shape))):
            k = _axis_size(self.mesh, e)
            if n % k:
                raise ValueError(f"dim of length {n} does not split over "
                                 f"{e} ({k} ranks) in spec {self.spec}")
            out.append(n // k)
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` on the mesh's device. A tensor
        already there whose shard is all of it comes back as it is; any
        other shard is a copy, so ``full`` can be freed."""
        out = full
        for dim, e in enumerate(self._entries(full.ndim)):
            k = _axis_size(self.mesh, e)
            if k > 1:
                m = full.shape[dim] // k
                out = out.narrow(dim, self.mesh.axis_index(entry_axes(e)) * m,
                                 m)
        self.local_shape(full.shape)
        dev = self.mesh.device
        if out is full and full.device == dev:
            return full
        return torch.empty(out.shape, dtype=out.dtype,
                           device=dev).copy_(out)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (all ranks of the mesh
        call it)."""
        out = local
        for dim, e in enumerate(self._entries(local.ndim)):
            if _axis_size(self.mesh, e) > 1:
                out = coll.all_gather(out, dim,
                                      self.mesh.group(entry_axes(e)))
        return out


def named_sharding_tree(spec_tree: Any, mesh) -> Any:
    """Bind a tree of :class:`P` leaves to ``mesh``, producing the matching
    tree of :class:`NamedSharding`. ``P`` is pinned as the leaf type
    because a PartitionSpec is a tuple, and a tree walk would otherwise
    descend into its axis names."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=is_spec)


def zero1_specs(param_specs: Any, shapes: Any, mesh,
                batch_axes: Tuple[str, ...]) -> Any:
    """ZeRO-1: additionally shard optimizer moments across the data(+pod)
    axes, on the first dimension that is currently unsharded and divisible.
    ``shapes`` is a tree of the same structure whose leaves have
    ``.shape`` (meta tensors, say).

    The port's train step (:func:`repro_torch.launch.steps.make_train_step`)
    then reduce-scatters each gradient into its moment shard, updates the
    shard, and all-gathers the parameters back."""
    dp = math.prod(mesh.shape[a] for a in batch_axes)

    def upgrade(spec: P, shape) -> P:
        dims = tuple(spec) + (None,) * (len(shape.shape) - len(spec))
        for i, (ax, n) in enumerate(zip(dims, shape.shape)):
            if ax is None and n % dp == 0 and n >= dp:
                new = list(dims)
                new[i] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
                return P(*new)
        return P(*dims)

    return tree_map(upgrade, param_specs, shapes, is_leaf=is_spec)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize


def spec_bytes_per_device(shapes: Any, specs: Any, mesh) -> int:
    """Static per-device bytes for a (shape tree, spec tree): each leaf's
    ``size * itemsize`` (a tensor's, the meta device's included, or any
    leaf with ``.shape`` and a numpy-style ``.dtype``) divided by the
    product of the mesh-axis sizes its spec shards over; integer division
    floors odd remainders. Nothing is allocated."""
    total = 0
    for shape, spec in zip(tree_leaves(shapes),
                           tree_leaves(specs, is_leaf=is_spec)):
        denom = 1
        for ax in tuple(spec):
            denom *= _axis_size(mesh, ax)
        total += _nbytes(shape) // max(denom, 1)
    return total
