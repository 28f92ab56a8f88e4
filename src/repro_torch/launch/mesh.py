"""Device meshes over ``torch.distributed`` ranks.

A mesh lays ranks out row-major on named axes (``("data", "model")``, or
``("pod", "data", "model")``): rank ``r`` of a ``(2, 4)`` mesh sits at
``(r // 4, r % 4)``. :class:`Mesh` holds the ``torch.distributed`` process
group of every axis and of every combination of axes, built once with the
mesh (``new_group`` is collective over the whole world, so every rank
builds every mesh, also one it is not in), and the device this rank
computes on. :class:`AbstractMesh` is the shape and names alone, all the
spec arithmetic reads.

The process group is the caller's: ``torch.distributed.init_process_group``
with the backend of the device (``gloo`` on the CPU, ``nccl`` on the card)
before :func:`make_host_mesh`. Nothing here initialises or tears one down.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: the production layouts the reference targets: one pod of 256 chips as
#: (data=16, model=16); two pods of 256 with an outer data-parallel pod axis
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """Axis names and sizes, and nothing else: ``shape`` maps each name to
    its size in axis order, as the reference's meshes do."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(zip(axis_names,
                                                     map(int, shape)))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def _canon(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = tuple(a for a in self.axis_names if a in axes)
        if order != axes:
            raise ValueError(f"axes {axes} are not mesh axes in mesh order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name, or a tuple of names in mesh
        order)."""
        return int(np.prod([self.shape[a] for a in self._canon(axes)]))

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"{type(self).__name__}({dims})"


class Mesh(AbstractMesh):
    """``ranks`` (an array of global ranks, one dim per axis) on named
    axes, with a process group for every non-empty combination of axes.
    ``device_mesh`` is the ``torch.distributed`` DeviceMesh over the same
    ranks. A rank outside the mesh holds it with ``coordinate`` ``None``
    and may not compute on it."""

    def __init__(self, device_mesh, axis_names: Sequence[str]):
        ranks = np.asarray(device_mesh.mesh.tolist(), dtype=np.int64)
        super().__init__(ranks.shape, axis_names)
        self.device_mesh = device_mesh
        self.devices = ranks
        self.device_type = device_mesh.device_type
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self.coordinate: Optional[Dict[str, int]] = (
            dict(zip(self.axis_names, map(int, where[0]))) if len(where)
            else None)
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                self._groups[axes] = self._build_group(axes)
        if self.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(self.device_type)

    def _build_group(self, axes: Tuple[str, ...]):
        """This rank's group over ``axes`` (``None`` outside the mesh):
        one axis is the DeviceMesh's own group; several are made here, one
        group per line of the other axes, every rank calling ``new_group``
        for each."""
        if len(axes) == 1 and self.coordinate is not None:
            return self.device_mesh.get_group(axes[0])
        if len(axes) == 1:
            return None
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        lines = np.transpose(self.devices, rest + keep).reshape(
            -1, int(np.prod([self.devices.shape[i] for i in keep])))
        mine = None
        for line in lines:
            g = dist.new_group(sorted(int(r) for r in line))
            if self.coordinate is not None and dist.get_rank() in line:
                mine = g
        return mine

    def group(self, axes) -> dist.ProcessGroup:
        """The process group over ``axes`` (a name or a tuple of names in
        mesh order) that holds this rank."""
        return self._groups[self._canon(axes)]

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` flattened row-major (the first
        name outermost), which is its rank in :meth:`group`."""
        if self.coordinate is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self}")
        idx = 0
        for a in self._canon(axes):
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_over(ranks: Sequence[int], shape: Sequence[int],
              axis_names: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``ranks`` (row-major) of the
    initialised process group; every rank of the world calls it. The
    device type defaults to the backend's (``nccl``: cuda, else cpu)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = device_type or _device_type()
    ranks = list(ranks)
    if ranks == list(range(dist.get_world_size())):
        dm = init_device_mesh(device_type, tuple(shape),
                              mesh_dim_names=tuple(axis_names))
    else:
        dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(
            tuple(shape)), mesh_dim_names=tuple(axis_names))
    return Mesh(dm, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 ranks as (data=16, model=16). Multi-pod: 512 ranks
    as (pod=2, data=16, model=16); the pod axis is an outer data-parallel
    axis (gradient reduction spans pod x data). Raises ``ValueError`` when
    the world is smaller, as the reference's ``jax.make_mesh`` does."""
    shape, names = PRODUCTION[multi_pod]
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs {need} ranks; the world has {have}")
    return mesh_over(range(need), shape, names)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the first ``data * model`` ranks of the
    initialised process group, through ``init_device_mesh`` when that is
    the whole world: the multi-rank tests' mesh and the elastic-restore
    path's."""
    n = dist.get_world_size()
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {n}")
    return mesh_over(range(data * model), (data, model), ("data", "model"),
                     device_type)


def batch_axes_for(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
