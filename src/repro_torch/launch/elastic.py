"""Elastic scaling: re-mesh after rank loss, reshard the restored state.

Policy: shrink the data axis to the largest power of two that the
surviving ranks support while keeping the model axis intact (tensor-
parallel groups are the failure domain — losing one rank of a group kills
that group's replica). The restored optimizer step keeps the data pipeline
byte-identical (the synthetic pipeline is a pure function of the step
index). Every rank of the world builds the new mesh (its process groups
are collective); only the ranks inside it restore.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, restore
from repro_torch.checkpoint.checkpointer import saved_dtypes
from repro_torch.launch.mesh import Mesh, batch_axes_for, mesh_over
from repro_torch.launch.steps import train_state_shardings
from repro_torch.models import model as model_mod
from repro_torch.models.common import ShardingRules, default_rules
from repro_torch.models.transformer import Runtime
from repro_torch.tree import leaves_with_paths, tree_map


def largest_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def shrink_mesh(ranks: Optional[Sequence[int]] = None,
                model_axis: int = 1,
                device_type: Optional[str] = None) -> Mesh:
    """The largest (data x model) mesh the surviving ``ranks`` (default:
    the whole world) allow: ``model_axis`` ranks a row, the largest power
    of two of rows, the lowest ranks first."""
    ranks = sorted(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) < model_axis:
        raise ValueError(f"{len(ranks)} ranks cannot hold one model axis "
                         f"of {model_axis}")
    usable = largest_pow2(len(ranks) // model_axis) * model_axis
    return mesh_over(ranks[:usable], (usable // model_axis, model_axis),
                     ("data", "model"), device_type)


def elastic_restore(ckpt_dir: str, cfg, rt_old: Runtime,
                    new_mesh: Mesh, zero1: bool = True,
                    rules: Optional[ShardingRules] = None
                    ) -> Tuple[dict, int, Runtime]:
    """Restore the latest checkpoint into a (possibly smaller) mesh: each
    leaf is cut to this rank's shard of ``new_mesh`` as the train step
    keeps it there (:func:`~repro_torch.launch.steps.train_state_shardings`:
    the parameters under their specs, the moments under their ZeRO-1 specs
    of the new batch axes, or the parameters' own with ``zero1`` false),
    the moments in the dtype they were saved in. ``rules``: the ones the
    state was trained under (default: the new mesh's :func:`default_rules`;
    ``--moe-ep2d``'s store the expert ffn over ``data``).

    Returns (state, step, new_runtime)."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    rt_new = dataclasses.replace(
        rt_old, mesh=new_mesh, tp=new_mesh.shape["model"],
        batch_axes=batch_axes_for(new_mesh))
    rules = rules or default_rules("pod" in new_mesh.axis_names)
    abstract = model_mod.init_params(
        cfg, dataclasses.replace(rt_new, mesh=None), device="meta")
    mdt = saved_dtypes(ckpt_dir, step)[
        "opt/m/" + next(k for k, _ in leaves_with_paths(abstract))]
    moment = lambda p: torch.empty(p.shape, dtype=mdt,  # noqa: E731
                                   device="meta")
    like = {"params": abstract,
            "opt": {"m": tree_map(moment, abstract),
                    "v": tree_map(moment, abstract),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    state = restore(ckpt_dir, step, like,
                    train_state_shardings(cfg, rt_new, rules, zero1))
    return state, step, rt_new
