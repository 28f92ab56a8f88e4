"""Multi-pod dry run: every (architecture x input shape x mesh) cell's step
runs once on the production meshes, on one rank of a ``fake`` process group
of the mesh's size, with every tensor a ``meta`` tensor of its rank-local
shape (shapes and dtypes only: nothing of a cell's size is allocated, and
attention takes its plain route, as on any tensor off the card), and the
ops it dispatches are counted (:mod:`repro_torch.core.hlo_cost`) and priced
as a roofline on ``H100_SXM`` (:mod:`repro_torch.core.roofline`). The
reference lowers and compiles each cell with XLA and parses the partitioned
HLO; the record keeps its keys (``ops``, the dispatched-op count, stands
where its ``hlo_lines`` does).

``meta`` tensors give the flops, bytes and collectives that
``FakeTensorMode``'s CPU fakes give, in a quarter of the host time (no Python mode between the ops and their
meta kernels); ``host_peak_rss_bytes`` in the record shows that nothing of
the cell's size reached the host's memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b \\
        --shape train_4k --mesh single --out experiments/dryrun_torch

Each process holds one fake world at a time (:func:`fake_world`); ``main``
makes it at run time, never at import. A cell that raises writes
``<tag>.error`` with the traceback, and ``main`` exits non-zero listing the
failures.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import resource
import time
import traceback
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME,
                                 applicable_shapes, get_config)
from repro_torch.core import roofline as rl
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.hlo_cost import CostCounter
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (PRODUCTION, batch_axes_for,
                                     make_production_mesh, mesh_over)
from repro_torch.models.common import ShardingRules
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig
from repro_torch.parallel.sharding import spec_bytes_per_device
from repro_torch.tree import tree_map

#: the chip the records are priced on
CHIP = H100_SXM


def fake_world(size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``size``
    ranks (tearing down the one before, if its size differs): collectives
    on it return at once and move nothing. Raises where the fake backend
    cannot be imported; there is no smaller fallback world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    """The production mesh, or a mesh of ``mesh_shape`` on the same axis
    names (``(data, model)``, or ``(pod, data, model)`` for three dims)
    over the first ranks of the world."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    names = PRODUCTION[len(mesh_shape) == 3][1]
    return mesh_over(range(math.prod(mesh_shape)), tuple(mesh_shape), names)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``t``'s rank-local shape."""
    return torch.empty(t.sharding.local_shape(t.shape), dtype=t.dtype,
                       device="meta")


def _peak_rss_bytes() -> int:
    """This process's peak resident set since it started (``VmHWM``: an
    exec starts it afresh, where ``ru_maxrss`` keeps the parent's)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict] = None) -> Dict:
    """Count and price one cell's step on this rank of the current world;
    return the analysis record. ``overrides`` take the reference's keys,
    and ``reduced`` (the config's and the shape's ``reduced()``) and
    ``mesh_shape`` (a smaller mesh on the same axis names) besides."""
    overrides = overrides or {}
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if overrides.get("reduced"):
        cfg, shape = cfg.reduced(), shape.reduced()
    mesh_shape = overrides.get("mesh_shape")
    if mesh_shape is not None:
        multi_pod = len(mesh_shape) == 3
    mesh = _mesh(multi_pod, mesh_shape)
    chips = mesh.size
    rules = steps_mod.rules_for_shape(shape, multi_pod, mesh)
    if overrides.get("seq_shard"):
        d = dict(rules.rules)
        d["seq"] = "model"        # Megatron-style sequence parallelism
        rules = ShardingRules(rules=d)
    if overrides.get("moe_ep2d_decode"):
        d = dict(rules.rules)
        d["expert_ff"] = "data"   # 2D expert-weight layout, every cell
        rules = ShardingRules(rules=d)
    if overrides.get("rules"):
        rules = overrides["rules"]
    rt = Runtime(
        tp=mesh.shape["model"],
        mesh=mesh,
        batch_axes=batch_axes_for(mesh),
        moe_impl=overrides.get("moe_impl", "ep"),
        remat=overrides.get(
            "remat", "full" if shape.kind == "train" else "none"),
        decode_impl=overrides.get("decode_impl", "chunked"),
        decode_cache_shard=overrides.get("decode_cache_shard", "none"),
        moe_dispatch_dtype=overrides.get("moe_dispatch_dtype", "bfloat16"),
        moe_capacity_factor=overrides.get("moe_capacity_factor", 1.25),
        moe_ep2d_decode=overrides.get("moe_ep2d_decode", False),
    )
    rec: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": chips, "kind": shape.kind,
        "overrides": {k: v for k, v in overrides.items() if k != "rules"},
    }

    t0 = time.time()
    if shape.kind == "train":
        zero1 = overrides.get("zero1", True)
        fn = steps_mod.make_train_step(cfg, rt, OptConfig(), rules, zero1)
        (state, batch), _ = steps_mod.input_specs(
            cfg, shape, rt, mesh, rules, zero1=zero1,
            moment_dtype=overrides.get("moment_dtype", "float32"))
        args = (state, batch)
    elif shape.kind == "prefill":
        fn = steps_mod.make_prefill_step(cfg, rt, shape.seq_len, rules)
        args, _ = steps_mod.input_specs(cfg, shape, rt, mesh, rules)
    else:
        fn = steps_mod.make_decode_step(cfg, rt, rules)
        args, _ = steps_mod.input_specs(cfg, shape, rt, mesh, rules)
    local = tree_map(_local, args)
    rec["lower_s"] = round(time.time() - t0, 2)

    t1 = time.time()
    with CostCounter() as counter:
        counter.arguments(local)
        out = fn(*local)
        rec["memory"] = counter.memory(out)
    rec["compile_s"] = round(time.time() - t1, 2)
    del out, local

    parsed = counter.totals
    rec["cost"] = {"flops": parsed.flops,
                   "bytes accessed": parsed.bytes_accessed}
    rec["ops"] = counter.ops
    rec["parsed_cost"] = parsed.to_dict()
    rec["collectives"] = rl.collective_bytes(parsed)
    report = rl.roofline_from_artifacts(
        rec["cost"], rec["collectives"], chips, rl.model_flops(cfg, shape),
        CHIP)
    rec["roofline"] = report.to_dict()
    # analytic memory floor: the counted bytes are an upper bound (eager,
    # no fusion); this is the idealized-fusion lower bound
    rec["roofline"]["memory_s_floor"] = rl.memory_floor_s(cfg, shape, chips,
                                                          CHIP)
    # static per-device footprint of the step inputs (weights + state)
    specs = tree_map(lambda t: t.spec, args)
    rec["input_bytes_per_device"] = spec_bytes_per_device(args, specs, mesh)
    rec["fits_hbm"] = bool(rec["input_bytes_per_device"] < CHIP.hbm_bytes)
    # the process's high-water resident set so far: a cell that allocated
    # its tensors would show here
    rec["host_peak_rss_bytes"] = _peak_rss_bytes()
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe-impl", default="ep")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--decode-impl", default=None)
    ap.add_argument("--decode-cache-shard", default=None)
    ap.add_argument("--moe-dispatch", default=None,
                    help="f8 = DSv3-style low-precision dispatch a2a")
    ap.add_argument("--moe-cf", type=float, default=None,
                    help="MoE capacity factor (baseline 1.25)")
    ap.add_argument("--moe-ep2d", action="store_true",
                    help="2D expert sharding for decode (weights fit)")
    ap.add_argument("--moments", default=None,
                    help="optimizer moment dtype (bfloat16 halves opt HBM)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual stream")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' and shapes' reduced() sizes")
    ap.add_argument("--mesh-shape", default=None,
                    help="a smaller mesh, e.g. 2,4 (data, model) or 2,2,2 "
                         "(pod, data, model), in place of --mesh")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    if mesh_shape is not None:
        meshes = ["multi" if len(mesh_shape) == 3 else "single"]
    else:
        meshes = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in applicable_shapes(cfg)]
                  if args.shape == "all" else args.shape.split(","))
        for shape_name in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape_name}__{mesh_kind}" + (
                    f"__{args.tag}" if args.tag else "")
                path = outdir / f"{tag}.json"
                overrides = {"moe_impl": args.moe_impl,
                             "zero1": not args.no_zero1}
                if args.remat:
                    overrides["remat"] = args.remat
                if args.decode_impl:
                    overrides["decode_impl"] = args.decode_impl
                if args.decode_cache_shard:
                    overrides["decode_cache_shard"] = args.decode_cache_shard
                if args.moments:
                    overrides["moment_dtype"] = args.moments
                if args.moe_dispatch:
                    overrides["moe_dispatch_dtype"] = args.moe_dispatch
                if args.moe_cf is not None:
                    overrides["moe_capacity_factor"] = args.moe_cf
                if args.moe_ep2d:
                    overrides["moe_ep2d_decode"] = True
                if args.seq_shard:
                    overrides["seq_shard"] = True
                if args.reduced:
                    overrides["reduced"] = True
                if mesh_shape is not None:
                    overrides["mesh_shape"] = list(mesh_shape)
                try:
                    fake_world(math.prod(mesh_shape) if mesh_shape
                               else math.prod(PRODUCTION[
                                   mesh_kind == "multi"][0]))
                    rec = run_cell(arch, shape_name, mesh_kind == "multi",
                                   overrides)
                    path.write_text(json.dumps(rec, indent=1))
                    r = rec["roofline"]
                    print(f"OK   {tag}: dominant={r['dominant']} "
                          f"step={r['step_time_s']:.4f}s mfu={r['mfu']:.3f} "
                          f"compile={rec['compile_s']}s "
                          f"fits={rec['fits_hbm']}", flush=True)
                except Exception as e:
                    failures.append(tag)
                    path.with_suffix(".error").write_text(
                        traceback.format_exc())
                    print(f"FAIL {tag}: {e}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
