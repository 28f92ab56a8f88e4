"""The multi-rank half of tests/test_torch_distributed.py (no tests of its
own): eight gloo ranks on the CPU, a (data=2, model=4) mesh (and a (4, 2)
one for the serving case), started with torch.multiprocessing. The
sequence-split cases also run the same mesh without the split, and the
whole-moment case the ZeRO-1 step beside it.

    python tests/test_torch_distributed_worker.py WORKDIR

reads ``WORKDIR/case_<name>.npz`` (the reference's parameters and inputs,
written by the test), runs every case on the port twice — on one device
(no mesh) and on the 2 x 4 mesh — and rank 0 writes ``WORKDIR/out.npz``:
per case the losses (or logits) of both runs and every gradient leaf of
both, the mesh's gathered whole (the tp cases of the SSM, hybrid, VLM and
enc-dec families read ``WORKDIR/case_<name>.pt``: the port's parameters,
converted from the reference's by the test, and the inputs). This module
imports torch and the port only (no jax), so the eight ranks start
light.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.elastic import elastic_restore, shrink_mesh  # noqa
from repro_torch.launch.mesh import make_host_mesh, mesh_over  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import (ShardingRules,  # noqa: E402
                                       default_rules, sharding_ctx)
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim.compression import init_error_state  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                           named_sharding_tree)
from repro_torch.tree import (leaves_with_paths, tree_leaves,  # noqa: E402
                              tree_map)

WORLD, DATA, MODEL = 8, 2, 4
#: the reference's multi-device tests inflate the capacity (no drops), so
#: the expert-parallel and the single-device dispatch keep the same pairs
CAPACITY = 8.0
#: the reference's own capacity factor, which the local-dispatch cases run
#: at (their routers skewed, so the global capacity drops pairs)
REF_CAPACITY = 1.25
LR = 1e-3


def reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def unflatten(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def load(workdir, name):
    with np.load(os.path.join(workdir, f"case_{name}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten({k[len("params/"):]: v for k, v in flat.items()
                        if k.startswith("params/")})
    rest = {k: torch.from_numpy(v) for k, v in flat.items()
            if not k.startswith("params/")}
    return params, rest


def rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """this rank's rows of a global batch tensor"""
    return NamedSharding(mesh, default_rules().mesh_axes(["batch"])).shard(t)


def rank_of(mesh) -> int:
    """this rank's flattened index on ``mesh``"""
    return mesh.axis_index(mesh.axis_names)


def grads_of(cfg, rt, params, batch):
    """(gradient, loss) of the whole batch's loss; under a mesh each leaf
    is averaged over the data axis, as the train step averages it."""
    g, metrics = steps._grads(cfg, rt, params, batch)
    if rt.mesh is not None and rt.mesh.shape["data"] > 1:
        grp, n = rt.mesh.group("data"), rt.mesh.shape["data"]
        g = tree_map(lambda t: coll.all_reduce(t, grp) / n, g)
    return g, float(metrics["loss"])


def gathered(tree, specs, mesh):
    shards = named_sharding_tree(specs, mesh)
    return tree_map(lambda t, sh: sh.gather(t), tree, shards)


def flat_np(tree, prefix):
    return {f"{prefix}/{k}": v.detach().numpy()
            for k, v in leaves_with_paths(tree)}


def case_loss(name, arch, workdir, mesh, out, impl="local"):
    """loss and gradients at the reference's parameters: one device, and
    the 2 x 4 mesh (vocab, heads, ffn and experts split over model, the
    batch's rows over data)."""
    cfg = reduced(arch)
    ref, rest = load(workdir, name)
    full = convert.params_from_jax(ref, cfg, device="cpu")
    batch = {"tokens": rest["tokens"]}
    g1, l1 = grads_of(cfg, Runtime(), full, batch)
    rt = Runtime(tp=MODEL, mesh=mesh, moe_impl=impl,
                 moe_capacity_factor=CAPACITY)
    specs = M.param_specs(cfg, rt)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    local = {"tokens": rows(batch["tokens"], mesh)}
    g4, l4 = grads_of(cfg, rt, mine, local)
    out[f"{name}/loss_1"] = np.float64(l1)
    out[f"{name}/loss_mesh"] = np.float64(l4)
    out.update(flat_np(g1, f"{name}/grad_1"))
    out.update(flat_np(gathered(g4, specs, mesh), f"{name}/grad_mesh"))
    if impl == "ep":
        f8 = dataclasses.replace(rt, moe_dispatch_dtype="f8")
        out[f"{name}/loss_mesh_f8"] = np.float64(
            float(M.loss_fn(cfg, f8, mine, local)[0]))
    return cfg, full, rt, specs, mine, local


def case_train(workdir, mesh, out):
    """two ZeRO-1 train steps on the mesh against two on one device."""
    cfg, full, rt, specs, mine, local = case_loss(
        "train", "deepseek-v3-671b", workdir, mesh, out, impl="ep")
    _, rest = load(workdir, "train")
    batch = {"tokens": rest["tokens"]}
    opt = OptConfig(lr=LR)
    s1 = steps.init_train_state(cfg, Runtime(), full)
    s4 = steps.init_train_state(cfg, rt, mine)
    step1 = steps.make_train_step(cfg, Runtime(), opt)
    step4 = steps.make_train_step(cfg, rt, opt)
    for i in range(2):
        s1, m1 = step1(s1, batch)
        s4, m4 = step4(s4, local)
        out[f"train/step_loss_1/{i}"] = np.float64(float(m1["loss"]))
        out[f"train/step_loss_mesh/{i}"] = np.float64(float(m4["loss"]))
        out[f"train/grad_norm_1/{i}"] = np.float64(float(m1["grad_norm"]))
        out[f"train/grad_norm_mesh/{i}"] = np.float64(float(m4["grad_norm"]))
    out.update(flat_np(s1["params"], "train/params_1"))
    out.update(flat_np(gathered(s4["params"], specs, mesh),
                       "train/params_mesh"))
    # int8 error-feedback compression: each leaf quantized at its whole
    # tensor's scale on the mesh, as on one device
    opt8 = OptConfig(lr=LR, grad_compression="int8")
    s1 = {**steps.init_train_state(cfg, Runtime(), full),
          "grad_error": init_error_state(full)}
    s4 = {**steps.init_train_state(cfg, rt, mine),
          "grad_error": init_error_state(mine)}
    step1 = steps.make_train_step(cfg, Runtime(), opt8)
    step4 = steps.make_train_step(cfg, rt, opt8)
    for i in range(2):
        s1, m1 = step1(s1, batch)
        s4, m4 = step4(s4, local)
        out[f"train/int8_loss_1/{i}"] = np.float64(float(m1["loss"]))
        out[f"train/int8_loss_mesh/{i}"] = np.float64(float(m4["loss"]))


def case_elastic(workdir, mesh, out):
    """save on 2 x 4, lose half the ranks, elastic_restore onto 1 x 4: the
    reference test's initial state (zero moments), and a state one ZeRO-1
    step on, whose moments must come back bit for bit."""
    cfg, full, rt, specs, mine, local = case_loss(
        "elastic", "stablelm-12b", workdir, mesh, out)
    stepped_sh = steps.train_state_shardings(cfg, rt)
    state = steps.init_train_state(cfg, rt, mine)
    save(os.path.join(workdir, "ckpt"), 5, state, shardings=stepped_sh)
    state, _ = steps.make_train_step(cfg, rt, OptConfig(lr=LR))(state, local)
    save(os.path.join(workdir, "ckpt_step"), 6, state, shardings=stepped_sh)
    whole = tree_map(lambda t, sh: sh.gather(t), state, stepped_sh)
    if rank_of(mesh) == 0:
        # the 2 x 4 checkpoint restores whole on one device (no shardings)
        back1 = restore(os.path.join(workdir, "ckpt_step"), 6,
                        tree_map(torch.empty_like, whole))
        out["elastic/restored_1x1_bit_for_bit"] = np.bool_(all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(whole), leaves_with_paths(back1))))
    small = shrink_mesh(range(6), model_axis=MODEL)
    if small.coordinate is None:
        return
    _, rest = load(workdir, "elastic")
    st, step, rt_new = elastic_restore(os.path.join(workdir, "ckpt"), cfg,
                                       rt, small)
    new_specs = M.param_specs(cfg, rt_new)
    g, loss = grads_of(cfg, rt_new, st["params"],
                       {"tokens": rows(rest["tokens"], small)})
    back, step6, _ = elastic_restore(os.path.join(workdir, "ckpt_step"), cfg,
                                     rt, small)
    back_sh = steps.train_state_shardings(cfg, rt_new)
    back_whole = gathered(back["params"], new_specs, small)
    mom = {k: tree_map(lambda t, sh: sh.gather(t), back["opt"][k],
                       back_sh["opt"][k]) for k in "mv"}
    params_small = gathered(st["params"], new_specs, small)
    grad_small = gathered(g, new_specs, small)
    if rank_of(small) == 0:
        out["elastic/restored_step"] = np.int64(step)
        out["elastic/restored_tp"] = np.int64(rt_new.tp)
        out["elastic/small_mesh"] = np.array(list(small.shape.values()))
        out["elastic/loss_small"] = np.float64(loss)
        out.update(flat_np(params_small, "elastic/params_small"))
        out.update(flat_np(grad_small, "elastic/grad_small"))
        def equal(a, b):
            b = dict(leaves_with_paths(b))
            return [torch.equal(t, b[k]) for k, t in leaves_with_paths(a)]
        same = equal(whole["params"], back_whole)
        for k in "mv":
            same += equal(whole["opt"][k], mom[k])
        out["elastic/stepped_bit_for_bit"] = np.bool_(
            all(same) and step6 == 6
            and int(back["opt"]["step"]) == int(whole["opt"]["step"]))


def case_elastic_dp(workdir, out):
    """save a ZeRO-1 state with bf16 moments on a (data=4, model=2) mesh
    after one step, lose two of eight ranks, elastic_restore onto the
    (2, 2) mesh left: every leaf back bit for bit in its dtype, each moment
    as the (2, 2) mesh's ZeRO-1 shard; then a second step there against
    two steps on one device."""
    mesh = make_host_mesh(4, 2)
    cfg = reduced("stablelm-12b")
    ref, rest = load(workdir, "elastic")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    batches = [{"tokens": rest["tokens"]}, {"tokens": rest["tokens"].flip(0)}]
    opt = OptConfig(lr=LR, moment_dtype="bfloat16")
    s1 = steps.init_train_state(cfg, Runtime(), full, moment_dtype="bfloat16")
    step1 = steps.make_train_step(cfg, Runtime(), opt)
    for i, batch in enumerate(batches):
        s1, m1 = step1(s1, batch)
        out[f"elastic_dp/loss_1/{i}"] = np.float64(float(m1["loss"]))
    rt = Runtime(tp=2, mesh=mesh)
    sh = steps.train_state_shardings(cfg, rt)
    state = steps.init_train_state(
        cfg, rt, tree_map(lambda t, s: s.shard(t), full, sh["params"]),
        moment_dtype="bfloat16")
    state, m = steps.make_train_step(cfg, rt, opt)(
        state, {"tokens": rows(batches[0]["tokens"], mesh)})
    out["elastic_dp/loss_mesh/0"] = np.float64(float(m["loss"]))
    ckpt = os.path.join(workdir, "ckpt_dp")
    save(ckpt, 1, state, shardings=sh)
    whole = tree_map(lambda t, s: s.gather(t), state, sh)
    small = shrink_mesh(range(6), model_axis=2)
    if small.coordinate is None:
        return
    back, step, rt_new = elastic_restore(ckpt, cfg, rt, small)
    back_sh = steps.train_state_shardings(cfg, rt_new)
    back_whole = tree_map(lambda t, s: s.gather(t), back, back_sh)
    local_shapes = [tuple(t.shape) for t in tree_leaves(back["opt"]["m"])]
    state2, m = steps.make_train_step(cfg, rt_new, opt)(
        back, {"tokens": rows(batches[1]["tokens"], small)})
    params2 = tree_map(lambda t, s: s.gather(t), state2["params"],
                       back_sh["params"])
    if rank_of(small) == 0:
        out["elastic_dp/small_mesh"] = np.array(list(small.shape.values()))
        out["elastic_dp/restored_step"] = np.int64(step)
        out["elastic_dp/loss_mesh/1"] = np.float64(float(m["loss"]))
        have = dict(leaves_with_paths(back_whole))
        out["elastic_dp/bit_for_bit"] = np.bool_(all(
            torch.equal(t, have[k]) and t.dtype == have[k].dtype
            for k, t in leaves_with_paths(whole)))
        out["elastic_dp/moment_dtypes"] = np.array(sorted({
            str(t.dtype) for t in tree_leaves(back["opt"]["m"])}))
        # the moments of a leaf split over data come back as its shard
        full_shapes = [tuple(t.shape)
                       for t in tree_leaves(back_whole["opt"]["m"])]
        out["elastic_dp/moments_split"] = np.int64(sum(
            a != b for a, b in zip(local_shapes, full_shapes)))
        out.update(flat_np(s1["params"], "elastic_dp/params_1"))
        out.update(flat_np(params2, "elastic_dp/params_mesh"))


def case_ep2d(workdir, mesh, out):
    """one decode step on the mesh with 2D expert sharding (experts over
    model, their ffn over data) from the single-device prefill's state."""
    cfg = reduced("deepseek-v3-671b")
    ref, rest = load(workdir, "ep2d")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    toks = rest["tokens"]
    rt1 = Runtime()
    with torch.no_grad():
        _, st1 = D.prefill(cfg, rt1, full, {"tokens": toks}, 16)
        st_copy = tree_map(torch.clone, st1)
        want, _ = D.decode_step(cfg, rt1, full, toks[:, :1], torch.tensor(8),
                                st1)
        rules = ShardingRules(rules={**default_rules().rules,
                                     "expert_ff": "data"})
        rt = Runtime(tp=MODEL, mesh=mesh, moe_impl="ep",
                     moe_ep2d_decode=True, moe_capacity_factor=CAPACITY)
        specs = M.param_specs(cfg, rt, rules=rules)
        mine = tree_map(lambda t, sh: sh.shard(t), full,
                        named_sharding_tree(specs, mesh))
        st_specs = D.decode_state_specs(cfg, rt, 4, 16, rules=rules)
        st = tree_map(lambda t, sh: sh.shard(t), st_copy,
                      named_sharding_tree(st_specs, mesh))
        step = steps.make_decode_step(cfg, rt, rules)
        logits, _ = step(mine, rows(toks[:, :1], mesh), torch.tensor(8), st)
        logits = NamedSharding(mesh, rules.mesh_axes(["batch"])).gather(
            logits)
    out["ep2d/logits_1"] = want.numpy()
    out["ep2d/logits_mesh"] = logits.numpy()


def case_serve(workdir, out):
    """dbrx-132b reduced on a (data=4, model=2) mesh, two experts a rank:
    loss and gradients through the all-to-all, then a prefill (impl="ep")
    and two decode steps (ep2d: the experts' ffn split over data) against
    one device."""
    mesh = make_host_mesh(4, 2)
    cfg = reduced("dbrx-132b")
    ref, rest = load(workdir, "serve")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    g1, l1 = grads_of(cfg, Runtime(), full, {"tokens": rest["tokens"]})
    rt = Runtime(tp=2, mesh=mesh, moe_impl="ep", moe_ep2d_decode=True,
                 moe_capacity_factor=CAPACITY)
    specs = M.param_specs(cfg, rt)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    g4, l4 = grads_of(cfg, rt, mine, {"tokens": rows(rest["tokens"], mesh)})
    out["serve/loss_1"] = np.float64(l1)
    out["serve/loss_mesh"] = np.float64(l4)
    out.update(flat_np(g1, "serve/grad_1"))
    out.update(flat_np(gathered(g4, specs, mesh), "serve/grad_mesh"))
    prompt = rest["prompt"]
    rules2d = ShardingRules(rules={**default_rules().rules,
                                   "expert_ff": "data"})
    with torch.no_grad():
        want, st1 = D.prefill(cfg, Runtime(), full, {"tokens": prompt}, 24)
        got, st = steps.make_prefill_step(cfg, rt, 24)(
            mine, {"tokens": rows(prompt, mesh)})
        want_steps, got_steps = [want], [got]
        dgrp = mesh.group("data")
        for layer in mine["layers"]:
            ex = layer["mlp"]["experts"]
            ex["wi"], ex["wg"] = (coll.chunk(ex[n], 2, dgrp)
                                  for n in ("wi", "wg"))
            ex["wo"] = coll.chunk(ex["wo"], 1, dgrp)
        decode = steps.make_decode_step(cfg, rt, rules2d)
        for i in range(2):
            tok = want_steps[-1][:, -1:].argmax(-1).to(torch.int32)
            want, st1 = D.decode_step(cfg, Runtime(), full, tok,
                                      torch.tensor(prompt.shape[1] + i), st1)
            got, st = decode(mine, rows(tok, mesh),
                             torch.tensor(prompt.shape[1] + i), st)
            want_steps.append(want)
            got_steps.append(got)
    by_rows = NamedSharding(mesh, default_rules().mesh_axes(["batch"]))
    for i, (w, g) in enumerate(zip(want_steps, got_steps)):
        out[f"serve/logits_1/{i}"] = w.numpy()
        out[f"serve/logits_mesh/{i}"] = by_rows.gather(g).numpy()


#: the MoE dispatch on split experts on the 2 x 4 mesh: arch -> reference
#: case (routers skewed, CAPACITY_FACTOR 1.25)
SPLIT_EXPERT_ARCHS = ("dbrx-132b", "deepseek-v3-671b")


def _count_drops(fn):
    """(fn(), pairs the one-device dispatch dropped while it ran)"""
    dropped = []
    orig = moe._combine

    def counting(out_buf, meta, w, T, k):
        dropped.append(int((~meta[3]).sum()))
        return orig(out_buf, meta, w, T, k)
    moe._combine = counting
    try:
        return fn(), sum(dropped)
    finally:
        moe._combine = orig


def case_split_experts(impl, workdir, mesh, out):
    """``moe_impl`` "local" or "dense" with the experts split over model's
    four ranks and the rows over data's two, at the reference's capacity
    factor: loss and gradients against one device (the one-device pairs
    the local dispatch drops counted), and for "local" the first layer's
    block at the mesh's global slots against one device's on the whole
    batch, beside the per-rank capacity and slots of each data rank's rows
    alone (the witness that the check sees the fault)."""
    old = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = REF_CAPACITY
    try:
        for arch in SPLIT_EXPERT_ARCHS:
            name = f"moe_{impl}/{arch}"
            cfg = reduced(arch)
            ref, rest = load(workdir, f"moe_{arch}")
            full = convert.params_from_jax(ref, cfg, device="cpu")
            batch = {"tokens": rest["tokens"]}
            rt1 = Runtime(moe_impl=impl)
            (g1, l1), drops = _count_drops(
                lambda: grads_of(cfg, rt1, full, batch))
            rt = Runtime(tp=MODEL, mesh=mesh, moe_impl=impl)
            specs = M.param_specs(cfg, rt)
            mine = tree_map(lambda t, sh: sh.shard(t), full,
                            named_sharding_tree(specs, mesh))
            g4, l4 = grads_of(cfg, rt, mine, {"tokens": rows(batch["tokens"],
                                                             mesh)})
            out[f"{name}/loss_1"] = np.float64(l1)
            out[f"{name}/loss_mesh"] = np.float64(l4)
            out[f"{name}/dropped_1"] = np.int64(drops)
            out.update(flat_np(g1, f"{name}/grad_1"))
            out.update(flat_np(gathered(g4, specs, mesh), f"{name}/grad_mesh"))
            if impl != "local":
                continue
            layer = next(i for i, lp in enumerate(full["layers"])
                         if "router" in lp["mlp"])
            x = full["emb"][batch["tokens"]]
            with torch.no_grad():
                whole, _ = moe.moe_block_local(full["layers"][layer]["mlp"],
                                               cfg, x)
                half = x.shape[0] // DATA
                per_rank = torch.cat([moe.moe_block_local(
                    full["layers"][layer]["mlp"], cfg,
                    x[r * half:(r + 1) * half])[0] for r in range(DATA)])
                with sharding_ctx(default_rules(), mesh):
                    y, _ = moe.moe_block_local(mine["layers"][layer]["mlp"],
                                               cfg, rows(x, mesh))
                y = NamedSharding(mesh, default_rules().mesh_axes(
                    ["batch"])).gather(y)
            out[f"{name}/block_scale"] = np.float64(float(whole.abs().max()))
            out[f"{name}/block_mesh_err"] = np.float64(
                float((y - whole).abs().max()))
            out[f"{name}/block_per_rank_err"] = np.float64(
                float((per_rank - whole).abs().max()))
    finally:
        moe.CAPACITY_FACTOR = old


def case_ep2d_train(workdir, mesh, out):
    """dbrx-132b reduced on the 2 x 4 mesh under the ep2d rules (the
    experts' ffn stored over data, as --moe-ep2d stores it for every cell):
    a prefill through impl="ep" (each layer's ffn gathered whole) against
    one device, two train steps with whole moments (zero1=False) against
    two on one device, the moments' local shapes, a save and
    elastic_restore bit for bit, the refusal of ZeRO-1, and int8
    compression built without one."""
    cfg = reduced("dbrx-132b")
    ref, rest = load(workdir, "serve")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    rules = ShardingRules(rules={**default_rules().rules,
                                 "expert_ff": "data"})
    rt = Runtime(tp=MODEL, mesh=mesh, moe_impl="ep", moe_ep2d_decode=True,
                 moe_capacity_factor=CAPACITY)
    specs = M.param_specs(cfg, rt, rules=rules)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    prompt = rest["prompt"]
    with torch.no_grad():
        want, _ = D.prefill(cfg, Runtime(), full, {"tokens": prompt}, 24)
        got, _ = steps.make_prefill_step(cfg, rt, 24, rules)(
            mine, {"tokens": rows(prompt, mesh)})
    out["ep2d_train/prefill_logits_1"] = want.numpy()
    out["ep2d_train/prefill_logits_mesh"] = NamedSharding(
        mesh, rules.mesh_axes(["batch"])).gather(got).numpy()
    opt = OptConfig(lr=LR)
    batches = [rest["tokens"], rest["tokens"].flip(0)]
    s1 = steps.init_train_state(cfg, Runtime(), full)
    step1 = steps.make_train_step(cfg, Runtime(), opt)
    s4 = steps.init_train_state(cfg, rt, mine, rules, zero1=False)
    step4 = steps.make_train_step(cfg, rt, opt, rules, zero1=False)
    for i, toks in enumerate(batches):
        s1, m1 = step1(s1, {"tokens": toks})
        s4, m4 = step4(s4, {"tokens": rows(toks, mesh)})
        out[f"ep2d_train/loss_1/{i}"] = np.float64(float(m1["loss"]))
        out[f"ep2d_train/loss_mesh/{i}"] = np.float64(float(m4["loss"]))
    out.update(flat_np(s1["params"], "ep2d_train/params_1"))
    out.update(flat_np(gathered(s4["params"], specs, mesh),
                       "ep2d_train/params_mesh"))
    wi = s4["opt"]["m"]["layers"][0]["mlp"]["experts"]["wi"]
    out["ep2d_train/moment_wi_shape"] = np.array(list(wi.shape))
    out["ep2d_train/moments_as_params"] = np.bool_(all(
        m.shape == p.shape for m, p in zip(
            tree_leaves(s4["opt"]["m"]) + tree_leaves(s4["opt"]["v"]),
            tree_leaves(s4["params"]) * 2)))
    sh = steps.train_state_shardings(cfg, rt, rules, zero1=False)
    ckpt = os.path.join(workdir, "ckpt_ep2d")
    save(ckpt, 2, s4, shardings=sh)
    back, step, _ = elastic_restore(ckpt, cfg, rt, mesh, zero1=False,
                                    rules=rules)
    have = dict(leaves_with_paths(back))
    bit = step == 2 and all(torch.equal(t, have[k]) and t.dtype ==
                            have[k].dtype for k, t in leaves_with_paths(s4))
    differ = coll.all_reduce(torch.tensor(0.0 if bit else 1.0),
                             mesh.group(mesh.axis_names), op="max")
    out["ep2d_train/restore_bit_for_bit"] = np.bool_(float(differ) == 0)
    refusals = []
    for o, zero1 in ((opt, True),
                     (OptConfig(lr=LR, grad_compression="int8"), False)):
        try:
            steps.make_train_step(cfg, rt, o, rules, zero1)
            refusals.append("")
        except (ValueError, NotImplementedError) as e:
            refusals.append(f"{type(e).__name__}: {e}")
    out["ep2d_train/refusals"] = np.array(refusals)


def case_ep2d_multi(workdir, out):
    """One ep2d decode step of deepseek-v3-671b reduced on a (pod=2,
    data=2, model=2) mesh of the eight ranks, the experts' ffn stored over
    data alone (as --moe-ep2d's rule stores it) and each rank computing on
    its pod's half of its data shard, from the one-device prefill's
    state."""
    mesh = mesh_over(range(WORLD), (2, 2, 2), ("pod", "data", "model"))
    cfg = reduced("deepseek-v3-671b")
    ref, rest = load(workdir, "ep2d")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    toks = rest["tokens"]
    rules = ShardingRules(rules={**default_rules(True).rules,
                                 "expert_ff": "data"})
    by_rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    with torch.no_grad():
        _, st1 = D.prefill(cfg, Runtime(), full, {"tokens": toks}, 16)
        st_copy = tree_map(torch.clone, st1)
        want, _ = D.decode_step(cfg, Runtime(), full, toks[:, :1],
                                torch.tensor(8), st1)
        rt = Runtime(tp=2, mesh=mesh, batch_axes=("pod", "data"),
                     moe_impl="ep", moe_ep2d_decode=True,
                     moe_capacity_factor=CAPACITY)
        specs = M.param_specs(cfg, rt, rules=rules)
        mine = tree_map(lambda t, sh: sh.shard(t), full,
                        named_sharding_tree(specs, mesh))
        st = tree_map(lambda t, sh: sh.shard(t), st_copy,
                      named_sharding_tree(D.decode_state_specs(
                          cfg, rt, 4, 16, rules=rules), mesh))
        logits, _ = steps.make_decode_step(cfg, rt, rules)(
            mine, by_rows.shard(toks[:, :1]), torch.tensor(8), st)
        logits = by_rows.gather(logits)
    wi = mine["layers"][-1]["mlp"]["experts"]["wi"]
    out["ep2d_multi/stored_wi_shape"] = np.array(list(wi.shape))
    out["ep2d_multi/logits_1"] = want.numpy()
    out["ep2d_multi/logits_mesh"] = logits.numpy()


#: the sequence-parallel cases (the rule ``seq -> model``, the reference's
#: --seq-shard) on the 2 x 4 mesh: name -> (arch, moe_impl); the parameters
#: and inputs are in case_<name>.pt, written by tests/test_torch_seq_parallel
SEQ_PARALLEL_CASES = {"sp_ssm": ("mamba2-2.7b", "local"),
                      "sp_hybrid": ("recurrentgemma-2b", "local"),
                      "sp_vlm": ("llama-3.2-vision-11b", "local"),
                      "sp_encdec": ("seamless-m4t-large-v2", "local"),
                      "sp_dense": ("stablelm-12b", "local"),
                      "sp_ep": ("dbrx-132b", "ep"),
                      "sp_mla": ("deepseek-v3-671b", "local")}


def seq_rules():
    """The default rules with the sequence split over model, as the
    reference's run_cell installs them for --seq-shard."""
    return ShardingRules(rules={**default_rules().rules, "seq": "model"})


def case_seq_parallel(name, workdir, mesh, out):
    """One family reduced on the 2 x 4 mesh under the rule seq -> model:
    loss and gradients against one device and the same mesh without the
    rule, a ZeRO-1 train step under the rule against the same step
    without it, a sequence that does not split into 4 refused; the
    enc-dec's prefill and decode steps under the rule against one
    device."""
    case = torch.load(os.path.join(workdir, f"case_{name}.pt"))
    arch, impl = SEQ_PARALLEL_CASES[name]
    cfg = reduced(arch)
    full, batch = case["params"], case["batch"]
    g1, l1 = grads_of(cfg, Runtime(), full, batch)
    rt = Runtime(tp=MODEL, mesh=mesh, moe_impl=impl,
                 moe_capacity_factor=CAPACITY)
    specs = M.param_specs(cfg, rt)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    local = {k: rows(v, mesh) for k, v in batch.items()}
    gw, lw = grads_of(cfg, rt, mine, local)
    with sharding_ctx(seq_rules(), mesh):
        gs, ls = grads_of(cfg, rt, mine, local)
    out[f"{name}/loss_1"] = np.float64(l1)
    out[f"{name}/loss_whole"] = np.float64(lw)
    out[f"{name}/loss_mesh"] = np.float64(ls)
    out.update(flat_np(g1, f"{name}/grad_1"))
    out.update(flat_np(gathered(gw, specs, mesh), f"{name}/grad_whole"))
    out.update(flat_np(gathered(gs, specs, mesh), f"{name}/grad_mesh"))
    opt = OptConfig(lr=LR)
    out.update(flat_np(full, f"{name}/step_before"))
    for tag, rules in (("whole", None), ("seq", seq_rules())):
        st = steps.init_train_state(cfg, rt, tree_map(torch.clone, mine),
                                    rules)
        st, m = steps.make_train_step(cfg, rt, opt, rules)(st, local)
        out[f"{name}/step_loss_{tag}"] = np.float64(float(m["loss"]))
        out.update(flat_np(gathered(st["params"], specs, mesh),
                           f"{name}/step_{tag}"))
    short = {**local, "tokens": local["tokens"][:, :-3]}
    try:
        with sharding_ctx(seq_rules(), mesh):
            M.loss_fn(cfg, rt, mine, short)
        out[f"{name}/refusal"] = np.array("")
    except ValueError as e:
        out[f"{name}/refusal"] = np.array(f"ValueError: {e}")
    if cfg.family != "encdec":
        return
    prompt, max_len = case["prompt"], case["max_len"]
    S = prompt["tokens"].shape[1]
    by_rows = NamedSharding(mesh, default_rules().mesh_axes(["batch"]))
    with torch.no_grad():
        want, st1 = D.prefill(cfg, Runtime(), full, prompt, max_len)
        got, st = steps.make_prefill_step(cfg, rt, max_len, seq_rules())(
            mine, {k: rows(v, mesh) for k, v in prompt.items()})
        pairs = [(want, got)]
        decode = steps.make_decode_step(cfg, rt, seq_rules())
        for i, tok in enumerate(case["next"]):
            pos = torch.tensor(S + i)
            want, st1 = D.decode_step(cfg, Runtime(), full, tok, pos, st1)
            got, st = decode(mine, rows(tok, mesh), pos, st)
            pairs.append((want, got))
    for i, (w, g) in enumerate(pairs):
        out[f"{name}/logits_1/{i}"] = w.numpy()
        out[f"{name}/logits_mesh/{i}"] = by_rows.gather(g).numpy()


def case_ep2d_int8(mesh, out):
    """dbrx-132b reduced on the 2 x 4 mesh, two whole-moment train steps
    with int8 gradient compression under the ep2d rules (the experts' ffn
    stored over data), against the same steps with the ffn whole (the
    default rules) and against one device."""
    cfg = reduced("dbrx-132b")
    full = M.init_params(cfg, Runtime(), torch.Generator().manual_seed(12),
                         device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 33),
                         generator=torch.Generator().manual_seed(13))
    batches = [toks, toks.flip(0)]
    opt = OptConfig(lr=LR, grad_compression="int8")
    rt = Runtime(tp=MODEL, mesh=mesh, moe_impl="ep",
                 moe_capacity_factor=CAPACITY)
    ep2d = ShardingRules(rules={**default_rules().rules,
                                "expert_ff": "data"})
    s1 = steps.init_train_state(cfg, Runtime(), full)
    s1["grad_error"] = init_error_state(full)
    step1 = steps.make_train_step(cfg, Runtime(), opt)
    runs = {}
    for tag, rules in (("ep2d", ep2d), ("whole", None)):
        specs = M.param_specs(cfg, rt, rules=rules)
        mine = tree_map(lambda t, sh: sh.shard(t), full,
                        named_sharding_tree(specs, mesh))
        st = steps.init_train_state(cfg, rt, mine, rules, zero1=False)
        st["grad_error"] = init_error_state(mine)
        runs[tag] = (specs, st, steps.make_train_step(cfg, rt, opt, rules,
                                                      zero1=False))
    for i, t in enumerate(batches):
        s1, m1 = step1(s1, {"tokens": t})
        out[f"ep2d_int8/loss_1/{i}"] = np.float64(float(m1["loss"]))
        for tag, (specs, st, step) in list(runs.items()):
            st, m = step(st, {"tokens": rows(t, mesh)})
            runs[tag] = (specs, st, step)
            out[f"ep2d_int8/loss_{tag}/{i}"] = np.float64(float(m["loss"]))
    for tag, (specs, st, _) in runs.items():
        out.update(flat_np(gathered(st["params"], specs, mesh),
                           f"ep2d_int8/params_{tag}"))
        out.update(flat_np(gathered(st["grad_error"], specs, mesh),
                           f"ep2d_int8/error_{tag}"))
    wi = runs["ep2d"][1]["grad_error"]["layers"][0]["mlp"]["experts"]["wi"]
    out["ep2d_int8/error_wi_shape"] = np.array(list(wi.shape))


#: the families run data-parallel on a (data=8, model=1) mesh
DP_ONLY = ("mamba2-2.7b", "recurrentgemma-2b", "llama-3.2-vision-11b",
           "seamless-m4t-large-v2")
#: the tp > 1 cases of the SSM, hybrid, VLM and enc-dec families: name ->
#: arch (the config's overrides and inputs are in case_<name>.pt)
TP_FAMILY_CASES = {"tp_ssm": "mamba2-2.7b", "tp_hybrid": "recurrentgemma-2b",
                   "tp_vlm": "llama-3.2-vision-11b",
                   "tp_encdec": "seamless-m4t-large-v2",
                   "tp_hybrid_padded": "recurrentgemma-2b"}


def case_tp_family(name, workdir, mesh, out):
    """One family reduced on the 2 x 4 mesh (the SSD's ``w_in`` / conv
    channels, the RG-LRU's width, the heads and ffn and vocab all split
    over model): loss and gradients, then a prefill and two decode steps,
    each against one device."""
    case = torch.load(os.path.join(workdir, f"case_{name}.pt"))
    cfg = dataclasses.replace(reduced(TP_FAMILY_CASES[name]), **case["cfg"])
    full, batch = case["params"], case["batch"]
    g1, l1 = grads_of(cfg, Runtime(), full, batch)
    rt = Runtime(tp=MODEL, mesh=mesh)
    specs = M.param_specs(cfg, rt)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    g4, l4 = grads_of(cfg, rt, mine,
                      {k: rows(v, mesh) for k, v in batch.items()})
    out[f"{name}/loss_1"] = np.float64(l1)
    out[f"{name}/loss_mesh"] = np.float64(l4)
    out.update(flat_np(g1, f"{name}/grad_1"))
    out.update(flat_np(gathered(g4, specs, mesh), f"{name}/grad_mesh"))
    prompt, max_len = case["prompt"], case["max_len"]
    S = prompt["tokens"].shape[1]
    by_rows = NamedSharding(mesh, default_rules().mesh_axes(["batch"]))
    with torch.no_grad():
        want, st1 = D.prefill(cfg, Runtime(), full, prompt, max_len)
        got, st = steps.make_prefill_step(cfg, rt, max_len)(
            mine, {k: rows(v, mesh) for k, v in prompt.items()})
        pairs = [(want, got)]
        decode = steps.make_decode_step(cfg, rt)
        for i, tok in enumerate(case["next"]):
            pos = torch.tensor(S + i)
            want, st1 = D.decode_step(cfg, Runtime(), full, tok, pos, st1)
            got, st = decode(mine, rows(tok, mesh), pos, st)
            pairs.append((want, got))
    for i, (w, g) in enumerate(pairs):
        out[f"{name}/logits_1/{i}"] = w.numpy()
        out[f"{name}/logits_mesh/{i}"] = by_rows.gather(g).numpy()


#: the decode cache split over the sequence on the 2 x 4 mesh: case -> arch
#: (each reduced config's 2 kv heads, or MLA's latent cache, do not split
#: over model's 4 ranks, so the split is taken)
SEQ_CACHE_CASES = {"seq_gqa": "stablelm-12b", "seq_mla": "deepseek-v3-671b",
                   "seq_vlm": "llama-3.2-vision-11b",
                   "seq_encdec": "seamless-m4t-large-v2"}


def _seq_leg(cfg, full, mine, case, mesh, lengths, out, key, **moe):
    """One leg of a sequence-split case: a prefill (of each sequence's
    ``lengths`` tokens, or lock-step when ``None``) and decode steps fed
    ``case["next"]``, on one device, on the mesh with the split and on the
    mesh without it; the logits of each, and the caches held rank by
    rank. ``moe``: the mesh runs' expert-parallel knobs."""
    M, B = case["max_len"], case["batch"]
    prompt = dict(case["prompt"] if lengths is None else case["ragged"])
    S = prompt["tokens"].shape[1]
    by_rows = NamedSharding(mesh, default_rules().mesh_axes(["batch"]))
    rt_split = Runtime(tp=MODEL, mesh=mesh, decode_cache_shard="seq", **moe)
    rt_whole = Runtime(tp=MODEL, mesh=mesh, **moe)
    local = {k: rows(v, mesh) for k, v in prompt.items()}
    lens = None if lengths is None else torch.as_tensor(lengths)
    with torch.no_grad():
        runs = {}
        for name, rt, params, batch in (
                ("1", Runtime(), full, prompt),
                ("mesh", rt_split, mine, local),
                ("whole", rt_whole, mine, local)):
            on_mesh = rt.mesh is not None
            ln = (None if lens is None else
                  rows(lens, mesh) if on_mesh else lens)
            logits, st = D.prefill(cfg, rt, params, batch, M, lengths=ln)
            got = [by_rows.gather(logits) if on_mesh else logits]
            after = {k: v.clone() for k, v in leaves_with_paths(st)}
            for i, tok in enumerate(case["next"]):
                pos = (torch.tensor(S + i) if lens is None
                       else (lens + i).to(torch.int32))
                logits, st = D.decode_step(
                    cfg, rt, params, rows(tok, mesh) if on_mesh else tok,
                    rows(pos, mesh) if on_mesh and pos.ndim else pos, st)
                got.append(by_rows.gather(logits) if on_mesh else logits)
            runs[name] = (got, st, after)
    for i, (w, g) in enumerate(zip(runs["1"][0], runs["mesh"][0])):
        out[f"{key}/logits_1/{i}"] = w.numpy()
        out[f"{key}/logits_mesh/{i}"] = g.numpy()
    # after the prefill, each rank's shard of the split cache equals, bit
    # for bit, the slice at its positions of the cache the same mesh holds
    # unsplit; after the steps, the gathered split cache against one
    # device's
    r = mesh.axis_index("model")
    same, n_split = True, 0
    for path, t in runs["mesh"][2].items():
        w = runs["whole"][2][path]
        if t.shape != w.shape:
            dim = next(d for d in range(t.ndim) if t.shape[d] != w.shape[d])
            w = w.narrow(dim, r * t.shape[dim], t.shape[dim])
            n_split += 1
        same = same and torch.equal(t, w)
    differ = coll.all_reduce(torch.tensor(0.0 if same else 1.0),
                             mesh.group(mesh.axis_names), op="max")
    have = dict(leaves_with_paths(gathered(
        runs["mesh"][1], D.decode_state_specs(cfg, rt_split, B, M), mesh)))
    worst = 0.0
    for path, w in leaves_with_paths(runs["1"][1]):
        lim = float(w.abs().max())
        worst = max(worst, float((have[path] - w).abs().max()) / lim)
    out[f"{key}/prefill_shards_bit_for_bit"] = np.bool_(float(differ) == 0)
    out[f"{key}/split_leaves"] = np.int64(n_split)
    out[f"{key}/cache_rel_err"] = np.float64(worst)


def case_seq_cache(name, workdir, mesh, out):
    """The decode cache split over the sequence (``decode_cache_shard=
    "seq"``) on the 2 x 4 mesh: a lock-step leg and a per-sequence ragged
    leg, each a prefill and decode steps, against one device (and the
    reference's tp=1 logits in the test)."""
    case = torch.load(os.path.join(workdir, f"case_{name}.pt"))
    cfg = reduced(SEQ_CACHE_CASES[name])
    full = case["params"]
    # the experts split over model take the all-to-all path (the local
    # one needs every expert on the rank), at the inflated capacity
    moe = (dict(moe_impl="ep", moe_capacity_factor=CAPACITY)
           if cfg.family == "moe" else {})
    rt = Runtime(tp=MODEL, mesh=mesh)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(M.param_specs(cfg, rt), mesh))
    _seq_leg(cfg, full, mine, case, mesh, None, out, f"{name}/lock", **moe)
    _seq_leg(cfg, full, mine, case, mesh, case["lengths"], out,
             f"{name}/ragged", **moe)


def case_no_zero1(workdir, mesh, out):
    """stablelm-12b reduced (f32) on the 2 x 4 mesh from the elastic case's
    parameters: two train steps with whole moments (``zero1=False``)
    against two ZeRO-1 steps and two on one device; each rank's moments
    against its parameter shard and the other data row's; a save and
    ``elastic_restore`` of the whole-moment state."""
    cfg = reduced("stablelm-12b")
    ref, rest = load(workdir, "elastic")
    full = convert.params_from_jax(ref, cfg, device="cpu")
    batches = [rest["tokens"], rest["tokens"].flip(0)]
    opt = OptConfig(lr=LR)
    rt = Runtime(tp=MODEL, mesh=mesh)
    specs = M.param_specs(cfg, rt)
    mine = tree_map(lambda t, sh: sh.shard(t), full,
                    named_sharding_tree(specs, mesh))
    s1 = steps.init_train_state(cfg, Runtime(), full)
    step1 = steps.make_train_step(cfg, Runtime(), opt)
    runs = {z: (steps.init_train_state(cfg, rt, tree_map(torch.clone, mine),
                                       zero1=z),
                steps.make_train_step(cfg, rt, opt, zero1=z))
            for z in (True, False)}
    for i, toks in enumerate(batches):
        s1, m1 = step1(s1, {"tokens": toks})
        out[f"no_zero1/loss_1/{i}"] = np.float64(float(m1["loss"]))
        for z, (st, step) in list(runs.items()):
            st, m = step(st, {"tokens": rows(toks, mesh)})
            runs[z] = (st, step)
            out[f"no_zero1/loss_{'zero1' if z else 'whole'}/{i}"] = (
                np.float64(float(m["loss"])))
    out.update(flat_np(s1["params"], "no_zero1/params_1"))
    for z, (st, _) in runs.items():
        out.update(flat_np(gathered(st["params"], specs, mesh),
                           f"no_zero1/params_{'zero1' if z else 'whole'}"))
    whole, zero = runs[False][0], runs[True][0]
    dgrp = mesh.group("data")
    moments = tree_leaves(whole["opt"]["m"]) + tree_leaves(whole["opt"]["v"])
    shapes = all(m.shape == p.shape for m, p in zip(
        moments, tree_leaves(whole["params"]) * 2))
    # the same whole moment on each data row: gathered over data, equal
    rows_equal = all([torch.equal(*coll.all_gather(m[None], 0, dgrp))
                      for m in moments])
    split = sum(m.shape != p.shape for m, p in zip(
        tree_leaves(zero["opt"]["m"]), tree_leaves(zero["params"])))
    ckpt = os.path.join(workdir, "ckpt_whole")
    save(ckpt, 2, whole, shardings=steps.train_state_shardings(
        cfg, rt, zero1=False))
    back, step, _ = elastic_restore(ckpt, cfg, rt, mesh, zero1=False)
    have = dict(leaves_with_paths(back))
    bit = step == 2 and all(torch.equal(t, have[k]) and t.dtype ==
                            have[k].dtype
                            for k, t in leaves_with_paths(whole))
    flags = torch.tensor([float(not shapes), float(not rows_equal),
                          float(not bit)])
    flags = coll.all_reduce(flags, mesh.group(mesh.axis_names), op="max")
    out["no_zero1/moments_whole_on_every_rank"] = np.bool_(
        float(flags[0]) == 0 and float(flags[1]) == 0)
    out["no_zero1/zero1_moments_split"] = np.int64(split)
    out["no_zero1/restore_bit_for_bit"] = np.bool_(float(flags[2]) == 0)


def case_pairs(mesh, out):
    """The two autograd pairs over the model axis against the gathered
    computation's autograd on the whole tensors: each rank reads the
    gathered whole through weights of its own (gather_to), or needs its
    chunk of the sum of the ranks' partials (reduce_scatter_from)."""
    grp = mesh.group("model")
    r, n = coll.rank(grp), coll.size(grp)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(3, 7, 4 * n, generator=g)
    W = torch.randn(n, 3, 7, 4 * n, generator=g)
    xl = coll.chunk(x, -1, grp).requires_grad_()
    y = coll.gather_to(xl, -1, grp)
    (y * W[r]).sum().backward()
    xw = x.clone().requires_grad_()
    sum((xw * W[s]).sum() for s in range(n)).backward()
    errs = [(y - x).abs().max(),
            (coll.all_gather(xl.grad, -1, grp) - xw.grad).abs().max()]
    P = torch.randn(n, 3, 7, 4 * n, generator=g)
    V = torch.randn(n, 3, 7, 4, generator=g)
    pl = P[r].clone().requires_grad_()
    y = coll.reduce_scatter_from(pl, -1, grp)
    (y * V[r]).sum().backward()
    Pw = P.clone().requires_grad_()
    tot = Pw.sum(dim=0)
    sum((tot[..., 4 * s:4 * (s + 1)] * V[s]).sum()
        for s in range(n)).backward()
    errs += [(y - tot[..., 4 * r:4 * (r + 1)]).abs().max(),
             (pl.grad - Pw.grad[r]).abs().max()]
    errs = coll.all_reduce(torch.stack(errs).detach(), mesh.group(
        mesh.axis_names), op="max")
    out["pairs/errs"] = errs.numpy()
    out["pairs/scale"] = np.float64(float(max(
        xw.grad.abs().max(), tot.abs().max(), Pw.grad.abs().max())))


def case_dp_only(out):
    """Each of DP_ONLY reduced on a (data=8, model=1) mesh: the batch's
    rows over eight ranks against one device (loss and gradients)."""
    mesh = make_host_mesh(8, 1)
    for arch in DP_ONLY:
        cfg = reduced(arch)
        g = torch.Generator().manual_seed(7)
        full = M.init_params(cfg, Runtime(), g, device="cpu")
        if cfg.family == "vlm":
            # the tanh gates start at zero, which zeroes the cross blocks'
            # gradients on every route; drawn N(0, 1) they carry some
            for c in full["layers"]["cross"]:
                c["gate_a"], c["gate_m"] = (torch.randn(1, generator=g)
                                            for _ in range(2))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 33),
                                         generator=g)}
        if cfg.frontend_seq:
            batch["frontend"] = torch.randn(
                (8, cfg.frontend_seq, cfg.d_model), generator=g) * 0.02
        g1, l1 = grads_of(cfg, Runtime(), full, batch)
        rt = Runtime(mesh=mesh)
        local = {k: rows(v, mesh) for k, v in batch.items()}
        g8, l8 = grads_of(cfg, rt, full, local)
        out[f"dp_only/{arch}/loss_1"] = np.float64(l1)
        out[f"dp_only/{arch}/loss_mesh"] = np.float64(l8)
        out.update(flat_np(g1, f"dp_only/{arch}/grad_1"))
        out.update(flat_np(g8, f"dp_only/{arch}/grad_mesh"))


def run(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    moe.CAPACITY_FACTOR = CAPACITY
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(DATA, MODEL)
        out: dict = {"mesh": np.array(list(mesh.shape.values()))}
        with open(os.path.join(workdir, "cases.json")) as f:
            cases = json.load(f)
        if "dp_tp" in cases:
            case_loss("dp_tp", "qwen2.5-14b", workdir, mesh, out)
        if "ep" in cases:
            case_loss("ep", "dbrx-132b", workdir, mesh, out, impl="ep")
        if "train" in cases:
            case_train(workdir, mesh, out)
        if "elastic" in cases:
            case_elastic(workdir, mesh, out)
        if "elastic_dp" in cases:
            case_elastic_dp(workdir, out)
        if "ep2d" in cases:
            case_ep2d(workdir, mesh, out)
        if "serve" in cases:
            case_serve(workdir, out)
        if "dp_only" in cases:
            case_dp_only(out)
        for name in TP_FAMILY_CASES:
            if name in cases:
                case_tp_family(name, workdir, mesh, out)
        if "pairs" in cases:
            case_pairs(mesh, out)
        for name in SEQ_CACHE_CASES:
            if name in cases:
                case_seq_cache(name, workdir, mesh, out)
        if "no_zero1" in cases:
            case_no_zero1(workdir, mesh, out)
        for impl in ("local", "dense"):
            if f"moe_{impl}" in cases:
                case_split_experts(impl, workdir, mesh, out)
        if "ep2d_train" in cases:
            case_ep2d_train(workdir, mesh, out)
        if "ep2d_multi" in cases:
            case_ep2d_multi(workdir, out)
        for name in SEQ_PARALLEL_CASES:
            if name in cases:
                case_seq_parallel(name, workdir, mesh, out)
        if "ep2d_int8" in cases:
            case_ep2d_int8(mesh, out)
        dist.barrier()
        if rank == 0:
            np.savez(os.path.join(workdir, "out.npz"), **out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(workdir: str) -> int:
    mp.spawn(run, args=(workdir,), nprocs=WORLD, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
