"""The port's dry run (``repro_torch.launch.dryrun``) on fake worlds on the
CPU, and the legacy governor shims against the reference's.

Each arch's cells run in a subprocess of their own (a process holds one
fake world), all started together: stablelm-12b, dbrx-132b, mamba2-2.7b,
recurrentgemma-2b, llama-3.2-vision-11b and seamless-m4t-large-v2 reduced
on a fake (2, 4) mesh (data 2 x model 4), every shape. The records carry
the reference's keys (``ops`` where it has ``hlo_lines``); the input bytes
a device holds equal the reference's ``spec_bytes_per_device`` of the same
cell; the collective bytes of the tensor-parallel prefill (dense, the SSD
and the RG-LRU) and of the ZeRO-1 train step equal the pattern counted by
hand from the config, exactly.
"""
import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models.transformer import Runtime as RefRuntime
from repro.parallel import sharding as ref_sharding

from repro_torch.configs import SHAPES_BY_NAME, applicable_shapes, get_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as M
from repro_torch.models.common import default_rules
from repro_torch.models.transformer import Runtime
from repro_torch.parallel.sharding import (NamedSharding, is_spec,
                                           zero1_specs)
from repro_torch.tree import leaves_with_paths, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 4)
#: run name -> (arch, shapes, extra flags)
CELLS = {"stablelm-12b": ("stablelm-12b", "all", ()),
         "dbrx-132b": ("dbrx-132b", "all", ()),
         "mamba2-2.7b": ("mamba2-2.7b", "all", ()),
         "recurrentgemma-2b": ("recurrentgemma-2b", "all", ()),
         "llama-3.2-vision-11b": ("llama-3.2-vision-11b", "all", ()),
         "seamless-m4t-large-v2": ("seamless-m4t-large-v2", "all", ()),
         "dbrx-132b-f8": ("dbrx-132b", "prefill_32k",
                          ("--moe-dispatch", "f8")),
         "seq_shard": ("stablelm-12b,seamless-m4t-large-v2", "all",
                       ("--seq-shard",)),
         "deepseek-v3-671b": ("deepseek-v3-671b", "prefill_32k,decode_32k",
                              ()),
         "seq_cache": (",".join(("stablelm-12b", "deepseek-v3-671b",
                                 "llama-3.2-vision-11b",
                                 "seamless-m4t-large-v2", "mamba2-2.7b",
                                 "recurrentgemma-2b")), "decode_32k",
                       ("--decode-cache-shard", "seq")),
         "no_zero1": ("stablelm-12b,dbrx-132b", "train_4k", ("--no-zero1",)),
         "moe_local": ("dbrx-132b,deepseek-v3-671b", "all",
                       ("--moe-impl", "local")),
         "moe_dense": ("dbrx-132b,deepseek-v3-671b", "all",
                       ("--moe-impl", "dense")),
         "refused_moe_ep2d": ("dbrx-132b", "train_4k", ("--moe-ep2d",)),
         "refused_moe_ep2d_multi": ("dbrx-132b", "train_4k",
                                    ("--moe-ep2d", "--mesh-shape", "2,2,2")),
         "ep2d_prefill": ("dbrx-132b,deepseek-v3-671b", "prefill_32k",
                          ("--moe-ep2d",)),
         "ep2d_train": ("dbrx-132b,deepseek-v3-671b", "train_4k",
                        ("--moe-ep2d", "--no-zero1")),
         "ep2d_multi": ("dbrx-132b,deepseek-v3-671b", "decode_32k",
                        ("--moe-ep2d", "--mesh-shape", "2,2,2"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (exit code, stdout, out dir)} of one dry-run process per run
    of CELLS, all run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, (arch, shape, extra) in CELLS.items():
        out = tmp_path_factory.mktemp(name)
        procs[name] = (subprocess.Popen(
            [sys.executable, "-W", "ignore", "-m",
             "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--reduced", "--mesh-shape", ",".join(map(str, MESH)),
             "--out", str(out), *extra], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    res = {}
    for name, (p, out) in procs.items():
        so, se = p.communicate(timeout=240)
        res[name] = (p.returncode, so + se, out)
    return res


def _record(runs, arch, shape, run=None, mesh="single"):
    rc, log, out = runs[run or arch]
    path = out / f"{arch}__{shape}__{mesh}.json"
    assert path.exists(), log
    return json.loads(path.read_text())


def _reference_record_keys():
    """The keys the reference's ``run_cell`` puts in its record: those of
    its dict literal and of every ``rec[...] =``."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name)
                and node.target.id == "rec"):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value,
                                                                ast.Name)
                        and t.value.id == "rec"
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_s", "flops_per_dev", "bytes_per_dev",
                 "coll_bytes_per_dev", "model_flops_global",
                 "useful_flops_ratio", "mfu", "chips", "memory_s_floor"}


@pytest.mark.parametrize("arch", ["stablelm-12b", "dbrx-132b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_records_carry_the_reference_keys(runs, arch, shape):
    rc, log, _ = runs[arch]
    assert rc == 0, log
    rec = _record(runs, arch, shape)
    want = _reference_record_keys()
    assert "hlo_lines" in want and "fits_hbm" in want
    assert (want - {"hlo_lines"}) | {"ops"} <= set(rec)
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["chips"] == math.prod(MESH) and rec["mesh"] == "single"
    assert rec["kind"] == SHAPES_BY_NAME[shape].kind
    assert rec["ops"] > 0 and rec["cost"]["flops"] > 0
    r = rec["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"]) > 0
    assert rec["collectives"]["total"] == rec["parsed_cost"][
        "collective_total"] > 0
    assert rec["memory"]["argument_bytes"] == rec["input_bytes_per_device"]
    if arch == "dbrx-132b" and shape != "decode_32k":
        assert rec["collectives"]["__counts__"]["all-to-all"] > 0


def _reference_input_bytes(arch, shape_name):
    cfg = ref_get_config(arch).reduced()
    shape = SHAPES_BY_NAME[shape_name].reduced()
    mesh = RefAbstractMesh(MESH, ("data", "model"))
    rules = ref_steps.rules_for_shape(shape, False, mesh)
    args, _ = ref_steps.input_specs(
        cfg, shape, RefRuntime(tp=MESH[1], mesh=mesh, batch_axes=("data",)),
        mesh, rules)
    specs = jax.tree.map(lambda s: s.sharding.spec, args,
                         is_leaf=lambda x: isinstance(x,
                                                      jax.ShapeDtypeStruct))
    return ref_sharding.spec_bytes_per_device(args, specs, mesh)


@pytest.mark.parametrize("arch", ["stablelm-12b", "dbrx-132b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_bytes_match_the_reference(runs, arch, shape):
    rec = _record(runs, arch, shape)
    assert rec["input_bytes_per_device"] == _reference_input_bytes(arch,
                                                                   shape)


#: the families whose forwards split the SSD's, the RG-LRU's and the cross
#: blocks' widths over model
SPLIT_ARCHS = ("mamba2-2.7b", "recurrentgemma-2b", "llama-3.2-vision-11b",
               "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_families_write_every_record(runs, arch):
    """Each of the SSM, hybrid, VLM and enc-dec families reduced at tp = 4
    writes a record for every shape it applies to, and no ``.error``:
    the reference's keys, flops, and collectives over model."""
    rc, log, out = runs[arch]
    assert rc == 0, log
    assert not list(out.glob("*.error")), log
    want = (_reference_record_keys() - {"hlo_lines"}) | {"ops"}
    shapes = [s.name for s in applicable_shapes(get_config(arch))]
    assert len(shapes) == (4 if arch in SPLIT_ARCHS[:2] else 3)
    for shape in shapes:
        rec = _record(runs, arch, shape)
        assert want <= set(rec) and rec["cost"]["flops"] > 0
        assert rec["collectives"]["__counts__"]["all-reduce"] > 0
        assert rec["memory"]["argument_bytes"] == rec[
            "input_bytes_per_device"]


#: per family, the parameter leaves that ZeRO-1 keeps whole in the port
#: (no dim of the per-layer leaf divides over data) where the reference's
#: leaf, stacked over its layers (cross blocks), splits that stack dim
WHOLE_MOMENT_LEAVES = {"mamba2-2.7b": ("A_log", "D", "dt_bias", "norm_g",
                                       "conv_b"),
                       "llama-3.2-vision-11b": ("gate_a", "gate_m")}


def _whole_moment_bytes(arch):
    """The f32 moments (m and v) the port holds beyond the reference's in a
    train cell: each of WHOLE_MOMENT_LEAVES' leaves whole on every data
    rank, where the reference's stacked leaf holds 1 / dp of it."""
    cfg = get_config(arch).reduced()
    dp, tp = MESH
    mesh = AbstractMesh(MESH, ("data", "model"))
    rt = Runtime(tp=tp)
    shapes = M.init_params(cfg, rt, device="meta")
    p_specs = M.param_specs(cfg, rt, default_rules())
    m_specs = zero1_specs(p_specs, shapes, mesh, ("data",))
    elems = 0
    for (path, t), ps, ms in zip(
            leaves_with_paths(shapes),
            tree_leaves(p_specs, is_leaf=is_spec),
            tree_leaves(m_specs, is_leaf=is_spec)):
        if path.split("/")[-1] in WHOLE_MOMENT_LEAVES.get(arch, ()):
            assert tuple(ms)[:len(ps)] == tuple(ps), path   # kept whole
            elems += math.prod(NamedSharding(mesh, ps).local_shape(t.shape))
    return elems * 2 * 4 * (dp - 1) // dp


@pytest.mark.parametrize("arch,shape", [
    (a, s.name) for a in SPLIT_ARCHS for s in applicable_shapes(get_config(a))])
def test_split_families_input_bytes_match_the_reference(runs, arch, shape):
    """The weights and decode state a device holds at tp = 4 (the SSD's
    and the RG-LRU's shards, the cross blocks' heads) equal the
    reference's ``spec_bytes_per_device`` of the same cell. A train cell
    holds the ZeRO-1 moments too: those of the per-layer leaves with no
    dim to split over data (the SSD's per-head and per-channel vectors, the
    VLM's scalar gates) stay whole on each data rank, where the
    reference's stacked leaf splits its layer dim; that difference is
    counted by hand, and is the only one."""
    rec = _record(runs, arch, shape)
    extra = _whole_moment_bytes(arch) if shape == "train_4k" else 0
    assert (extra > 0) == (shape == "train_4k"
                           and arch in WHOLE_MOMENT_LEAVES)
    assert rec["input_bytes_per_device"] == _reference_input_bytes(
        arch, shape) + extra


# ---------------------------------------------------------------------------
# Megatron's pattern, counted by hand
# ---------------------------------------------------------------------------
def _dense_setup():
    cfg = get_config("stablelm-12b").reduced()
    dp, tp = MESH
    return cfg, dp, tp


def test_tp_prefill_collectives_are_megatrons(runs):
    """Prefill on (data 2, model 4): the vocab-parallel embedding's
    all-reduce of ``[tokens, d]``, two a layer (attention's and the mlp's
    partial outputs), then the last position's logits gathered over the
    vocab split: nothing else."""
    cfg, dp, tp = _dense_setup()
    shape = SHAPES_BY_NAME["prefill_32k"].reduced()
    B = shape.global_batch // dp
    T, d, L, bf16 = B * shape.seq_len, cfg.d_model, cfg.n_layers, 2
    coll = _record(runs, "stablelm-12b", "prefill_32k")["collectives"]
    assert coll["__counts__"] == {"all-reduce": 1 + 2 * L, "all-gather": 1}
    assert coll["all-reduce"] == (1 + 2 * L) * T * d * bf16
    assert coll["all-gather"] == B * cfg.padded_vocab(tp) // tp * bf16
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"]


def _prefill_tokens(cfg_arch):
    cfg = get_config(cfg_arch).reduced()
    dp, tp = MESH
    shape = SHAPES_BY_NAME["prefill_32k"].reduced()
    B = shape.global_batch // dp
    return cfg, dp, tp, B, B * shape.seq_len


def test_ssd_prefill_collectives_by_hand(runs):
    """mamba2-2.7b's prefill on (data 2, model 4), the SSD split over
    model with ``w_in`` cut across its heads:

    * all-reduce: the vocab-parallel embedding's ``[tokens, d]``; a layer,
      the gated RMSNorm's sum of squares ``[tokens, 1]`` in f32 and the
      output's partial sums ``[tokens, d]``: 1 + 2 L;
    * all-gather (this rank's operand): a layer, its columns of the fused
      projection ``[tokens, (2 d_in + 2 G d_state + H) / tp]`` and its conv
      channels ``[tokens, (d_in + 2 G d_state) / tp]``; then the last
      position's logits over the vocab split: 2 L + 1;
    * nothing else."""
    cfg, dp, tp, B, T = _prefill_tokens("mamba2-2.7b")
    from repro_torch.models.ssm import ssm_dims
    d_in, H, _, ds = ssm_dims(cfg)
    G, d, L, bf16, f32 = cfg.ssm_n_groups, cfg.d_model, cfg.n_layers, 2, 4
    w_in, conv = 2 * d_in + 2 * G * ds + H, d_in + 2 * G * ds
    coll = _record(runs, "mamba2-2.7b", "prefill_32k")["collectives"]
    assert coll["__counts__"] == {"all-reduce": 1 + 2 * L,
                                  "all-gather": 2 * L + 1}
    assert coll["all-reduce"] == T * d * bf16 + L * T * (f32 + d * bf16)
    assert coll["all-gather"] == (L * T * (w_in + conv) // tp * bf16
                                  + B * cfg.padded_vocab(tp) // tp * bf16)
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"]


def test_rglru_prefill_collectives_by_hand(runs):
    """recurrentgemma-2b's prefill on (data 2, model 4), the RG-LRU split
    over model:

    * reduce-scatter (the whole operand): a recurrent layer, the partial
      gate products ``x W_a`` and ``x W_i``, ``[tokens, lru_width]`` in
      f32: 2 a recurrent layer;
    * all-reduce ``[tokens, d]``: the embedding's; a recurrent layer, its
      output's partial sums; an attention layer, attention's; every layer,
      its mlp's: 1 + 2 L;
    * all-gather: the last position's logits over the vocab split;
    * nothing else."""
    cfg, dp, tp, B, T = _prefill_tokens("recurrentgemma-2b")
    from repro_torch.models.transformer import hybrid_kinds
    n_rec = hybrid_kinds(cfg).count("rglru")
    d, L, w, bf16, f32 = cfg.d_model, cfg.n_layers, cfg.lru_width, 2, 4
    assert 0 < n_rec < L
    coll = _record(runs, "recurrentgemma-2b", "prefill_32k")["collectives"]
    assert coll["__counts__"] == {"all-reduce": 1 + 2 * L,
                                  "reduce-scatter": 2 * n_rec,
                                  "all-gather": 1}
    assert coll["all-reduce"] == (1 + 2 * L) * T * d * bf16
    assert coll["reduce-scatter"] == 2 * n_rec * T * w * f32
    assert coll["all-gather"] == B * cfg.padded_vocab(tp) // tp * bf16
    assert coll["total"] == (coll["all-reduce"] + coll["reduce-scatter"]
                             + coll["all-gather"])


def _zero1_leaves(cfg, dp, tp):
    """(reduce-scattered leaves' local bytes, their number, all-reduced
    leaves' local bytes, their number): each parameter leaf's ZeRO-1 plan
    from its spec (``zero1_specs`` splits its first free dim that divides
    over data; a leaf it cannot split has its gradient all-reduced)."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    rt = Runtime(tp=tp)
    shapes = M.init_params(cfg, rt, device="meta")
    p_specs = M.param_specs(cfg, rt, default_rules())
    m_specs = zero1_specs(p_specs, shapes, mesh, ("data",))
    rs = n_rs = ar = n_ar = 0
    for t, ps, ms in zip(tree_leaves(shapes),
                         tree_leaves(p_specs, is_leaf=is_spec),
                         tree_leaves(m_specs, is_leaf=is_spec)):
        local = math.prod(NamedSharding(mesh, ps).local_shape(t.shape))
        b = local * t.element_size()
        pad = tuple(ps) + (None,) * (len(ms) - len(ps))
        if tuple(pad) != tuple(ms):
            rs, n_rs = rs + b, n_rs + 1
        else:
            ar, n_ar = ar + b, n_ar + 1
    return rs, n_rs, ar, n_ar


def test_zero1_train_collectives_are_megatrons(runs):
    """The ZeRO-1 train step on (data 2, model 4) with full remat, the
    collectives counted by hand:

    * ``[tokens, d]`` all-reduces: forward 1 + 2 a layer (the embedding's,
      attention's and the mlp's partial sums); the recompute, one a layer
      (attention's; the layer's last op, the mlp's sum, is not re-run:
      checkpoint's early stop); backward 2 a layer (the gradients of the
      activations entering the head- and ffn-split products) and 1 for the
      loss's vocab-split head: 2 + 5 L;
    * the vocab-parallel loss: max, sum of exponentials and gold logit of
      each ``[B, chunk]`` (f32), forward and recompute: 6 a chunk;
    * 0-d f32: the loss's numerator forward and backward and its count
      over data, and the squared gradient norm over all ranks: 4;
    * the kv projections, whose 2 heads are replicated over model's 4
      ranks: their gradients summed over model, 2 a layer;
    * ZeRO-1: each leaf's gradient reduce-scattered over data into its
      moment shard and the updated shard all-gathered back; a leaf with no
      dim to split all-reduced whole.
    """
    cfg, dp, tp = _dense_setup()
    shape = SHAPES_BY_NAME["train_4k"].reduced()
    B = shape.global_batch // dp
    S, d, L, hd = shape.seq_len, cfg.d_model, cfg.n_layers, \
        cfg.resolved_head_dim
    T, bf16, f32 = B * S, 2, 4
    assert cfg.padded_kv_heads(tp) < tp          # kv heads replicated
    kv_local = cfg.padded_kv_heads(tp)
    rs, n_rs, ar_z, n_ar_z = _zero1_leaves(cfg, dp, tp)
    act = (2 + 5 * L) * T * d * bf16
    loss = 6 * T * f32
    scalars = 4 * f32
    kv = 2 * L * d * kv_local * hd * bf16
    coll = _record(runs, "stablelm-12b", "train_4k")["collectives"]
    assert coll["__counts__"] == {
        "all-reduce": (2 + 5 * L) + 6 * (S // min(S, 512)) + 4 + 2 * L
        + n_ar_z,
        "reduce-scatter": n_rs, "all-gather": n_rs}
    assert coll["all-reduce"] == act + loss + scalars + kv + ar_z
    assert coll["reduce-scatter"] == rs
    assert coll["all-gather"] == rs // dp


def test_f8_dispatch_puts_one_byte_an_element_on_the_wire(runs):
    """``--moe-dispatch f8``: the dispatch all-to-all carries the tokens in
    float8_e4m3fn, 1 B an element, the combine's all-to-all (as many
    elements) stays bf16, as DeepSeek-V3 dispatches; nothing else
    changes."""
    bf16 = _record(runs, "dbrx-132b", "prefill_32k")["collectives"]
    f8 = _record(runs, "dbrx-132b", "prefill_32k", "dbrx-132b-f8")
    assert f8["overrides"]["moe_dispatch_dtype"] == "f8"
    f8 = f8["collectives"]
    assert f8["__counts__"] == bf16["__counts__"]
    assert (bf16["all-to-all"] - f8["all-to-all"]) * 4 == bf16[
        "all-to-all"] > 0
    assert f8["all-reduce"] == bf16["all-reduce"]


#: the fields of a record the counter and the roofline give (those
#: tools/dryrun_compare.py compares)
COUNTED = ("cost", "ops", "parsed_cost", "collectives", "roofline",
           "input_bytes_per_device", "memory", "fits_hbm")


@pytest.mark.parametrize("arch", ["stablelm-12b", "seamless-m4t-large-v2"])
def test_seq_shard_writes_every_record(runs, arch):
    """``--seq-shard`` (the rule ``seq -> model``, sequence parallelism)
    writes a record for every shape of the cell, marked with the setting,
    and the process exits 0 with no ``.error``."""
    rc, log, out = runs["seq_shard"]
    assert rc == 0, log
    assert not list(out.glob("*.error"))
    for shape in [s.name for s in applicable_shapes(get_config(arch))]:
        rec = _record(runs, arch, shape, "seq_shard")
        assert rec["overrides"]["seq_shard"] is True
        assert rec["parsed_cost"]["dot_flops"] > 0


def test_seq_shard_train_collectives_by_hand(runs):
    """stablelm-12b's ZeRO-1 train step with full remat on (data 2, model
    4) under ``--seq-shard``, against its default record: the dot flops and
    the input bytes a device equal, the peak of the step's live
    intermediates lower (the saved layer inputs are a quarter), and the
    collectives counted by hand. Each of the default's 2 + 5 L activation
    all-reduces of ``W = [tokens, d]`` bf16 (:func:`test_zero1_train_
    collectives_are_megatrons`) becomes a reduce-scatter charged ``W`` and
    an all-gather charged its local shard ``W / 4``; the recompute also
    gathers each layer's mlp input again (the default's ``copy_to`` moves
    nothing forward): L all-gathers more. Each norm's gain (``ln1``,
    ``ln2`` a layer and ``ln_f``), applied to this rank's rows only, has its
    gradient all-reduced over model: 2 L + 1 all-reduces of ``d`` bf16."""
    cfg, dp, tp = _dense_setup()
    shape = SHAPES_BY_NAME["train_4k"].reduced()
    T = shape.global_batch // dp * shape.seq_len
    d, L = cfg.d_model, cfg.n_layers
    W = T * d * 2
    base = _record(runs, "stablelm-12b", "train_4k")
    have = _record(runs, "stablelm-12b", "train_4k", "seq_shard")
    assert have["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] > 0
    assert have["input_bytes_per_device"] == base["input_bytes_per_device"]
    assert have["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]
    hc, bc = have["collectives"], base["collectives"]
    n_act, n_norm = 2 + 5 * L, 2 * L + 1
    assert hc["__counts__"] == {
        "all-reduce": bc["__counts__"]["all-reduce"] - n_act + n_norm,
        "reduce-scatter": bc["__counts__"]["reduce-scatter"] + n_act,
        "all-gather": bc["__counts__"]["all-gather"] + n_act + L}
    assert hc["all-reduce"] == bc["all-reduce"] - n_act * W + n_norm * d * 2
    assert hc["reduce-scatter"] == bc["reduce-scatter"] + n_act * W
    assert hc["all-gather"] == bc["all-gather"] + (n_act + L) * W // tp


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-12b", "prefill_32k"), ("stablelm-12b", "decode_32k"),
    ("seamless-m4t-large-v2", "decode_32k")])
def test_seq_shard_leaves_serving_records_as_they_are(runs, arch, shape):
    """A prefill that runs no encoder and every decode step read no ``seq``
    rule, as in the reference: the record equals the default's in every
    counted field."""
    base = _record(runs, arch, shape)
    have = _record(runs, arch, shape, "seq_shard")
    assert [k for k in COUNTED if have[k] != base[k]] == []


def test_seq_shard_splits_the_encoder_of_a_prefill(runs):
    """seamless-m4t-large-v2's prefill_32k under ``--seq-shard``: its
    encoder splits the frames (the rule reaches it through the encoder, as
    in the reference), so the record differs from the default's, with the
    dot flops and the input bytes equal. Each encoder layer's two
    all-reduces of ``[B F, d]`` become a reduce-scatter and an all-gather,
    and the encoder's output is gathered once."""
    cfg = get_config("seamless-m4t-large-v2").reduced()
    shape = SHAPES_BY_NAME["prefill_32k"].reduced()
    dp, tp = MESH
    Le = cfg.n_encoder_layers
    W = shape.global_batch // dp * cfg.frontend_seq * cfg.d_model * 2
    base = _record(runs, "seamless-m4t-large-v2", "prefill_32k")
    have = _record(runs, "seamless-m4t-large-v2", "prefill_32k",
                   "seq_shard")
    assert have["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] > 0
    assert have["input_bytes_per_device"] == base["input_bytes_per_device"]
    hc, bc = have["collectives"], base["collectives"]
    assert hc["__counts__"] == {
        "all-reduce": bc["__counts__"]["all-reduce"] - 2 * Le,
        "reduce-scatter": 2 * Le,
        "all-gather": bc["__counts__"]["all-gather"] + 2 * Le + 1}
    assert hc["all-reduce"] == bc["all-reduce"] - 2 * Le * W
    assert hc["reduce-scatter"] == 2 * Le * W
    assert hc["all-gather"] == bc["all-gather"] + (2 * Le + 1) * W // tp


@pytest.mark.parametrize("run,mesh", [("refused_moe_ep2d", "single"),
                                      ("refused_moe_ep2d_multi", "multi")])
def test_moe_settings_without_a_counterpart_fail_by_name(runs, run, mesh):
    """``--moe-ep2d`` on a train cell with ZeRO-1 (the default) fails the
    cell as the reference's does (its zero1_specs puts ``data`` on a spec
    that holds it already: DuplicateSpecError), by a ValueError naming the
    leaf and the axis, on both meshes; the process exits non-zero, no
    record written."""
    rc, log, out = runs[run]
    assert rc != 0 and "1 dry-run failures" in log
    assert not list(out.glob("*.json"))
    text = (out / f"dbrx-132b__train_4k__{mesh}.error").read_text()
    assert "ValueError" in text and "'data' twice" in text, text
    assert "experts/wi" in text and "zero1=False" in text


# ---------------------------------------------------------------------------
# the MoE on split experts: the local dispatch and the dense oracle on the
# mesh, and the ep2d rules on prefill and train
# ---------------------------------------------------------------------------
def _moe_dims(arch):
    """(reduced config, MoE layers, tokens a data rank, capacity of the
    global batch, the all-to-all path's capacity a rank) of prefill_32k on
    MESH"""
    from repro_torch.models.moe import _capacity
    cfg = get_config(arch).reduced()
    shape = SHAPES_BY_NAME["prefill_32k"].reduced()
    dp, tp = MESH
    T = shape.global_batch * shape.seq_len
    L = sum(1 for p, _ in leaves_with_paths(M.param_specs(cfg, Runtime(
        tp=tp)), is_leaf=is_spec) if p.startswith("layers/")
        and p.endswith("mlp/router"))
    return (cfg, L, T // dp, _capacity(T, cfg, 1.25),
            _capacity(T // dp // tp, cfg, 1.25))


def _expert_bytes(arch, layers_only=False):
    """one device's bytes of the experts' weights, split over model only:
    every MoE block's (the MTP block's too), or the decoder layers' alone
    (what a prefill runs)"""
    cfg = get_config(arch).reduced()
    n = sum(1 for p, _ in leaves_with_paths(M.param_specs(cfg, Runtime(
        tp=MESH[1])), is_leaf=is_spec) if p.endswith("experts/wi")
        and (p.startswith("layers/") or not layers_only))
    return n * 3 * cfg.n_experts // MESH[1] * cfg.d_model * cfg.d_ff * 2


@pytest.mark.parametrize("impl", ["local", "dense"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_split_expert_records(runs, arch, impl):
    """``--moe-impl local`` / ``dense`` on (data 2, model 4), one expert a
    rank: every shape's record is written; on prefill_32k the dot flops
    exceed the all-to-all path's by the experts' rows and the router's
    tokens counted by hand: each local expert runs ``min(C, T_loc)`` rows
    (local; C the global batch's capacity) or ``T_loc`` (dense), where the
    all-to-all path runs ``tp * C_a2a``, and the router reads all
    ``T_loc`` tokens, not ``T_loc / tp``."""
    rc, log, _ = runs[f"moe_{impl}"]
    assert rc == 0, log
    for shape in [s.name for s in applicable_shapes(get_config(arch))]:
        rec = _record(runs, arch, shape, f"moe_{impl}")
        assert rec["overrides"]["moe_impl"] == impl
        assert rec["parsed_cost"]["dot_flops"] > 0
    cfg, L, T_loc, C, C_a2a = _moe_dims(arch)
    dp, tp = MESH
    rows = min(C, T_loc) if impl == "local" else T_loc
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    extra = L * (6 * d * ff * E // tp * (rows - tp * C_a2a)
                 + 2 * d * E * (T_loc - T_loc // tp))
    have = _record(runs, arch, "prefill_32k", f"moe_{impl}")
    base = _record(runs, arch, "prefill_32k",
                   None if arch == "dbrx-132b" else "deepseek-v3-671b")
    assert have["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] + extra


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_ep2d_prefill_record(runs, arch):
    """``--moe-ep2d`` on prefill_32k, (data 2, model 4): the input bytes a
    device holds are the ``ep`` record's less exactly (data - 1) / data of
    the experts' bytes; the dot flops are equal; each MoE layer gathers
    its three expert weights over data (the all-gather bytes, charged
    their local shard, up by the decoder layers' stored expert shards: the
    MTP block's experts are held but not run)."""
    rc, log, _ = runs["ep2d_prefill"]
    assert rc == 0, log
    have = _record(runs, arch, "prefill_32k", "ep2d_prefill")
    base = _record(runs, arch, "prefill_32k",
                   None if arch == "dbrx-132b" else "deepseek-v3-671b")
    dp = MESH[0]
    cut = _expert_bytes(arch) * (dp - 1) // dp
    assert have["input_bytes_per_device"] == (
        base["input_bytes_per_device"] - cut)
    assert have["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] > 0
    L = _moe_dims(arch)[1]
    hc, bc = have["collectives"], base["collectives"]
    assert hc["__counts__"]["all-gather"] == (
        bc["__counts__"].get("all-gather", 0) + 3 * L)
    assert hc["all-gather"] == bc.get("all-gather", 0) + (
        _expert_bytes(arch, layers_only=True) // dp)


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_ep2d_train_and_multi_pod_decode_records(runs, arch):
    """``--moe-ep2d --no-zero1`` on train_4k writes its record: for
    dbrx-132b the dot flops of the whole-moment ``ep`` record, and the
    input bytes less (data - 1) / data of the experts' parameters (bf16)
    and of their two f32 moments; the experts' gradients are
    reduce-scattered over data (gather_to's backward), not all-reduced.
    ``--moe-ep2d`` on decode_32k on (pod 2, data 2, model 2) writes its
    record."""
    for run in ("ep2d_train", "ep2d_multi"):
        rc, log, _ = runs[run]
        assert rc == 0, log
    rec = _record(runs, arch, "decode_32k", "ep2d_multi", mesh="multi")
    assert rec["chips"] == 8 and rec["parsed_cost"]["dot_flops"] > 0
    have = _record(runs, arch, "train_4k", "ep2d_train")
    assert have["overrides"]["zero1"] is False
    if arch != "dbrx-132b":
        assert have["parsed_cost"]["dot_flops"] > 0
        return
    base = _record(runs, arch, "train_4k", "no_zero1")
    assert have["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] > 0
    dp, L = MESH[0], _moe_dims(arch)[1]
    cut = _expert_bytes(arch) * (dp - 1) // dp
    assert have["input_bytes_per_device"] == (
        base["input_bytes_per_device"] - cut - 2 * 2 * cut)
    hc, bc = have["collectives"]["__counts__"], base["collectives"][
        "__counts__"]
    assert hc.get("reduce-scatter", 0) == bc.get("reduce-scatter", 0) + 3 * L
    assert hc["all-reduce"] == bc["all-reduce"] - 3 * L


# ---------------------------------------------------------------------------
# the decode cache split over the sequence; whole moments
# ---------------------------------------------------------------------------
#: the counted fields of a record: everything the counter and the roofline
#: give (not the host's seconds and memory, nor the overrides)
COUNTED = ("cost", "ops", "parsed_cost", "collectives", "roofline",
           "input_bytes_per_device", "memory", "fits_hbm")


def _self_cache_bytes(arch):
    """The bytes of one data row's self (or MLA latent) cache, whole over
    model: the cache the split divides over model's ranks."""
    cfg = get_config(arch).reduced()
    shape = SHAPES_BY_NAME["decode_32k"].reduced()
    B, M = shape.global_batch // MESH[0], shape.seq_len
    L = cfg.n_layers
    if cfg.use_mla:
        return L * B * M * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    return 2 * L * B * M * cfg.padded_kv_heads(MESH[1]) * \
        cfg.resolved_head_dim * 2


def _combine_collectives(arch):
    """The combine's collectives a decode step, counted by hand: a layer,
    q gathered over the heads (this rank's operand; MLA gathers ``q_lat``
    and ``q_rope``), the f32 row maxima all-reduced ``[B, Hq]``, and the
    f32 partial sums and ``P V`` ``[B, Hq, Dv + 1]`` reduce-scattered over
    the heads (the whole operand)."""
    cfg = get_config(arch).reduced()
    B = SHAPES_BY_NAME["decode_32k"].reduced().global_batch // MESH[0]
    tp, L = MESH[1], cfg.n_layers
    Hq = cfg.padded_heads(tp)
    if cfg.use_mla:
        gather = 2 * L
        gbytes = L * B * Hq // tp * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        dv = cfg.kv_lora_rank
    else:
        gather = L
        gbytes = L * B * Hq // tp * cfg.resolved_head_dim * 2
        dv = cfg.resolved_head_dim
    return ({"all-gather": gather, "all-reduce": L, "reduce-scatter": L},
            {"all-gather": gbytes, "all-reduce": L * B * Hq * 4,
             "reduce-scatter": L * B * Hq * (dv + 1) * 4})


#: the archs whose reduced cache (2 kv heads, or MLA's latent) the split
#: takes on model = 4; the recurrent families' states have no sequence dim
SEQ_SPLIT = ("stablelm-12b", "deepseek-v3-671b", "llama-3.2-vision-11b",
             "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", SEQ_SPLIT)
def test_seq_split_decode_record(runs, arch):
    """``--decode-cache-shard seq`` on (data 2, model 4): the input bytes a
    device holds fall by exactly (model - 1) / model of the self (or
    latent) cache's, the dot flops are the default record's, and the
    collectives are the default's plus the combine's, counted by hand."""
    rc, log, _ = runs["seq_cache"]
    assert rc == 0, log
    seq = _record(runs, arch, "decode_32k", "seq_cache")
    base = _record(runs, arch, "decode_32k")
    assert seq["overrides"]["decode_cache_shard"] == "seq"
    tp = MESH[1]
    assert seq["input_bytes_per_device"] == (
        base["input_bytes_per_device"]
        - _self_cache_bytes(arch) * (tp - 1) // tp)
    assert seq["parsed_cost"]["dot_flops"] == base["parsed_cost"][
        "dot_flops"] > 0
    counts, nbytes = _combine_collectives(arch)
    have, want = seq["collectives"], base["collectives"]
    for kind in set(have["__counts__"]) | set(want["__counts__"]):
        assert have["__counts__"].get(kind, 0) == (
            want["__counts__"].get(kind, 0) + counts.get(kind, 0)), kind
        assert have.get(kind, 0) == want.get(kind, 0) + nbytes.get(kind, 0), \
            kind


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_seq_split_leaves_recurrent_records_as_they_are(runs, arch):
    """The SSM's state and the hybrid's rings have no sequence dim to
    split: their ``--decode-cache-shard seq`` records equal the default
    ones in every counted field."""
    seq = _record(runs, arch, "decode_32k", "seq_cache")
    base = _record(runs, arch, "decode_32k")
    for k in COUNTED:
        assert seq[k] == base[k], k


def _moment_elems(cfg, zero1):
    """The moment elements a device holds (m, or v): each leaf's shard
    under its ZeRO-1 spec, or its parameter's."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    rt = Runtime(tp=MESH[1])
    shapes = M.init_params(cfg, rt, device="meta")
    p_specs = M.param_specs(cfg, rt, default_rules())
    specs = (zero1_specs(p_specs, shapes, mesh, ("data",)) if zero1
             else p_specs)
    return sum(math.prod(NamedSharding(mesh, s).local_shape(t.shape))
               for t, s in zip(tree_leaves(shapes),
                               tree_leaves(specs, is_leaf=is_spec)))


@pytest.mark.parametrize("arch", ["stablelm-12b", "dbrx-132b"])
def test_whole_moment_train_record(runs, arch):
    """``--no-zero1`` on (data 2, model 4): the dot flops of the ZeRO-1
    record; no reduce-scatter of gradients nor all-gather of parameters
    over data, each such leaf's gradient all-reduced instead (its bytes the
    reduce-scatter's); the moments' bytes a device those of the
    parameters' shards, in f32."""
    rc, log, _ = runs["no_zero1"]
    assert rc == 0, log
    whole = _record(runs, arch, "train_4k", "no_zero1")
    zero = _record(runs, arch, "train_4k")
    assert whole["overrides"]["zero1"] is False
    assert whole["parsed_cost"]["dot_flops"] == zero["parsed_cost"][
        "dot_flops"] > 0
    cz, cw = zero["collectives"], whole["collectives"]
    n_rs = cz["__counts__"]["reduce-scatter"]
    assert n_rs > 0 and "reduce-scatter" not in cw["__counts__"]
    assert cw["__counts__"].get("all-gather", 0) == (
        cz["__counts__"]["all-gather"] - n_rs)
    assert cw["__counts__"]["all-reduce"] == (cz["__counts__"]["all-reduce"]
                                              + n_rs)
    assert cw["all-reduce"] == cz["all-reduce"] + cz["reduce-scatter"]
    cfg = get_config(arch).reduced()
    extra = 2 * 4 * (_moment_elems(cfg, False) - _moment_elems(cfg, True))
    assert extra > 0
    assert whole["input_bytes_per_device"] == (zero["input_bytes_per_device"]
                                               + extra)


# ---------------------------------------------------------------------------
# the governor shims against the reference's (tests/test_power_api.py:33,
# tests/test_modal_governor.py:93-124), at TPU_V5E
# ---------------------------------------------------------------------------
def _grid(mod):
    return [mod.StepProfile(c, m, n) for c in (0.01, 0.2, 1.0)
            for m in (0.01, 0.5, 1.0) for n in (0.0, 0.3)]


def _fields(d):
    return (d.freq_mhz, d.freq_frac, d.mode.idx, d.mode.name, d.time_s,
            d.power_w, d.energy_j, d.baseline_energy_j, d.savings_pct)


@pytest.mark.parametrize("budget,n_freqs,cap_w", [
    (0.0, 11, None), (0.112, 11, None), (0.3, 7, None),
    (0.0, 11, 150.0), (0.05, 21, 180.0),
])
def test_governor_matches_the_reference_and_the_policy(budget, n_freqs,
                                                       cap_w):
    import repro.power as rp
    import repro_torch.power as tp
    ref = rp.PowerGovernor(rp.GovernorConfig(
        slowdown_budget=budget, n_freqs=n_freqs, power_cap_w=cap_w))
    gov = tp.PowerGovernor(tp.GovernorConfig(
        slowdown_budget=budget, n_freqs=n_freqs, power_cap_w=cap_w),
        chip=tp.TPU_V5E)
    pol = tp.EnergyAwarePolicy(slowdown_budget=budget, n_freqs=n_freqs,
                               power_cap_w=cap_w)
    chip = tp.ChipModel(tp.TPU_V5E)
    assert gov.freq_grid() == ref.freq_grid()
    for p, rp_ in zip(_grid(tp), _grid(rp)):
        got = gov.choose(p)
        assert _fields(got) == _fields(ref.choose(rp_))
        assert got == pol.decide(p, chip)
    assert gov.actuator.history == ref.actuator.history


def test_governor_cases_of_the_reference():
    """tests/test_modal_governor.py's fixed cases through the port at
    TPU_V5E, beside the reference's decision."""
    import repro.power as rp
    import repro_torch.power as tp
    from repro_torch.core.governor import SimulatedActuator

    def both(budget, c, m):
        g = tp.PowerGovernor(tp.GovernorConfig(slowdown_budget=budget),
                             chip=tp.TPU_V5E)
        r = rp.PowerGovernor(rp.GovernorConfig(slowdown_budget=budget))
        d = g.choose(tp.StepProfile(compute_s=c, memory_s=m))
        assert _fields(d) == _fields(r.choose(rp.StepProfile(
            compute_s=c, memory_s=m)))
        return d

    down = both(0.0, 0.1, 1.0)              # memory-bound: clocks down
    assert down.freq_mhz < 1700 and down.savings_pct > 5.0
    assert down.mode.idx == 2
    nominal = both(0.0, 1.0, 0.05)          # compute-bound: stays
    assert nominal.freq_mhz == 1700
    assert nominal.savings_pct == pytest.approx(0.0, abs=1e-6)
    for budget in (0.0, 0.2, 0.5):
        for c, m in ((1e-4, 5.0), (2.0, 0.3), (0.7, 0.7)):
            d = both(budget, c, m)
            t0 = tp.ChipModel(tp.TPU_V5E).step_time(
                tp.StepProfile(compute_s=c, memory_s=m), 1.0)
            assert d.time_s <= t0 * (1 + budget) * (1 + 1e-9)
            assert d.energy_j <= d.baseline_energy_j + 1e-9
    act = SimulatedActuator(tp.TPU_V5E)
    gov = tp.PowerGovernor(tp.GovernorConfig(), chip=tp.TPU_V5E,
                           actuator=act)
    gov.choose(tp.StepProfile(0.1, 1.0))
    gov.choose(tp.StepProfile(1.0, 0.1))
    assert len(act.history) == 2


def test_governor_defaults_and_refusals():
    from repro_torch.core.hardware import H100_SXM
    import repro_torch.power as tp
    gov = tp.PowerGovernor()
    assert gov.chip is H100_SXM and gov.actuator.chip is H100_SXM
    assert len(gov.freq_grid()) == 11
    with pytest.raises(ValueError, match="n_freqs must be >= 1"):
        tp.GovernorConfig(n_freqs=0)
    p = tp.StepProfile(0.2, 1.0)
    assert gov.choose(p) == tp.EnergyAwarePolicy().decide(
        p, tp.ChipModel(H100_SXM))
