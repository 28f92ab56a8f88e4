"""The port's spec arithmetic against the reference's, exactly: every case
of tests/test_sharding.py on the port; ``param_specs`` for every arch
(full and reduced configs) x tp in {1, 4, 16} x multi_pod; ``opt_state_specs``;
``zero1_specs`` and ``spec_bytes_per_device`` on the (16, 16) and
(2, 16, 16) production meshes; ``rules_for_shape`` and ``input_specs``
(shapes, dtypes, specs) for every applicable (arch, shape). No devices:
abstract meshes on both sides (the reference's ``jax.sharding.AbstractMesh``,
the port's :class:`repro_torch.launch.mesh.AbstractMesh`), and the port's
parameters are ``meta`` tensors."""
import signal

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCH_IDS, applicable_shapes
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import model as ref_M
from repro.models.common import default_rules as ref_rules
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import opt_state_specs as ref_opt_state_specs
from repro.parallel import sharding as ref_sharding

from repro_torch import convert
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import steps
from repro_torch.launch.elastic import largest_pow2
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.common import default_rules, shard, sharding_ctx
from repro_torch.models.transformer import Runtime
from repro_torch.optim import opt_state_specs
from repro_torch.parallel.sharding import (NamedSharding, P, is_spec,
                                           named_sharding_tree,
                                           spec_bytes_per_device,
                                           zero1_specs)
from repro_torch.tree import leaves_with_paths, tree_leaves

TEST_TIMEOUT_S = 60
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test of this file gets TEST_TIMEOUT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _sds(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _is_ref_spec(x):
    return isinstance(x, RefP)


def _ref_tuples(tree):
    """the reference's spec tree with each PartitionSpec as the tuple of its
    entries"""
    return jax.tree.map(tuple, tree, is_leaf=_is_ref_spec)


def _cfg(arch, reduced):
    return (get_config(arch).reduced() if reduced else get_config(arch),
            ref_get_config(arch).reduced() if reduced
            else ref_get_config(arch))


# ---------------------------------------------------------------------------
# tests/test_sharding.py, case by case, on the port
# ---------------------------------------------------------------------------
def test_named_sharding_tree_binds_every_leaf():
    mesh = AbstractMesh((1,), ("data",))
    tree = {"w": P("data"), "b": P(), "nest": [P(None, "data")]}
    out = named_sharding_tree(tree, mesh)
    assert set(out) == {"w", "b", "nest"}
    for leaf in tree_leaves(out):
        assert isinstance(leaf, NamedSharding)
        assert leaf.mesh is mesh
    # the P leaves survive unflattened (P is a tuple — without the
    # is_leaf pin, a tree walk would descend into the axis-name strings)
    assert out["nest"][0].spec == P(None, "data")


def test_zero1_upgrades_first_unsharded_divisible_dim():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    specs = {"w": P(None, "model"), "b": P()}
    shapes = {"w": _sds((8, 16)), "b": _sds((8,))}
    out = zero1_specs(specs, shapes, mesh, batch_axes=("data",))
    assert out["w"] == P("data", "model")
    assert out["b"] == P("data")


def test_zero1_leaves_undivisible_dims_replicated():
    class FakeMesh:
        shape = {"data": 4}
    specs = {"w": P()}
    shapes = {"w": _sds((3, 6))}     # 3 % 4 != 0 and 6 % 4 != 0
    out = zero1_specs(specs, shapes, FakeMesh(), batch_axes=("data",))
    assert out["w"] == P(None, None)


def test_spec_bytes_per_device_divides_by_sharded_axes():
    class FakeMesh:
        shape = {"data": 4, "model": 2}

    def at(spec):
        return spec_bytes_per_device(
            {"x": _sds((64, 32))}, {"x": spec}, FakeMesh())

    full = 64 * 32 * 4
    assert at(P()) == full                         # replicated
    assert at(P("data")) == full // 4
    assert at(P("data", "model")) == full // 8
    assert at(P(("data", "model"))) == full // 8   # both axes on one dim


def test_spec_bytes_accumulates_over_tree():
    class FakeMesh:
        shape = {"data": 2}
    shapes = {"a": _sds((16,)), "b": _sds((8, 8), torch.float64)}
    specs = {"a": P("data"), "b": P()}
    expect = (16 * 4) // 2 + 8 * 8 * 8
    assert spec_bytes_per_device(shapes, specs, FakeMesh()) == expect


def test_partition_spec_compares_with_the_reference():
    """one-name tuples are kept as the name, as the reference's are; a spec
    equals the reference's and the tuple of its entries."""
    assert P(("data",), None) == RefP(("data",), None) == ("data", None)
    assert RefP(("pod", "data"), "model") == P(("pod", "data"), "model")
    assert P("model", None) != P("model")


def test_named_sharding_local_shape_and_refusals():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert NamedSharding(mesh, P("data", "model")).local_shape((6, 8)) == (
        3, 2)
    assert NamedSharding(mesh, P(("data", "model"))).local_shape((16,)) == (
        2,)
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, P("model")).local_shape((6,))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, P("model", "model")).local_shape((8, 8))


def test_shard_checks_local_shapes_inside_the_context_only():
    """``shard`` returns its input; inside ``sharding_ctx`` a local shape
    that does not hold the global one under the spec raises."""
    x = torch.zeros(2, 3, 4)
    assert shard(x, "batch", None, "heads", full=(None, None, 99)) is x
    mesh = AbstractMesh((2, 4), ("data", "model"))
    with sharding_ctx(default_rules(), mesh):
        assert shard(x, "batch", None, "heads", full=(None, None, 16)) is x
        with pytest.raises(ValueError, match="does not hold"):
            shard(x, "batch", None, "heads", full=(None, None, 8))
    with sharding_ctx(default_rules(True), mesh):
        with pytest.raises(ValueError, match="pod"):
            shard(x, "batch", None, None)


def test_production_mesh_names_the_ranks_it_needs():
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            make_production_mesh(multi_pod=multi_pod)


def test_largest_pow2():
    assert [largest_pow2(n) for n in (1, 2, 3, 6, 8, 255, 256)] == [
        1, 2, 2, 4, 8, 128, 256]


# ---------------------------------------------------------------------------
# param_specs / opt_state_specs for every arch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, reduced, tp, multi_pod):
    cfg, rcfg = _cfg(arch, reduced)
    want = convert.param_specs_from_jax(_ref_tuples(ref_M.param_specs(
        rcfg, RefRuntime(tp=tp), rules=ref_rules(multi_pod))), cfg)
    got = M.param_specs(cfg, Runtime(tp=tp), rules=default_rules(multi_pod))
    got_flat = dict(leaves_with_paths(got, is_leaf=is_spec))
    want_flat = dict(leaves_with_paths(want, is_leaf=is_spec))
    assert got_flat.keys() == want_flat.keys()
    for path, spec in got_flat.items():
        assert isinstance(spec, P)
        assert tuple(spec) == tuple(want_flat[path]), path
    # and the shapes those specs split: init_params on the meta device
    shapes = dict(leaves_with_paths(M.init_params(cfg, Runtime(tp=tp),
                                                  device="meta")))
    assert shapes.keys() == got_flat.keys()
    for path, t in shapes.items():
        assert len(got_flat[path]) == t.ndim, path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_match_the_reference(arch):
    cfg, rcfg = _cfg(arch, False)
    ref = ref_opt_state_specs(ref_M.param_specs(rcfg, RefRuntime(tp=16)))
    got = opt_state_specs(M.param_specs(cfg, Runtime(tp=16)))
    assert set(got) == set(ref) == {"m", "v", "step"}
    assert got["step"] == P() == ref["step"]
    for k in ("m", "v"):
        want = convert.param_specs_from_jax(_ref_tuples(ref[k]), cfg)
        assert dict(leaves_with_paths(got[k], is_leaf=is_spec)) == dict(
            leaves_with_paths(want, is_leaf=is_spec))


# ---------------------------------------------------------------------------
# zero1_specs / spec_bytes_per_device on the production meshes
# ---------------------------------------------------------------------------
def _ref_abstract(rcfg, multi_pod):
    shape_r, names = MESHES[multi_pod]
    rmesh = RefAbstractMesh(shape_r, names)
    rules = ref_rules(multi_pod)
    return ref_steps.abstract_params(rcfg, RefRuntime(tp=16, mesh=rmesh),
                                     rmesh, rules)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_and_bytes_match_the_reference(arch, multi_pod):
    """The same inputs (the reference's stacked shapes and specs, as meta
    tensors and the port's P) give the reference's ZeRO-1 specs and bytes
    per device exactly; and the port's own per-layer tree holds the
    reference's parameter bytes per device."""
    cfg, rcfg = _cfg(arch, False)
    structs, specs = _ref_abstract(rcfg, multi_pod)
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    want_z = ref_sharding.zero1_specs(specs, structs, rmesh, batch_axes)
    want_b = ref_sharding.spec_bytes_per_device(structs, specs, rmesh)
    want_zb = ref_sharding.spec_bytes_per_device(structs, want_z, rmesh)
    meta = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype.name), device="meta"), structs)
    port_specs = jax.tree.map(lambda s: P(*s), specs, is_leaf=_is_ref_spec)
    got_z = zero1_specs(port_specs, meta, mesh, batch_axes)
    assert [tuple(s) for s in tree_leaves(got_z, is_leaf=is_spec)] == [
        tuple(s) for s in jax.tree.leaves(want_z, is_leaf=_is_ref_spec)]
    assert spec_bytes_per_device(meta, port_specs, mesh) == want_b
    assert spec_bytes_per_device(meta, got_z, mesh) == want_zb
    # the port's layout: layers one by one, none of them split by layer
    own = M.param_specs(cfg, Runtime(tp=16), rules=default_rules(multi_pod))
    own_shapes = M.init_params(cfg, Runtime(tp=16), device="meta")
    assert spec_bytes_per_device(own_shapes, own, mesh) == want_b


# ---------------------------------------------------------------------------
# rules_for_shape / input_specs
# ---------------------------------------------------------------------------
def _cases():
    return [(arch, s.name, mp) for arch in ARCH_IDS
            for s in applicable_shapes(ref_get_config(arch))
            for mp in (False, True)]


def _abstract(leaf):
    """(shape, dtype name, spec) of a reference ShapeDtypeStruct"""
    return convert.AbstractLeaf(tuple(leaf.shape), leaf.dtype.name,
                                tuple(leaf.sharding.spec))


def _port(t):
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."),
            tuple(t.spec), t.sharding.spec)


def _ref_tree(tree, cfg, layout):
    ab = jax.tree.map(_abstract, tree)
    if layout is None:
        return ab
    return convert.abstract_from_jax(ab, cfg, layout)


@pytest.mark.parametrize("arch,shape_name,multi_pod", _cases())
def test_rules_and_input_specs_match_the_reference(arch, shape_name,
                                                   multi_pod):
    cfg, rcfg = _cfg(arch, False)
    shape = SHAPES_BY_NAME[shape_name]
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    ref_r = ref_steps.rules_for_shape(shape, multi_pod, rmesh)
    rules = steps.rules_for_shape(shape, multi_pod, mesh)
    assert dict(rules.rules) == dict(ref_r.rules)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    (ref_args, _) = ref_steps.input_specs(
        rcfg, shape, RefRuntime(tp=16, mesh=rmesh, batch_axes=batch_axes),
        rmesh, ref_r)
    (args, kw) = steps.input_specs(
        cfg, shape, Runtime(tp=16, batch_axes=batch_axes), mesh, rules)
    assert kw == {}
    if shape.kind == "train":
        (rstate, rbatch), (state, batch) = ref_args, args
        pairs = [(_ref_tree(rstate["params"], cfg, "params"),
                  state["params"], False),
                 (_ref_tree(rstate["opt"]["m"], cfg, "params"),
                  state["opt"]["m"], True),
                 (_ref_tree(rstate["opt"]["v"], cfg, "params"),
                  state["opt"]["v"], True),
                 (_ref_tree(rstate["opt"]["step"], cfg, None),
                  state["opt"]["step"], False),
                 (_ref_tree(rbatch, cfg, None), batch, False)]
    elif shape.kind == "prefill":
        pairs = [(_ref_tree(ref_args[0], cfg, "params"), args[0], False),
                 (_ref_tree(ref_args[1], cfg, None), args[1], False)]
    else:
        pairs = [(_ref_tree(ref_args[0], cfg, "params"), args[0], False),
                 (_ref_tree(ref_args[1], cfg, None), args[1], False),
                 (_ref_tree(ref_args[2], cfg, None), args[2], False),
                 (_ref_tree(ref_args[3], cfg, "decode_state"), args[3],
                  False)]
    p_specs = dict(leaves_with_paths(M.param_specs(cfg, Runtime(tp=16),
                                                   rules=rules),
                                     is_leaf=is_spec))
    for want, got, moments in pairs:
        want = dict(leaves_with_paths(want))
        got = dict(leaves_with_paths(got))
        assert want.keys() == got.keys()
        for path, w in want.items():
            shape_g, dtype_g, spec_g, bound = _port(got[path])
            assert (shape_g, dtype_g) == (w.shape, w.dtype), path
            assert bound == spec_g
            if moments and tuple(spec_g) != tuple(w.spec):
                # ZeRO-1 upgrades each leaf's first divisible unsplit dim:
                # the reference's stacked leaf can take its layer dim where
                # the port's per-layer leaf takes the next one
                up = zero1_specs(p_specs[path], _sds(shape_g), mesh,
                                 batch_axes)
                assert tuple(spec_g) == tuple(up), path
                assert tuple(w.spec) == tuple(p_specs[path]), path
            else:
                assert tuple(spec_g) == tuple(w.spec), path


# ---------------------------------------------------------------------------
# the decode cache split over the sequence; whole moments (zero1=False)
# ---------------------------------------------------------------------------
#: the archs whose self (or latent) cache the split takes at tp = 16: the
#: kv heads do not divide over model (8 of them), and MLA's latent cache
SEQ_SPLIT_ARCHS = {"dbrx-132b", "stablelm-12b", "qwen2.5-14b",
                   "deepseek-coder-33b", "llama-3.2-vision-11b",
                   "deepseek-v3-671b"}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_split_decode_state_specs_match_the_reference(arch, multi_pod):
    """``decode_state_specs(cfg, Runtime(tp=16, decode_cache_shard="seq"),
    128, 32768)`` equals the reference's (spec mode, no devices), leaf for
    leaf in the port's layout; the sequence dim takes ``model`` in exactly
    SEQ_SPLIT_ARCHS, and every other spec is the unsplit state's."""
    from repro.models import decode as ref_D
    from repro_torch.models import decode as D
    cfg, rcfg = _cfg(arch, False)
    B, M = 128, 32768
    rrt = RefRuntime(tp=16, decode_cache_shard="seq")
    shapes = jax.eval_shape(lambda: ref_D.init_decode_state(rcfg, rrt, B, M))
    specs = ref_D.decode_state_specs(rcfg, rrt, B, M,
                                     rules=ref_rules(multi_pod))
    leaves = jax.tree.map(
        lambda s, sp: convert.AbstractLeaf(tuple(s.shape), s.dtype.name,
                                           tuple(sp)),
        shapes, specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    want = dict(leaves_with_paths(convert.abstract_from_jax(
        leaves, cfg, "decode_state")))
    rt = Runtime(tp=16, decode_cache_shard="seq")
    got = dict(leaves_with_paths(D.decode_state_specs(
        cfg, rt, B, M, rules=default_rules(multi_pod)), is_leaf=is_spec))
    base = dict(leaves_with_paths(D.decode_state_specs(
        cfg, Runtime(tp=16), B, M, rules=default_rules(multi_pod)),
        is_leaf=is_spec))
    assert got.keys() == want.keys() == base.keys()
    meta = dict(leaves_with_paths(D.abstract_decode_state(cfg, rt, B, M)))
    split = set()
    for path, spec in got.items():
        assert tuple(spec) == tuple(want[path].spec), path
        assert tuple(meta[path].shape) == want[path].shape, path
        if tuple(spec) != tuple(base[path]):
            split.add(path)
            seq = (2 if path.startswith(("layers/", "self/")) else None)
            assert spec[seq] == "model" and base[path][seq] is None, path
    assert bool(split) == (arch in SEQ_SPLIT_ARCHS), split
    assert all(p.startswith(("layers/", "self/")) for p in split)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_split_decode_input_specs_match_the_reference(arch, multi_pod):
    """The decode_32k cell's abstract decode state under
    ``decode_cache_shard="seq"``: the reference's ``input_specs`` (shapes,
    dtypes, specs) in the port's layout, and bound to the mesh."""
    cfg, rcfg = _cfg(arch, False)
    shape = SHAPES_BY_NAME["decode_32k"]
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    rules = steps.rules_for_shape(shape, multi_pod, mesh)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    (ref_args, _) = ref_steps.input_specs(
        rcfg, shape, RefRuntime(tp=16, mesh=rmesh, batch_axes=batch_axes,
                                decode_cache_shard="seq"),
        rmesh, ref_steps.rules_for_shape(shape, multi_pod, rmesh))
    (args, _) = steps.input_specs(
        cfg, shape, Runtime(tp=16, batch_axes=batch_axes,
                            decode_cache_shard="seq"), mesh, rules)
    want = dict(leaves_with_paths(_ref_tree(ref_args[3], cfg,
                                            "decode_state")))
    got = dict(leaves_with_paths(args[3]))
    assert want.keys() == got.keys()
    for path, w in want.items():
        shape_g, dtype_g, spec_g, bound = _port(got[path])
        assert (shape_g, dtype_g, tuple(spec_g)) == (w.shape, w.dtype,
                                                     tuple(w.spec)), path
        assert bound == spec_g


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_whole_moment_specs_match_the_reference(arch, multi_pod):
    """``abstract_state(zero1=False)``: the moments take the parameters'
    specs, as the reference's do, leaf for leaf (shapes, f32, specs)."""
    cfg, rcfg = _cfg(arch, False)
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    rules = default_rules(multi_pod)
    ref_state = ref_steps.abstract_state(
        rcfg, RefRuntime(tp=16, mesh=rmesh), rmesh, ref_rules(multi_pod),
        zero1=False)
    state = steps.abstract_state(cfg, Runtime(tp=16), mesh, rules,
                                 zero1=False)
    p_specs = dict(leaves_with_paths(M.param_specs(cfg, Runtime(tp=16),
                                                   rules=rules),
                                     is_leaf=is_spec))
    for k in ("m", "v"):
        want = dict(leaves_with_paths(_ref_tree(ref_state["opt"][k], cfg,
                                                "params")))
        got = dict(leaves_with_paths(state["opt"][k]))
        assert want.keys() == got.keys() == p_specs.keys()
        for path, w in want.items():
            shape_g, dtype_g, spec_g, _ = _port(got[path])
            assert (shape_g, dtype_g) == (w.shape, w.dtype) == (
                w.shape, "float32"), path
            assert tuple(spec_g) == tuple(w.spec) == tuple(p_specs[path])


# ---------------------------------------------------------------------------
# the ep2d rules (--moe-ep2d: the expert ffn stored over data) on train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_ep2d_train_state_specs_match_the_reference(arch, multi_pod):
    """Under the rules ``--moe-ep2d`` installs (``expert_ff -> data``):
    ``train_state_shardings(zero1=False)`` binds the moments to the specs
    of the reference's ``abstract_state(zero1=False)``, leaf for leaf, the
    expert ffn split over data among them; with ZeRO-1 both sides raise
    (the reference's DuplicateSpecError, the port's ValueError naming the
    leaf and the axis)."""
    cfg, rcfg = _cfg(arch, False)
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    rrules = ref_rules(multi_pod)
    rrules = type(rrules)(rules={**rrules.rules, "expert_ff": "data"})
    rules = default_rules(multi_pod)
    rules = type(rules)(rules={**rules.rules, "expert_ff": "data"})
    rt = Runtime(tp=16, mesh=mesh, batch_axes=batch_axes)
    ref_state = ref_steps.abstract_state(
        rcfg, RefRuntime(tp=16, mesh=rmesh), rmesh, rrules, zero1=False)
    sh = steps.train_state_shardings(cfg, rt, rules, zero1=False)
    split = 0
    for k in ("m", "v"):
        want = dict(leaves_with_paths(_ref_tree(ref_state["opt"][k], cfg,
                                                "params")))
        got = dict(leaves_with_paths(sh["opt"][k]))
        assert want.keys() == got.keys()
        for path, w in want.items():
            assert tuple(got[path].spec) == tuple(w.spec), path
            split += "data" in tuple(got[path].spec)
    assert split == 2 * 3 * sum(1 for p in dict(leaves_with_paths(
        sh["params"])) if p.endswith("experts/wi"))
    with pytest.raises(Exception, match="(?i)duplicate"):
        ref_steps.abstract_state(rcfg, RefRuntime(tp=16, mesh=rmesh), rmesh,
                                 rrules, zero1=True)
    with pytest.raises(ValueError, match="experts/wi.*'data' twice"):
        steps.train_state_shardings(cfg, rt, rules, zero1=True)
    with pytest.raises(ValueError, match="twice"):
        steps.abstract_state(cfg, rt, mesh, rules, zero1=True)


# ---------------------------------------------------------------------------
# the rule --seq-shard installs (seq -> model): it moves no parameter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_rule_moves_no_parameter(arch, multi_pod):
    """Under the rules the reference's ``run_cell`` installs for
    ``--seq-shard`` (``rules_for_shape`` of train_4k, then ``seq ->
    model``), each package's ``param_specs`` and ZeRO-1 moment specs equal
    its own defaults', leaf for leaf: the rule constrains the residual
    stream only."""
    cfg, rcfg = _cfg(arch, False)
    shape_r, names = MESHES[multi_pod]
    rmesh, mesh = RefAbstractMesh(shape_r, names), AbstractMesh(shape_r,
                                                                 names)
    shape = SHAPES_BY_NAME["train_4k"]
    rbase = ref_steps.rules_for_shape(shape, multi_pod, rmesh)
    rseq = type(rbase)(rules={**rbase.rules, "seq": "model"})
    base = steps.rules_for_shape(shape, multi_pod, mesh)
    seq = type(base)(rules={**base.rules, "seq": "model"})
    assert base.rules == rbase.rules
    rrt = RefRuntime(tp=16, mesh=rmesh)

    def ref_specs(rules):
        state = ref_steps.abstract_state(rcfg, rrt, rmesh, rules)
        return ([tuple(s) for s in jax.tree.leaves(ref_M.param_specs(
                    rcfg, rrt, rules=rules), is_leaf=_is_ref_spec)],
                [tuple(s.sharding.spec)
                 for s in jax.tree.leaves(state["opt"]["m"])])

    def specs(rules):
        state = steps.abstract_state(cfg, Runtime(tp=16), mesh, rules)
        return (dict(leaves_with_paths(M.param_specs(
                    cfg, Runtime(tp=16), rules=rules), is_leaf=is_spec)),
                {p: tuple(t.spec)
                 for p, t in leaves_with_paths(state["opt"]["m"])})

    assert ref_specs(rseq) == ref_specs(rbase)
    assert specs(seq) == specs(base)
