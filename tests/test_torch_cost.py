"""The cost counter (``repro_torch.core.hlo_cost``) and the roofline's
artifact half (``repro_torch.core.roofline``) against the reference's HLO
cost model, case by case:

* the five programs of tests/test_hlo_cost.py, each through the reference
  (compiled, its HLO parsed) and through the port (its ops counted);
* ``roofline_from_artifacts`` / ``RooflineReport.to_dict`` on the same
  inputs at ``TPU_V5E``, and ``collective_bytes``, exactly;
* one prefill, train and decode step of each reduced dense config and of
  dbrx-132b reduced at tp = 1: the port's ``dot_flops`` against the
  reference's ``analyze_hlo(...).dot_flops``. Measured: the two agree to
  the flop once two sources are reckoned (below); the test holds the
  remainder within 1e-6 of the reference's count.

The sources of difference, each counted analytically:

* CE: the reference picks each label's logit by a one-hot contraction over
  the padded vocab (``einsum("bcv,bcv->bc")``, a dot of ``2 * tokens *
  V`` flops); the port gathers it (no product).
* remat: under ``remat="full"`` the port's ``torch.utils.checkpoint``
  re-runs each layer's attention forward, its q.k score product included;
  XLA's rematerialised program shares that product with the backward's, so
  the port counts one more ``2 * B * Hq * S * S * D`` a layer.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.core import roofline as ref_rl
from repro.core.hardware import TPU_V5E as REF_TPU_V5E
from repro.core.hlo_cost import analyze_hlo
from repro.launch import steps as ref_steps
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import OptConfig as RefOptConfig

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.core import roofline as rl
from repro_torch.core.hardware import H100_SXM, TPU_V5E
from repro_torch.core.hlo_cost import (CostCounter, CostTotals,
                                       analyze_step)
from repro_torch.launch import steps
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig
from repro_torch.tree import tree_map


def _ref_totals(f, *args, donate=()):
    return analyze_hlo(jax.jit(f, donate_argnums=donate).lower(*args)
                       .compile().as_text())


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py, case by case
# ---------------------------------------------------------------------------
def test_repeated_product_counts_every_iteration():
    def ref_f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=10)
        return y

    def f(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    x = jax.ShapeDtypeStruct((512, 512), jnp.float32)
    want = 10 * 2 * 512 ** 3
    assert _ref_totals(ref_f, x, x).dot_flops == pytest.approx(want,
                                                               rel=1e-6)
    t = torch.zeros(512, 512)
    got = analyze_step(f, t, t)
    assert got.dot_flops == want
    assert got.elementwise_flops == 10 * 512 * 512      # the tanh
    assert got.dot_table == {"mm [512,512]x[512,512]": want}


def test_nested_loops_compose():
    def ref_g(x, w):
        def inner(c, _):
            return c @ w, None

        def outer(c, _):
            y, _ = jax.lax.scan(inner, c, None, length=5)
            return y, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y

    def g(x, w):
        c = x
        for _ in range(3):
            for _ in range(5):
                c = c @ w
        return c

    x = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    want = 15 * 2 * 256 ** 3
    assert _ref_totals(ref_g, x, x).dot_flops == pytest.approx(want,
                                                               rel=1e-6)
    t = torch.zeros(256, 256)
    assert analyze_step(g, t, t).dot_flops == want


def test_cache_write_charged_update_not_buffer():
    """The decode path's cache write (``cache.index_copy_(1, idx, new)``,
    models/attention.py) is charged twice the update and its index, not the
    cache."""
    def ref_h(cache, upd):
        return jax.lax.dynamic_update_slice(cache, upd, (0, 5, 0))

    cache_bytes = 4 * 32768 * 128 * 2
    ref = _ref_totals(ref_h,
                      jax.ShapeDtypeStruct((4, 32768, 128), jnp.bfloat16),
                      jax.ShapeDtypeStruct((4, 1, 128), jnp.bfloat16),
                      donate=(0,))
    assert ref.bytes_accessed < cache_bytes / 100

    def h(cache, upd, idx):
        cache.index_copy_(1, idx, upd)
        return cache

    got = analyze_step(h, torch.zeros(4, 32768, 128, dtype=torch.bfloat16),
                       torch.ones(4, 1, 128, dtype=torch.bfloat16),
                       torch.tensor([5]))
    assert got.bytes_accessed < cache_bytes / 100
    assert got.bytes_accessed == 2 * 4 * 128 * 2 + 8
    assert got.bytes_table == {"index_copy_": 2 * 4 * 128 * 2 + 8}


@pytest.fixture
def fake_pair():
    """A fake process group of two ranks, this process rank 0, for the
    length of one test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    yield
    dist.destroy_process_group()


def _ref_psum_hlo():
    from jax.sharding import PartitionSpec as RP
    mesh = jax.make_mesh((1,), ("x",))
    try:
        shard_map = jax.shard_map
    except AttributeError:          # moved to jax.* after 0.4.x
        from jax.experimental.shard_map import shard_map
    sm = shard_map(lambda a: jax.lax.psum(a, "x"), mesh=mesh,
                   in_specs=RP(None, None), out_specs=RP(None, None))
    return jax.jit(sm).lower(
        jax.ShapeDtypeStruct((128, 128), jnp.float32)).compile().as_text()


def test_collective_bytes_counted(fake_pair):
    """An all-reduce of 128 x 128 f32: the port charges the wire at f32,
    4 B an element; the reference's cost model charges 2 B an element (its
    bf16-equivalent width, because CPU-XLA promotes bf16 collectives to
    f32)."""
    hlo = _ref_psum_hlo()
    ref = analyze_hlo(hlo)
    assert ref.collective_bytes.get("all-reduce") == 128 * 128 * 2
    assert ref.collective_counts.get("all-reduce") == 1

    def g(a):
        a = a.clone()
        dist.all_reduce(a)
        return a

    got = analyze_step(g, torch.zeros(128, 128))
    assert got.collective_bytes == {"all-reduce": 128 * 128 * 4}
    assert got.collective_counts == {"all-reduce": 1}
    assert got.collective_total == 128 * 128 * 4
    # the reference's roofline reads each operand's type from the op's own
    # line, which this HLO text does not print (operands are names only):
    # its dict has the port's keys and counts, and 0 bytes
    mine, theirs = rl.collective_bytes(got), ref_rl.collective_bytes(hlo)
    assert mine.keys() == theirs.keys()
    assert mine["__counts__"] == theirs["__counts__"] == {"all-reduce": 1}
    assert mine["total"] == mine["all-reduce"] == 128 * 128 * 4
    assert theirs["total"] == 0


def test_dot_flops_shape_table():
    ref = _ref_totals(lambda x, w: x @ w,
                      jax.ShapeDtypeStruct((64, 32), jnp.float32),
                      jax.ShapeDtypeStruct((32, 16), jnp.float32))
    assert ref.dot_flops == pytest.approx(2 * 64 * 32 * 16)
    assert len(ref.dot_table) == 1
    got = analyze_step(lambda x, w: x @ w, torch.zeros(64, 32),
                       torch.zeros(32, 16))
    assert got.dot_flops == 2 * 64 * 32 * 16
    assert got.dot_table == {"mm [64,32]x[32,16]": 2 * 64 * 32 * 16}


def test_collective_functional_and_gather_shards(fake_pair):
    """All-gathers are charged their local shard, reduce-scatters their
    whole operand, all-to-alls their input (an f8 payload at 1 B an
    element); the functional collectives are counted as the c10d ones."""
    import torch.distributed._functional_collectives as fc

    def g(a):
        out = a.new_empty((256, 128))
        dist.all_gather_into_tensor(out, a)
        rs = a.new_empty((64, 128))
        dist.reduce_scatter_tensor(rs, a)
        w = a.to(torch.float8_e4m3fn).view(torch.uint8)
        dist.all_to_all_single(torch.empty_like(w), w)
        return fc.all_reduce(a, "sum", dist.group.WORLD).wait()

    got = analyze_step(g, torch.zeros(128, 128))
    n = 128 * 128
    assert got.collective_bytes == {"all-gather": 4 * n,
                                    "reduce-scatter": 4 * n,
                                    "all-to-all": n, "all-reduce": 4 * n}
    assert got.collective_counts == dict.fromkeys(got.collective_bytes, 1)


def test_counter_sees_checkpoint_recompute_and_backward():
    """Under ``FakeTensorMode`` (entered first) the counter sees the
    forward, the checkpoint's recompute and the backward's products."""
    with FakeTensorMode():
        x = torch.empty(32, 64, requires_grad=True)
        w = torch.empty(64, 64, requires_grad=True)
        with CostCounter() as c:
            y = torch.utils.checkpoint.checkpoint(
                lambda a: torch.tanh(a @ w) @ w, x, use_reentrant=False)
            y.sum().backward()
    one = 2 * 32 * 64 * 64
    # forward 2, the recompute of the first (early stop: the last product's
    # output is not needed), backward 4
    assert c.totals.dot_flops == 7 * one


def test_memory_tracks_storages_by_lifetime():
    a = torch.zeros(1000)
    with CostCounter() as c:
        c.arguments(a)
        b = a * 2          # 4000 B live
        d = b + 1          # 8000 B live
        del b              # 4000 B
        e = d[:10]         # a view: no new storage
        f = d * 3          # 8000 B live again
    mem = c.memory(f)
    assert mem == {"argument_bytes": 4000, "output_bytes": 4000,
                   "temp_bytes": 8000, "generated_code_bytes": None}
    assert c.live_temp_bytes == 8000
    del d, e


def test_kernel_charges_reach_every_active_counter():
    from repro_torch.core import hlo_cost
    def never():
        raise AssertionError("work computed with no counter active")

    with CostCounter() as outer:
        hlo_cost.charge_kernel("k", lambda: (10.0, 4.0))
        with CostCounter() as inner:
            hlo_cost.charge_kernel("k", lambda: (1.0, 2.0))
    hlo_cost.charge_kernel("k", never)      # no counter: nothing computed
    assert outer.totals.dot_table == {"k": 11.0}
    assert outer.totals.bytes_table == {"k": 6.0}
    assert inner.totals.dot_flops == 1.0 and inner.kernel_launches == {
        "k": 1}
    assert outer.kernel_launches == {"k": 2}


# ---------------------------------------------------------------------------
# the roofline's artifact half
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cost,coll,chips,mf", [
    ({"flops": 3.2e15, "bytes accessed": 1.1e12}, {"total": 4.4e10}, 256,
     7.6e16),
    ({"flops": 1e9, "bytes accessed": 5e12}, {"total": 0}, 512, 2.5e11),
    ({"flops": 1e12, "bytes accessed": 1e9}, {"total": 9e12}, 1, 3e11),
    ({}, {}, 256, 1.0),
])
def test_roofline_report_matches_the_reference(cost, coll, chips, mf):
    want = ref_rl.roofline_from_artifacts(cost, coll, chips, mf,
                                          REF_TPU_V5E)
    got = rl.roofline_from_artifacts(cost, coll, chips, mf, TPU_V5E)
    assert got.to_dict() == want.to_dict()
    for name in ("dominant", "step_time_s", "useful_flops_ratio", "mfu"):
        assert getattr(got, name) == getattr(want, name)
    assert got.chip is TPU_V5E and want.chip == TPU_V5E.name


def test_roofline_mfu_reads_its_own_chip():
    """``mfu`` divides by the report's chip's peak (the reference divides
    by ``TPU_V5E``'s whatever chip priced it)."""
    r = rl.roofline_from_artifacts({"flops": 989e12}, {"total": 0}, 1,
                                   989e12)
    assert r.chip is H100_SXM
    assert r.step_time_s == 1.0 and r.mfu == 1.0
    ref = ref_rl.roofline_from_artifacts({"flops": 989e12}, {"total": 0}, 1,
                                         989e12, chip=_ref_h100())
    assert ref.mfu == pytest.approx(989e12 / REF_TPU_V5E.peak_flops)


def _ref_h100():
    from repro.core.hardware import H100_SXM as REF_H100
    return REF_H100


def test_collective_bytes_dict_shape():
    t = CostTotals(collective_bytes={"all-reduce": 8.0, "all-gather": 2.0},
                   collective_counts={"all-reduce": 2, "all-gather": 1})
    assert rl.collective_bytes(t) == {
        "all-gather": 2.0, "all-reduce": 8.0,
        "__counts__": {"all-gather": 1, "all-reduce": 2}, "total": 10.0}
    assert rl.collective_bytes(CostTotals()) == {"__counts__": {},
                                                 "total": 0}


# ---------------------------------------------------------------------------
# whole steps: the port's dot flops against the reference's parsed HLO
# ---------------------------------------------------------------------------
ARCHS = ("stablelm-12b", "qwen2.5-14b", "deepseek-coder-33b", "qwen1.5-32b",
         "dbrx-132b")
STEPS = (("prefill_32k", "none"), ("train_4k", "none"),
         ("train_4k", "full"), ("decode_32k", "none"))


def _reckoned(cfg, shape, remat: str) -> float:
    """port - reference dot flops, from the sources the module docstring
    names."""
    if shape.kind != "train":
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    ce = 2.0 * B * S * cfg.padded_vocab(1)
    score = 2.0 * B * cfg.n_heads * S * S * cfg.resolved_head_dim
    return -ce + (cfg.n_layers * score if remat == "full" else 0.0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name,remat", STEPS)
def test_step_dot_flops_match_the_reference(arch, shape_name, remat):
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    shape = SHAPES_BY_NAME[shape_name].reduced()
    rrt = RefRuntime(tp=1, remat=remat, moe_impl="local")
    rt = Runtime(tp=1, remat=remat, moe_impl="local")
    (ref_args, _) = ref_steps.input_specs(rcfg, shape, rrt, None, None)
    (args, _) = steps.input_specs(cfg, shape, rt, None, None)
    if shape.kind == "train":
        ref_fn = ref_steps.make_train_step(rcfg, rrt, RefOptConfig())
        fn = steps.make_train_step(cfg, rt, OptConfig())
    elif shape.kind == "prefill":
        ref_fn = ref_steps.make_prefill_step(rcfg, rrt, shape.seq_len)
        fn = steps.make_prefill_step(cfg, rt, shape.seq_len)
    else:
        ref_fn = ref_steps.make_decode_step(rcfg, rrt)
        fn = steps.make_decode_step(cfg, rt)
    want = _ref_totals(ref_fn, *ref_args).dot_flops

    with CostCounter() as c:
        fn(*tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), args))
    got = c.totals.dot_flops
    assert got > 0
    assert abs(got - want - _reckoned(cfg, shape, remat)) <= 1e-6 * want, (
        got, want, _reckoned(cfg, shape, remat))


# ---------------------------------------------------------------------------
# the kernels' work formulas: one for the bound, one for the charge
# ---------------------------------------------------------------------------
def _old_flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, itemsize, causal, Dv=None):
    """chip_smoke.py's flash bound as it was computed inline before the
    formula moved to kernels/flash_attention.py (the witness that no bound
    moves by a digit)."""
    Dv = D if Dv is None else Dv
    if not causal:
        entries = Sq * Skv
    elif Sq <= Skv:
        entries = Sq * (Sq + 1) // 2
    else:
        entries = Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv
    flops = 2.0 * B * Hq * entries * (D + Dv)
    byts = itemsize * (B * Sq * Hq * (D + Dv) + B * Skv * Hkv * (D + Dv))
    by_bytes = byts / 3.35e12 * 1e3
    by_ops = (3 * flops / 495e12 if itemsize == 4 else
              flops / 989e12) * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", flops, byts)


#: the shapes of PERF.md's kernel rows (B, Hq, Hkv, Sq, Skv, D, itemsize,
#: causal, Dv)
BOUND_ROWS = [(1, 40, 8, 1024, 1024, 128, 2, True, 128),
              (1, 128, 128, 1024, 1024, 192, 2, True, 128),
              (4, 10, 1, 1024, 1024, 256, 2, True, 256),
              (4, 32, 8, 1024, 1600, 128, 2, False, 128),
              (4, 32, 8, 1024, 1024, 128, 2, True, 128),
              (4, 32, 8, 1, 1600, 128, 2, False, 128),
              (4, 16, 16, 4096, 4096, 64, 2, False, 64),
              (4, 16, 16, 256, 256, 64, 2, True, 64),
              (4, 16, 16, 256, 4096, 64, 2, False, 64),
              (4, 16, 16, 1, 4096, 64, 2, False, 64),
              (4, 1, 1, 1024, 1024, 128, 4, True, 128),
              (2, 5, 5, 1000, 700, 64, 4, True, 64)]


@pytest.mark.parametrize("row", BOUND_ROWS)
def test_flash_bound_reads_the_kernels_formula(row):
    import chip_smoke
    B, Hq, Hkv, Sq, Skv, D, it, causal, Dv = row
    assert chip_smoke.flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, it, causal,
                                     Dv) == _old_flash_bound_ms(*row)


@pytest.mark.parametrize("Sq,Skv", [(5, 9), (9, 5), (128, 128), (1, 7)])
def test_attention_entries_count_the_unmasked_pairs(Sq, Skv):
    from repro_torch.kernels import flash_attention as fa
    assert fa.attention_entries(Sq, Skv, True) == sum(
        min(i + 1, Skv) for i in range(Sq))
    assert fa.attention_entries(Sq, Skv, False) == Sq * Skv


def test_flash_charge_is_the_work_the_kernel_visits():
    """The counter's charge for a launch and the tuner's candidate are one
    formula: ``2 (D + Dv)`` flops a visited entry; q and o once, each
    visited kv row once a q tile."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tuning.space import FlashAttentionSpace
    entries, kv_rows, _ = fa.flash_attention_work(1024, 1024, causal=True,
                                                  block_q=128, block_k=64)
    assert entries == 589824
    flops, byts = fa.flash_attention_cost(160, 1024, 1024, 128, 128, 2,
                                          causal=True, block_q=128,
                                          block_k=64)
    assert flops == 2.0 * 160 * entries * 256
    assert byts == 2 * 160 * (1024 * 256 + kv_rows * 256)
    need, _ = fa.attention_need(4, 40, 8, 1024, 1024, 128, 128, 2, True)
    assert need < flops <= 2.0 * 160 * 1024 * 1024 * 256
    space = FlashAttentionSpace(batch_heads=160, seq_q=1024, seq_kv=1024,
                                head_dim=128, causal=True, device="cpu")
    cand = space._candidate((("block_q", 128), ("block_k", 64)))
    assert (cand.flops, cand.hbm_bytes) == fa.flash_attention_cost(
        160, 1024, 1024, 128, 128, space.itemsize, causal=True,
        block_q=128, block_k=64)
