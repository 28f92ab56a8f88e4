"""repro_torch's training path on the CPU against the reference package:
``cross_entropy`` and ``lm_loss``; ``loss_fn`` and its gradient in every
family (reduced, f32), with ``remat`` ``"full"`` and ``"dots"`` against
``"none"``; the AdamW schedule and update; int8 compression with error
feedback; the synthetic data pipeline; one ``make_train_step`` step against
the reference's jitted one; the ``Trainer`` (governor, watchdog) and the
training CLI; ``convert.train_state_from_jax``.

Both packages start from the same numbers: the reference's parameters and
states as numpy arrays, carried across by :mod:`repro_torch.convert`;
batches from each package's ``make_batch`` (equal bit for bit, held here).

Tolerances, set from f32 (both packages sum the same terms in other
orders): losses and metrics rtol 1e-5; a gradient leaf within ``1e-4 *
max|g_ref| + 1e-6``; ``remat`` against ``"none"`` 1e-6; the optimizer's
update and schedule rtol 1e-6; a train step's new parameters within
``1e-5 * max|p|`` a leaf; the int8 quantizer and the data equal."""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st  # hypothesis, or skip-stubs

from repro.configs import SHAPES_BY_NAME as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data import make_batch as ref_make_batch
from repro.launch import steps as ref_steps
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import OptConfig as RefOptConfig
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch import convert
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.data import SyntheticPipeline, make_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import StragglerWatchdog, TrainConfig, Trainer
from repro_torch.models import common, decode, model
from repro_torch.models.transformer import Runtime
from repro_torch.optim import (OptConfig, apply_updates, global_norm,
                               init_opt_state, lr_schedule)
from repro_torch.optim import compression as comp
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; several test workers share
    the host's cores, and torch's intra-op threads would spin against each
    other's. One thread each, restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _reduced(arch, **over):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32", **over),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **over))


def _shape():
    return REF_SHAPES["train_4k"].reduced(), SHAPES_BY_NAME["train_4k"].reduced()


def _ref_params(rcfg, gates=()):
    """The reference's parameters as numpy, the VLM's tanh gates set to
    ``gates`` ((name, value) pairs): at their zero init a wrong
    cross-attention would not show."""
    p, _ = ref_model.init_params(rcfg, RefRuntime(tp=1), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), p)
    for name, value in gates:
        cross = tree["layers"]["cross"]
        cross[name] = np.full_like(cross[name], value)
    return tree


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_leaves_close(ref_tree, got_tree, cfg, rel, abs_=0.0):
    """Every leaf of ``got_tree`` (the port's layout) within ``rel *
    max|ref| + abs_`` of ``ref_tree`` (the reference's, numpy)."""
    want = convert.params_from_jax(ref_tree, cfg, device="cpu")
    pairs = list(zip(leaves_with_paths(want), leaves_with_paths(got_tree)))
    assert [a for (a, _), _ in pairs] == [b for _, (b, _) in pairs]
    for (path, a), (_, b) in pairs:
        a, b = _np(a), _np(b)
        lim = rel * float(np.abs(a).max()) + abs_
        err = float(np.abs(a - b).max())
        assert err <= lim, (path, err, lim)


# ------------------------------------------------------------- CE / lm_loss
@pytest.mark.parametrize("S", [1, 7, 100, 515])
def test_cross_entropy_matches_reference(S):
    rng = np.random.default_rng(S)
    logits = (3 * rng.standard_normal((2, S, 80))).astype(np.float32)
    labels = rng.integers(0, 72, (2, S)).astype(np.int32)
    labels[rng.random((2, S)) < 0.3] = -1
    want = ref_common.cross_entropy(logits, labels, 72)
    got = common.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 72)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("S,tied", [(100, False), (600, False), (600, True),
                                    (1280, True)])
def test_lm_loss_matches_reference(S, tied):
    """Lengths that are not multiples of CE_CHUNK (512), labels with -1,
    tied and untied embeddings; the loss and its gradient in h and in the
    head's weights."""
    rcfg, cfg = _reduced("stablelm-12b", tie_embeddings=tied)
    rng = np.random.default_rng(S)
    p = _ref_params(rcfg)
    p = {k: p[k] for k in ("emb", "ln_f", "unemb") if k in p}
    h = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    labels[rng.random((2, S)) < 0.2] = -1
    want, (want_gp, want_gh) = jax.value_and_grad(
        lambda p, h: ref_model.lm_loss(p, rcfg, h, labels),
        argnums=(0, 1))(p, h)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    th = torch.from_numpy(h).requires_grad_()
    got = model.lm_loss(tp, cfg, th, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for k, v in tp.items():
        g = np.asarray(want_gp[k])    # zeros for an unused emb
        mine = v.grad if v.grad is not None else torch.zeros_like(v)
        assert np.abs(_np(mine) - g).max() <= 1e-4 * np.abs(g).max() + 1e-6
    g = np.asarray(want_gh)
    assert np.abs(_np(th.grad) - g).max() <= 1e-4 * np.abs(g).max() + 1e-6


# ------------------------------------------------------------- loss_fn
#: the sequence length of the mamba2 comparison: at train_4k's reduced 128
#: (one SSD chunk of 128) the reference's gradient is NaN, its
#: ``where(mask, exp(decay), 0)`` overflowing exp above the diagonal (0 *
#: inf in the backward); the port masks before the exp
#: (test_ssd_gradient_is_finite_where_the_reference_overflows)
MAMBA_COMPARED_LEN = 64
#: every family reduced: (arch, moe_impl, the VLM's gates)
FAMILIES = {
    "stablelm-12b": ("stablelm-12b", "local", ()),
    "qwen2.5-14b": ("qwen2.5-14b", "local", ()),
    "dbrx-132b-local": ("dbrx-132b", "local", ()),
    "dbrx-132b-dense": ("dbrx-132b", "dense", ()),
    "deepseek-v3-671b": ("deepseek-v3-671b", "local", ()),
    "mamba2-2.7b": ("mamba2-2.7b", "local", ()),
    "recurrentgemma-2b": ("recurrentgemma-2b", "local", ()),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", "local",
                             (("gate_a", 0.8), ("gate_m", -0.6))),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", "local", ()),
}


def _port_loss_and_grads(cfg, rt, p, batch):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
    total, metrics = model.loss_fn(cfg, rt, p, batch)
    grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return total, metrics, tree_map(lambda _: next(it), p)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_fn_and_gradients_match_reference(name):
    arch, moe_impl, gates = FAMILIES[name]
    rcfg, cfg = _reduced(arch)
    rshape, _ = _shape()
    if rcfg.family == "ssm":
        rshape = dataclasses.replace(rshape, seq_len=MAMBA_COMPARED_LEN)
    tree = _ref_params(rcfg, gates)
    batch = ref_make_batch(rcfg, rshape, step=0, seed=1)
    rrt = RefRuntime(tp=1, moe_impl=moe_impl)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(rcfg, rrt, p, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), batch)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    tb = _torch_batch(batch)
    runs = {remat: _port_loss_and_grads(
        cfg, Runtime(moe_impl=moe_impl, remat=remat), params, tb)
        for remat in ("none", "full", "dots")}
    total, metrics, grads = runs["none"]
    assert sorted(metrics) == sorted(want_m)
    np.testing.assert_allclose(total.item(), float(want), rtol=LOSS_RTOL)
    for k in want_m:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert np.isfinite(total.item())
    _assert_leaves_close(jax.tree.map(np.asarray, want_g), grads, cfg,
                         rel=1e-4, abs_=1e-6)
    for remat in ("full", "dots"):
        t, m, g = runs[remat]
        np.testing.assert_allclose(t.item(), total.item(), rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(tree_leaves(g), tree_leaves(grads)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """mamba2-2.7b reduced at train_4k's reduced shape (one SSD chunk of
    128 tokens): the port's loss equals the reference's and its gradient
    is finite, and agrees with the same loss in f64 (where nothing
    overflows at this length)."""
    rcfg, cfg = _reduced("mamba2-2.7b")
    rshape, shape = _shape()
    tree = _ref_params(rcfg)
    batch = ref_make_batch(rcfg, rshape, step=0, seed=1)
    want = ref_model.loss_fn(rcfg, RefRuntime(tp=1),
                             jax.tree.map(jnp.asarray, tree), batch)[0]
    params = convert.params_from_jax(tree, cfg, device="cpu")
    total, _, grads = _port_loss_and_grads(cfg, Runtime(), params,
                                           _torch_batch(batch))
    np.testing.assert_allclose(total.item(), float(want), rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    _, _, grads64 = _port_loss_and_grads(
        cfg64, Runtime(), tree_map(lambda t: t.double(), params),
        _torch_batch(batch))
    for a, b in zip(tree_leaves(grads64), tree_leaves(grads)):
        assert float((a - b).abs().max()) <= \
            1e-4 * float(a.abs().max()) + 1e-6


def test_remat_recomputes_what_its_policy_says():
    """Counted in the backward: ``"full"`` runs each layer's forward again
    (its weight products among it), ``"dots"`` recomputes the rest but no
    weight product (2-D ``mm``), ``"none"`` recomputes nothing (the chunked
    CE's own checkpoints aside, the same in all three)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    rcfg, cfg = _reduced("stablelm-12b")
    params = convert.params_from_jax(_ref_params(rcfg), cfg, device="cpu")
    batch = _torch_batch(make_batch(cfg, _shape()[1], step=0))
    counts = {}
    for remat in ("none", "full", "dots"):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        total, _ = model.loss_fn(cfg, Runtime(remat=remat), p, batch)
        with Count() as c:
            torch.autograd.grad(total, tree_leaves(p))
        counts[remat] = c.ops
    mm, bmm, rsqrt = ({k: v.get(op, 0) for k, v in counts.items()}
                      for op in ("mm", "bmm", "rsqrt"))
    # the weight products run again under "full" only (the recompute stops
    # early at each layer's last product, whose output no backward reads)
    assert mm["full"] >= mm["none"] + 2 * 6 and mm["dots"] == mm["none"]
    # attention's batched products and each layer's two norms run again
    # under both
    assert bmm["full"] == bmm["dots"] > bmm["none"]
    assert rsqrt["full"] == rsqrt["dots"] == rsqrt["none"] + 2 * 2


def test_remat_rejects_an_unknown_policy():
    rcfg, cfg = _reduced("stablelm-12b")
    params = convert.params_from_jax(_ref_params(rcfg), cfg, device="cpu")
    batch = _torch_batch(make_batch(cfg, _shape()[1], step=0))
    with pytest.raises(ValueError, match="remat"):
        model.loss_fn(cfg, Runtime(remat="some"), params, batch)


# ------------------------------------------------------------- AdamW
@pytest.mark.parametrize("step", [0, 1, 100, 5050, 20000])
def test_lr_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, decay_steps=10_000)
    want = ref_adamw.lr_schedule(RefOptConfig(**cfg), jnp.int32(step))
    got = lr_schedule(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_tree(rng, dtype=np.float32, positive=False):
    def leaf(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return (np.abs(x) * 1e-3 if positive else x).astype(dtype)
    return {"a": leaf(8, 4), "b": leaf(5), "c": {"d": leaf(3, 2, 2)}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments):
    """One step from step 7 with nonzero moments, the gradient's norm above
    clip_norm (the clip acts): new params, m, v, grad_norm and lr."""
    rng = np.random.default_rng(3)
    mdt = jnp.bfloat16 if moments == "bfloat16" else np.float32
    params = _opt_tree(rng)
    grads = tree_map(lambda g: 5 * g, _opt_tree(rng))
    m, v = _opt_tree(rng, mdt), _opt_tree(rng, mdt, positive=True)
    cfg = dict(lr=1e-2, warmup_steps=4, decay_steps=50, clip_norm=1.0,
               moment_dtype=moments)
    want_p, want_o, want_m = ref_adamw.apply_updates(
        params, grads, {"m": m, "v": v, "step": jnp.int32(7)},
        RefOptConfig(**cfg))
    t = lambda tree: tree_map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
            common.torch_dtype(moments)) if x.dtype != np.float32
        else torch.from_numpy(x), tree)
    tp, tg = t(params), t(grads)
    got_p, got_o, got_m = apply_updates(
        tp, tg, {"m": t(m), "v": t(v),
                 "step": torch.tensor(7, dtype=torch.int32)},
        OptConfig(**cfg))
    assert float(want_m["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    assert int(got_o["step"]) == 8
    for want, got in ((want_p, got_p), (want_o["m"], got_o["m"]),
                      (want_o["v"], got_o["v"])):
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert str(b.dtype).endswith(str(np.asarray(a).dtype))
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=1e-6, atol=1e-9)
    # the update is out of place
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tp), tree_leaves(t(params))))


def test_opt_state_structure():
    """The port of tests/test_system.py's optimizer structure check."""
    params = {"a": torch.ones((4, 4)), "b": torch.zeros((3,))}
    opt = init_opt_state(params)
    assert opt["m"]["a"].dtype == torch.float32
    assert init_opt_state(params, "bfloat16")["v"]["b"].dtype == \
        torch.bfloat16
    grads = tree_map(torch.ones_like, params)
    new_p, new_opt, m = apply_updates(params, grads, opt, OptConfig(lr=0.1))
    assert int(new_opt["step"]) == 1
    assert float(m["grad_norm"]) > 0
    assert float((new_p["a"] - params["a"]).abs().max()) > 0
    assert float(global_norm(grads)) == pytest.approx(math.sqrt(19))


# ------------------------------------------------------------- compression
def test_quantize_int8_equals_reference():
    rng = np.random.default_rng(5)
    for scale in (1e-4, 1.0, 300.0):
        g = (rng.standard_normal((257,)) * scale).astype(np.float32)
        wq, ws = ref_comp.quantize_int8(g)
        q, s = comp.quantize_int8(torch.from_numpy(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert float(s) == float(ws)
        np.testing.assert_array_equal(comp.dequantize(q, s).numpy(),
                                      np.asarray(ref_comp.dequantize(wq, ws)))


def test_compress_grads_error_feedback_matches_reference():
    rng = np.random.default_rng(6)
    grads = [{"w": (rng.standard_normal((16, 8)) * 0.01).astype(np.float32),
              "b": [(rng.standard_normal((8,))).astype(np.float32)]}
             for _ in range(5)]
    werr = ref_comp.init_error_state(grads[0])
    err = comp.init_error_state(tree_map(torch.from_numpy, grads[0]))
    for g in grads:
        wg, werr = ref_comp.compress_grads(g, werr)
        cg, err = comp.compress_grads(tree_map(torch.from_numpy, g), err)
        for want, got in ((wg, cg), (werr, err)):
            tree_map(lambda b, a: np.testing.assert_allclose(
                b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9), got, want)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-4, 100.0))
def test_quantize_bounded_error(seed, scale):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64)
                         .astype(np.float32)) * scale
    q, s = comp.quantize_int8(g)
    err = float((comp.dequantize(q, s) - g).abs().max())
    assert err <= float(s) * 0.5 + 1e-9   # half-ulp of the quantizer


@pytest.mark.parametrize("seed, scale", [(600, 45.0), (600, 91.0), (5, 1.0)])
def test_quantize_takes_the_nearest_level(seed, scale):
    """No neighbouring level dequantizes nearer to g than the one taken;
    at (600, 45.0) the f32 quotient of element 62 rounds onto the half
    step 24.5 though g lies past it, toward 25."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64)
                         .astype(np.float32)) * scale
    q, s = comp.quantize_int8(g)
    err = (comp.dequantize(q, s) - g).abs()
    for step in (-1, 1):
        other = torch.clamp(q.float() + step, -127, 127) * s
        assert bool((err <= (other - g).abs()).all())


def test_error_feedback_accumulates_unbiased():
    """Sum of compressed grads -> sum of true grads (EF telescoping)."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn((32, 8), generator=gen) * 0.01 for _ in range(50)]
    err = {"w": torch.zeros((32, 8))}
    total_c = torch.zeros((32, 8))
    for g in grads:
        cg, err = comp.compress_grads({"w": g}, err)
        total_c = total_c + cg["w"]
    resid = float((total_c + err["w"] - sum(grads)).abs().max())
    assert resid < 1e-4


def test_wire_savings_accounting():
    assert comp.wire_bytes_saved({"w": torch.zeros((1000, 10))},
                                 dp_degree=2) == 10_000


def _start_from_reference(t: Trainer, arch: str) -> None:
    """``t``'s state: the reference's initial state of ``arch`` (its
    ``init_params`` at PRNGKey(0) and zero moments), as its Trainer starts
    from, with zero error feedback where ``t`` compresses."""
    rcfg, _ = _reduced(arch)
    tree = _ref_params(rcfg)
    ref = {"params": tree,
           "opt": jax.tree.map(np.asarray, ref_adamw.init_opt_state(tree))}
    if t.opt_cfg.grad_compression == "int8":
        ref["grad_error"] = jax.tree.map(np.asarray,
                                         ref_comp.init_error_state(tree))
    t.state = convert.train_state_from_jax(ref, t.cfg, device=t.device)


def test_training_converges_with_compression():
    """The port of tests/test_compression.py's convergence test, from the
    reference's initial state."""
    _, cfg = _reduced("stablelm-12b")
    t = Trainer(cfg, _shape()[1], Runtime(tp=1, moe_impl="local"),
                opt_cfg=OptConfig(grad_compression="int8"),
                tcfg=TrainConfig(steps=12, log_every=1000), device="cpu")
    t.init_or_restore()
    assert "grad_error" in t.state
    _start_from_reference(t, "stablelm-12b")
    out = t.run()
    assert np.mean(out["losses"][-3:]) < out["losses"][0]


# ------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["stablelm-12b", "llama-3.2-vision-11b"])
def test_make_batch_equals_reference(arch):
    rcfg, cfg = _reduced(arch)
    rshape, shape = _shape()
    for step, seed in ((0, 0), (7, 3), (123, 11)):
        want = ref_make_batch(rcfg, rshape, step, seed)
        got = make_batch(cfg, shape, step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    pipe = iter(SyntheticPipeline(cfg, shape, seed=3, start_step=7))
    np.testing.assert_array_equal(next(pipe)["tokens"],
                                  make_batch(cfg, shape, 7, 3)["tokens"])
    np.testing.assert_array_equal(next(pipe)["tokens"],
                                  SyntheticPipeline(cfg, shape, seed=3)
                                  .batch_at(8)["tokens"])


def test_pipeline_deterministic_across_restarts():
    _, cfg = _reduced("stablelm-12b")
    shape = _shape()[1]
    b1 = make_batch(cfg, shape, step=7, seed=3)
    b2 = make_batch(cfg, shape, step=7, seed=3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = make_batch(cfg, shape, step=8, seed=3)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_pipeline_markov_structure_learnable():
    _, cfg = _reduced("stablelm-12b")
    t = make_batch(cfg, _shape()[1], step=0)["tokens"]
    # noise band is vocab//16 -> consecutive-token relation is predictable
    diffs = (t[:, 1:] - (t[:, :-1] * 31) % cfg.vocab_size) % cfg.vocab_size
    assert int(np.max(diffs)) < max(cfg.vocab_size // 16, 2)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_step_matches_reference(compression):
    """One step of make_train_step against the reference's jitted one, from
    one converted state and batch, at the default OptConfig (the
    Trainer's). Adam's first step moves each element by about ``lr *
    sign(g)``, so an element whose gradient is near 0 may move by up to
    2 lr in one package and not the other; at the warmup's first lr (3e-6)
    that stays inside ``1e-5 * max|p|``."""
    rcfg, cfg = _reduced("stablelm-12b")
    rshape, _ = _shape()
    tree = _ref_params(rcfg)
    ref_state = {"params": tree,
                 "opt": jax.tree.map(np.asarray,
                                     ref_adamw.init_opt_state(tree))}
    if compression == "int8":
        ref_state["grad_error"] = jax.tree.map(
            np.asarray, ref_comp.init_error_state(tree))
    state = convert.train_state_from_jax(ref_state, cfg, device="cpu")
    batch = ref_make_batch(rcfg, rshape, step=0)
    kw = dict(grad_compression=compression)
    want_state, want_m = jax.jit(ref_steps.make_train_step(
        rcfg, RefRuntime(tp=1), RefOptConfig(**kw)))(
            jax.tree.map(jnp.asarray, ref_state), batch)
    got_state, got_m = steps.make_train_step(cfg, Runtime(tp=1),
                                             OptConfig(**kw))(
        state, _torch_batch(batch))
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert got_m[k].ndim == 0 and not got_m[k].requires_grad
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7)
    assert sorted(got_state) == sorted(want_state)
    _assert_leaves_close(jax.tree.map(np.asarray, want_state["params"]),
                         got_state["params"], cfg, rel=1e-5)
    if compression == "int8":
        # the residual g - Q(g) flips by a whole quantization step where a
        # gradient element sits at a rounding boundary in one package and
        # not the other (the quantizer itself is held bit for bit in
        # test_quantize_int8_equals_reference); here its structure and dtype
        want_err = convert.params_from_jax(
            jax.tree.map(np.asarray, want_state["grad_error"]), cfg,
            device="cpu")
        for (pa, a), (pb, b) in zip(leaves_with_paths(want_err),
                                    leaves_with_paths(got_state["grad_error"])):
            assert pa == pb and a.shape == b.shape
            assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    assert int(got_state["opt"]["step"]) == 1


# ------------------------------------------------------------- trainer / CLI
def test_governor_reduces_energy_vs_baseline():
    """The port of tests/test_system.py's governor test: the energy-aware
    policy never changes the numerics, and spends at most the nominal
    run's energy."""
    _, cfg = _reduced("qwen2.5-14b")
    shape = _shape()[1]
    rt = Runtime(tp=1, moe_impl="local")
    out_b = Trainer(cfg, shape, rt, tcfg=TrainConfig(
        steps=6, governor=False, log_every=100), device="cpu").run()
    t_gov = Trainer(cfg, shape, rt, tcfg=TrainConfig(
        steps=6, governor=True, log_every=100), device="cpu")
    out_g = t_gov.run()
    assert t_gov.session.policy.name == "energy-aware"
    assert out_g["energy_j"] <= out_b["energy_j"] + 1e-9
    np.testing.assert_allclose(out_b["losses"], out_g["losses"], rtol=1e-6)


def test_straggler_watchdog_flags_slow_host():
    w = StragglerWatchdog(threshold=2.0)
    for _ in range(10):
        w.record(0, 0.1)
        w.record(1, 0.1)
        w.record(2, 0.5)   # straggler
    assert w.stragglers() == [2]


def test_trainer_prices_its_step_on_the_h100():
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.roofline import model_flops
    _, cfg = _reduced("stablelm-12b")
    shape = _shape()[1]
    t = Trainer(cfg, shape, Runtime(), device="cpu")
    prof = t._step_profile()
    assert t.session.chip.spec.name == "h100-sxm"
    assert prof.compute_s == model_flops(cfg, shape) * 3 / H100_SXM.peak_flops
    assert prof.memory_s == pytest.approx(0.6 * prof.compute_s)


def test_prefill_and_decode_steps_are_the_model_functions():
    rcfg, cfg = _reduced("stablelm-12b")
    params = convert.params_from_jax(_ref_params(rcfg), cfg, device="cpu")
    tokens = torch.from_numpy(make_batch(cfg, _shape()[1], 0)["tokens"][:, :9])
    rt = Runtime()
    with torch.no_grad():
        logits, state = steps.make_prefill_step(cfg, rt, 16)(
            params, {"tokens": tokens})
        want, _ = decode.prefill(cfg, rt, params, {"tokens": tokens}, 16)
        assert torch.equal(logits, want)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        nxt, _ = steps.make_decode_step(cfg, rt)(params, tok,
                                                 torch.tensor(9), state)
        assert nxt.shape == logits.shape


def test_training_cli_on_the_host_imports_no_jax():
    """``python -m repro_torch.launch.train --device cpu --reduced --steps
    3`` in a fresh interpreter: three finite losses, and neither jax nor
    the reference package loaded."""
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['train', '--arch', 'stablelm-12b', '--reduced',\n"
        "            '--steps', '3', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "print('BAD', sorted(n for n in sys.modules if n.split('.')[0]\n"
        "                    in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "BAD []"
    final = [l for l in lines if l.startswith("final loss")]
    assert len(final) == 1 and math.isfinite(float(final[0].split()[2]))


def test_training_cli_returns_its_losses_and_needs_a_card_by_default():
    out = train_mod.main(["--reduced", "--steps", "3", "--device", "cpu",
                          "--policy", "energy-aware"])
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_mod.main(["--reduced", "--steps", "1"])


# ------------------------------------------------------------- convert
def test_train_state_from_jax_round_trips_every_leaf():
    """A reference state (params, f32 and bf16 moments, step, grad_error)
    into the port: every leaf equal, dtypes kept."""
    rcfg, cfg = _reduced("recurrentgemma-2b")
    tree = _ref_params(rcfg)
    rng = np.random.default_rng(9)
    noisy = lambda t: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), t)
    for mdt in (np.float32, jnp.bfloat16):
        ref = {"params": tree,
               "opt": {"m": jax.tree.map(lambda a: a.astype(mdt),
                                         noisy(tree)),
                       "v": jax.tree.map(lambda a: a.astype(mdt),
                                         noisy(tree)),
                       "step": np.int32(5)},
               "grad_error": noisy(tree)}
        got = convert.train_state_from_jax(ref, cfg, device="cpu")
        assert int(got["opt"]["step"]) == 5
        assert got["opt"]["step"].dtype == torch.int32
        for key, sub in (("params", ref["params"]), ("m", ref["opt"]["m"]),
                         ("v", ref["opt"]["v"]),
                         ("grad_error", ref["grad_error"])):
            mine = got["opt"][key] if key in ("m", "v") else got[key]
            want = convert.params_from_jax(sub, cfg, device="cpu")
            for (pa, a), (pb, b) in zip(leaves_with_paths(want),
                                        leaves_with_paths(mine)):
                assert pa == pb and a.dtype == b.dtype
                assert torch.equal(a, b)
            if key in ("m", "v"):
                assert all(t.dtype == (torch.bfloat16 if mdt is jnp.bfloat16
                                       else torch.float32)
                           for t in tree_leaves(mine))
