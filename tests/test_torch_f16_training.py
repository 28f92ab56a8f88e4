"""float16 training against the reference package on the CPU: one
``make_train_step`` step of each package from one converted state and one
batch, reduced configs in ``ModelConfig(dtype="float16")``, at the default
OptConfig.

Tolerances. The loss within rtol 1e-5 of the reference's: both packages
sum the f16 model's f32 cross-entropy in their own order (the largest gap
seen is 6.3e-6). ``grad_norm`` within rtol 1e-3: the gradients pass
through float16 activations whose last bit rounds differently where the
two packages sum in another order (the largest gap seen is 2.6e-4).
mamba2-2.7b's reference ``grad_norm`` is NaN (its SSD gradient at
128-token chunks, ``src/repro/models/ssm.py:108``; the port masks before
the exp), so there the port's is held finite and the loss alone is
compared.

The updated state, leaf by leaf, against the reference's. Adam's first
step moves each parameter by about ``lr * sign(g)``, so where a gradient
element is near 0 its sign, and so the parameter, may differ by up to
``2 lr`` before the float16 rounding: every parameter element is held
within ``2 lr`` plus one float16 rounding, and the elements outside one
rounding, and those that moved in only one package, are held to a small
share (at most 96 of 250,560 and 22 of 17,789 seen). The moments (f32, the
reference's rule for float16) hold the step's gradient, which passes
through float16 activations: each leaf within a relative distance of 0.25
of the reference's (the largest seen is 0.107, deepseek-v3-671b's MTP
shared expert; the reference's own float16 moments lie 0.112 from its f32
run there), the whole tree within 0.05 (the largest seen is 0.011).

The VLM and the enc-dec do not train on the synthetic pipeline's batch in
either package: its frontend is f32 and the model's scan carries float16,
so both steps raise. The port's ``Trainer`` casts the frontend to the
model's dtype before its step."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES_BY_NAME as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data import make_batch as ref_make_batch
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import OptConfig as RefOptConfig
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.tree import leaves_with_paths
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import steps
from repro_torch.launch.train import TrainConfig, Trainer
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig

#: the families that train in float16 in both packages, reduced
F16_TRAIN_ARCHS = ("stablelm-12b", "dbrx-132b", "deepseek-v3-671b",
                   "recurrentgemma-2b", "mamba2-2.7b")
#: the families whose step raises on the pipeline's f32 frontend
F16_CROSS_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
#: the archs whose reference gradient is NaN (module docstring)
NAN_REF_GRAD = ("mamba2-2.7b",)


def _f16(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float16"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float16"))


def _leaf_pairs(want, got):
    pairs = list(zip(leaves_with_paths(want), leaves_with_paths(got)))
    assert [a for (a, _), _ in pairs] == [b for _, (b, _) in pairs]
    for (path, a), (_, b) in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        yield path, a.double(), b.double()


def _assert_state_matches(want_state, got_state, start, cfg, lr):
    """The port's updated parameters and moments against the reference's
    (module docstring)."""
    want = convert.train_state_from_jax(
        jax.tree.map(np.asarray, want_state), cfg, device="cpu")
    n = beyond = moved_either = moved_one = 0
    starts = dict((p, t.double()) for p, t in leaves_with_paths(start))
    for path, a, b in _leaf_pairs(want["params"], got_state["params"]):
        rounding = 2.0 ** -10 * torch.maximum(a.abs(), b.abs()) + 2.0 ** -24
        err = (a - b).abs()
        assert bool((err <= 2.0001 * lr + rounding).all()), (
            path, float(err.max()))
        n += a.numel()
        beyond += int((err > rounding).sum())
        moved_w, moved_g = a != starts[path], b != starts[path]
        moved_either += int((moved_w | moved_g).sum())
        moved_one += int((moved_w ^ moved_g).sum())
    assert beyond <= 1e-3 * n, (beyond, n)
    assert moved_either > 0 and moved_one <= 1e-2 * moved_either, (
        moved_one, moved_either)
    for part in ("m", "v"):
        num = den = 0.0
        for path, a, b in _leaf_pairs(want["opt"][part],
                                      got_state["opt"][part]):
            gap, size = float((a - b).norm()), float(a.norm())
            assert gap <= 0.25 * size, (part, path, gap / size)
            num, den = num + gap ** 2, den + size ** 2
        assert num ** 0.5 <= 0.05 * den ** 0.5, (part, (num / den) ** 0.5)


def _steps(arch):
    """(reference step, its state and batch; the port's step, its state
    and batch): one converted float16 state, one batch."""
    rcfg, cfg = _f16(arch)
    params, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                      jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    ref_state = {"params": tree,
                 "opt": jax.tree.map(np.asarray,
                                     ref_adamw.init_opt_state(tree))}
    state = convert.train_state_from_jax(ref_state, cfg, device="cpu")
    batch = ref_make_batch(rcfg, REF_SHAPES["train_4k"].reduced(), step=0)
    ref_step = jax.jit(ref_steps.make_train_step(rcfg, RefRuntime(tp=1),
                                                 RefOptConfig()))
    step = steps.make_train_step(cfg, Runtime(tp=1), OptConfig())
    return (ref_step, jax.tree.map(jnp.asarray, ref_state), batch, step,
            state, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", F16_TRAIN_ARCHS)
def test_float16_train_step_matches_reference(arch):
    """The loss of one float16 step within rtol 1e-5 of the reference's,
    its grad_norm within rtol 1e-3 (finite where the reference's is NaN);
    both finite, the step counted; the updated parameters and moments held
    against the reference's where its gradient is finite (module
    docstring)."""
    ref_step, ref_state, ref_batch, step, state, batch = _steps(arch)
    start = {k: t.clone() for k, t in leaves_with_paths(state["params"])}
    want_state, want = ref_step(ref_state, ref_batch)
    got_state, got = step(state, batch)
    loss, want_loss = float(got["loss"]), float(want["loss"])
    assert math.isfinite(loss) and math.isfinite(want_loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=0)
    norm, want_norm = float(got["grad_norm"]), float(want["grad_norm"])
    assert math.isfinite(norm) and norm > 0
    if arch in NAN_REF_GRAD:
        assert math.isnan(want_norm)
    else:
        np.testing.assert_allclose(norm, want_norm, rtol=1e-3, atol=0)
        assert float(got["lr"]) == float(want["lr"]) > 0
        _assert_state_matches(want_state, got_state, start, _f16(arch)[1],
                              float(got["lr"]))
    assert int(got_state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", F16_CROSS_ARCHS)
def test_float16_cross_models_raise_on_an_f32_frontend(arch):
    """The VLM's and the enc-dec's float16 step raises in both packages on
    the pipeline's batch, whose frontend is f32."""
    ref_step, ref_state, ref_batch, step, state, batch = _steps(arch)
    assert ref_batch["frontend"].dtype == np.float32
    with pytest.raises(TypeError):
        ref_step(ref_state, ref_batch)
    with pytest.raises((TypeError, RuntimeError)):
        step(state, batch)


def test_float16_trainer_casts_the_frontend():
    """The port's Trainer hands its step the frontend in the model's dtype
    (float16), where the pipeline's batch holds it in f32."""
    _, cfg = _f16("llama-3.2-vision-11b")
    trainer = Trainer(cfg, SHAPES_BY_NAME["train_4k"].reduced(),
                      Runtime(tp=1), tcfg=TrainConfig(steps=1),
                      device="cpu")
    raw = trainer.pipeline.batch_at(0)
    assert raw["frontend"].dtype == np.float32
    batch = trainer._device_batch(0)
    assert batch["frontend"].dtype == torch.float16
    np.testing.assert_array_equal(
        batch["frontend"].float().numpy(),
        torch.from_numpy(raw["frontend"]).half().float().numpy())
