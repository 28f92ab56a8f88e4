"""repro_torch's checkpointer and restart on the CPU: the ports of
tests/test_checkpoint_restart.py (roundtrip, atomic commit, async save
with garbage collection, restart equivalence, the loss falling on the
Markov data), a bf16 leaf's bits, restore onto ``like``'s dtype, and a
background save that fails.

The training runs are reduced stablelm-12b in f32 on train_4k's reduced
shape, started from the reference package's initial state (its
``init_params`` at PRNGKey(0), zero moments), which the reference's own
tests train from. Restart equivalence is held at 1e-6 on the last loss,
as in the reference test."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.checkpoint.checkpointer import saved_dtypes
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch.train import TrainConfig, Trainer
from repro_torch.models.transformer import Runtime
from repro_torch.tree import leaves_with_paths

ARCH = "stablelm-12b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; several test workers share
    the host's cores, and torch's intra-op threads would spin against each
    other's. One thread each, restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_equal(a, b):
    pa, pb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    return ([k for k, _ in pa] == [k for k, _ in pb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(pa, pb)))


def test_save_restore_roundtrip(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones((5,), dtype=torch.int32),
                        "layers": [{"g": torch.full((2,), 3.0)},
                                   {"g": torch.full((2,), 4.0)}]},
             "step": torch.tensor(7, dtype=torch.int32)}
    save(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    out = restore(tmp_path, 7, state)
    assert tree_equal(state, out)
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    assert "nested/layers/1/g" in meta["keys"]


def test_atomic_commit_no_tmp_visible(tmp_path):
    state = {"w": torch.zeros((4,))}
    save(tmp_path, 1, state)
    save(tmp_path, 2, state)
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"step_1", "step_2"}


def test_async_checkpointer_gc(tmp_path):
    ck = Checkpointer(tmp_path, interval=1, keep=2)
    state = {"w": torch.zeros((4,))}
    for s in range(1, 6):
        ck.maybe_save(s, state)
    ck.wait()
    ck._gc()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5]
    assert ck.latest() == 5


def test_bf16_leaf_round_trips_with_its_bits(tmp_path):
    """numpy has no bf16: the leaf is stored as its bits and comes back in
    bf16 with the same bits (a NaN payload, -0.0 and a subnormal
    included)."""
    bits = torch.tensor([0x3F80, 0x8000, 0x0001, 0x7FC1, 0xC2F7, 0x4049],
                        dtype=torch.int32).to(torch.int16)
    state = {"m": bits.view(torch.bfloat16).reshape(2, 3),
             "w": torch.randn((3, 2)).bfloat16()}
    save(tmp_path, 3, state)
    out = restore(tmp_path, 3, state)
    for k in state:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16),
                           state[k].view(torch.int16))


def test_restore_takes_the_dtype_of_like(tmp_path):
    save(tmp_path, 1, {"w": torch.tensor([1.5, -2.0]).bfloat16()})
    out = restore(tmp_path, 1, {"w": torch.zeros(2)})
    assert out["w"].dtype == torch.float32
    assert out["w"].tolist() == [1.5, -2.0]
    # a None sharding places the leaf as ``like`` does (the sharded
    # restore runs in tests/test_torch_distributed.py)
    out = restore(tmp_path, 1, {"w": torch.zeros(2)}, shardings={"w": None})
    assert out["w"].dtype == torch.float32
    assert out["w"].tolist() == [1.5, -2.0]


def test_saved_dtypes_reads_each_leaf_dtype(tmp_path):
    """saved_dtypes gives every leaf's dtype as written, bf16 included,
    without loading the arrays (elastic restore reads the moments')."""
    save(tmp_path, 2, {"p": {"w": torch.zeros(3, 2)},
                       "m": [torch.zeros(4).bfloat16()],
                       "step": torch.zeros((), dtype=torch.int32)})
    assert saved_dtypes(tmp_path, 2) == {"p/w": torch.float32,
                                         "m/0": torch.bfloat16,
                                         "step": torch.int32}


def test_a_failed_background_save_raises_from_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    ck = Checkpointer(blocker, interval=1)
    assert ck.maybe_save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()      # the error is raised once


def _reference_state():
    rcfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                               dtype="float32")
    p, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                 jax.random.PRNGKey(0))
    return {"params": jax.tree.map(np.asarray, p),
            "opt": jax.tree.map(np.asarray, ref_adamw.init_opt_state(p))}


def _mk_trainer(ckpt_dir, steps, interval=2):
    """A reduced stablelm-12b Trainer on the CPU; a fresh one (no
    checkpoint to resume from) starts from the reference's initial
    state."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    shape = SHAPES_BY_NAME["train_4k"].reduced()
    tcfg = TrainConfig(steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_interval=interval, log_every=1000)
    t = Trainer(cfg, shape, Runtime(tp=1, moe_impl="local"), tcfg=tcfg,
                device="cpu")
    t.init_or_restore()
    if t.start_step == 0:
        t.state = convert.train_state_from_jax(_reference_state(), cfg,
                                               device="cpu")
    return t


def test_restart_equivalence(tmp_path):
    """Uninterrupted training == crash-and-resume, on the last loss."""
    full = _mk_trainer(str(tmp_path / "full"), steps=8).run()
    _mk_trainer(str(tmp_path / "resume"), steps=4, interval=2).run()
    # simulate a crash: a brand-new trainer restores from disk
    t_b = _mk_trainer(str(tmp_path / "resume"), steps=8, interval=2)
    out = t_b.run()
    assert t_b.start_step == 4
    assert len(out["losses"]) == 4
    np.testing.assert_allclose(out["losses"][-1], full["losses"][-1],
                               rtol=1e-6, atol=1e-6)


def test_loss_decreases_markov_data(tmp_path):
    out = _mk_trainer(None, steps=12, interval=0).run()
    first, last = out["losses"][0], np.mean(out["losses"][-3:])
    assert last < first, (first, last)
