"""The port on eight gloo ranks (a data=2 x model=4 mesh, on the CPU): the
five cases of tests/test_distributed.py, and serving on a data=4 x model=2
mesh (two experts a rank, the prefill and decode paths), each held against
the reference's
single-device ``Runtime(tp=1, moe_impl="local")`` outputs (the oracle those
tests use; the reference's own 2 x 4 runs do not run on this jax) at their
tolerances, and against the port on one device: losses rtol 1e-5, every
gradient leaf within ``1e-4 * max|g|`` of the one-device leaf, and none of
them zero.

The reference computes in this process; the eight ranks run the port in
``tests/test_torch_distributed_worker.py`` (one ``torch.multiprocessing`` launch for
all six cases, a FileStore under ``tmp_path``), which writes what they got
for the tests below to check.
"""
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models.moe as ref_moe
from repro.launch import steps as ref_steps
from repro.models import decode as ref_D
from repro.models import model as ref_M
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import OptConfig as RefOptConfig
from repro.optim import init_opt_state as ref_init_opt

from conftest import reduced_f32

HERE = os.path.dirname(os.path.abspath(__file__))
#: the eight ranks' launch, all six cases (about 15 s here)
RUN_TIMEOUT_S = 300
TEST_TIMEOUT_S = RUN_TIMEOUT_S + 120
CASES = ("dp_tp", "ep", "train", "elastic", "elastic_dp", "ep2d", "serve",
         "dp_only")
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4


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


def _flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): np.asarray(v)
            for path, v in leaves}


def _tokens(key, cfg, B, S):
    return np.asarray(jax.random.randint(key, (B, S), 0, cfg.vocab_size))


def _reference(workdir):
    """The reference's single-device outputs; writes each case's inputs."""
    ref = {}
    rt1 = RefRuntime(tp=1, moe_impl="local")
    old = ref_moe.CAPACITY_FACTOR
    ref_moe.CAPACITY_FACTOR = 8.0
    try:
        for name, arch, seed in (("dp_tp", "qwen2.5-14b", 0),
                                 ("ep", "dbrx-132b", 1),
                                 ("train", "deepseek-v3-671b", 2),
                                 ("elastic", "stablelm-12b", 3)):
            cfg = reduced_f32(arch)
            key = jax.random.PRNGKey(seed)
            params, _ = ref_M.init_params(cfg, rt1, key)
            toks = _tokens(key, cfg, 4, 33)
            batch = {"tokens": jnp.asarray(toks)}
            ref[f"{name}/loss"] = float(ref_M.loss_fn(cfg, rt1, params,
                                                      batch)[0])
            if name == "train":
                step = jax.jit(ref_steps.make_train_step(
                    cfg, rt1, RefOptConfig(lr=1e-3)))
                state = {"params": params, "opt": ref_init_opt(params)}
                for i in range(2):
                    state, m = step(state, batch)
                    ref[f"train/step_loss/{i}"] = float(m["loss"])
            if name == "elastic":
                ref.update(_flat(params, "elastic/params/"))
            np.savez(os.path.join(workdir, f"case_{name}.npz"),
                     tokens=toks, **_flat(params, "params/"))
        cfg = reduced_f32("deepseek-v3-671b")
        key = jax.random.PRNGKey(5)
        params, _ = ref_M.init_params(cfg, rt1, key)
        toks = _tokens(key, cfg, 4, 8)
        _, st = ref_D.prefill(cfg, rt1, params, {"tokens": jnp.asarray(toks)},
                              16)
        logits, _ = ref_D.decode_step(cfg, rt1, params,
                                      jnp.asarray(toks[:, :1]),
                                      jnp.int32(8), st)
        ref["ep2d/logits"] = np.asarray(logits)
        np.savez(os.path.join(workdir, "case_ep2d.npz"), tokens=toks,
                 **_flat(params, "params/"))
        cfg = reduced_f32("dbrx-132b")
        key = jax.random.PRNGKey(6)
        params, _ = ref_M.init_params(cfg, rt1, key)
        prompt = _tokens(key, cfg, 4, 16)
        logits, _ = ref_D.prefill(cfg, rt1, params,
                                  {"tokens": jnp.asarray(prompt)}, 24)
        ref["serve/prefill_logits"] = np.asarray(logits)
        np.savez(os.path.join(workdir, "case_serve.npz"),
                 tokens=_tokens(key, cfg, 4, 33), prompt=prompt,
                 **_flat(params, "params/"))
    finally:
        ref_moe.CAPACITY_FACTOR = old
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(list(CASES), f)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference outputs, the eight ranks' outputs, the work dir)."""
    workdir = str(tmp_path_factory.mktemp("dist"))
    signal.alarm(TEST_TIMEOUT_S)
    ref = _reference(workdir)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "test_torch_distributed_worker.py"),
         workdir], env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-6000:]
    with np.load(os.path.join(workdir, "out.npz")) as z:
        got = {k: z[k] for k in z.files}
    got["workdir"] = workdir
    return ref, got


def _check_grads(got, name, one="grad_1", mesh="grad_mesh"):
    """every gradient leaf of the mesh within GRAD_SHARE * max|g| of the
    one-device leaf, and nonzero; returns the number of leaves held."""
    keys = sorted(k for k in got if k.startswith(f"{name}/{one}/"))
    assert keys
    for k in keys:
        want = got[k]
        have = got[k.replace(f"/{one}/", f"/{mesh}/")]
        assert have.shape == want.shape, k
        lim = GRAD_SHARE * np.abs(want).max()
        assert np.abs(have).max() > 0, f"{k}: zero gradient on the mesh"
        assert np.abs(have - want).max() <= lim, (
            k, float(np.abs(have - want).max()), float(lim))
    return len(keys)


def _check_loss(ref, got, name, tol):
    loss_mesh, loss_1 = float(got[f"{name}/loss_mesh"]), float(
        got[f"{name}/loss_1"])
    assert abs(loss_mesh - ref[f"{name}/loss"]) < tol, (
        loss_mesh, ref[f"{name}/loss"])
    assert abs(loss_mesh - loss_1) <= LOSS_RTOL * abs(loss_1), (
        loss_mesh, loss_1)


def test_dp_tp_equivalence(run):
    """qwen2.5-14b reduced on 2 x 4 (heads, ffn and vocab over model, its
    2 kv heads replicated) against the reference's tp=1: 2e-4."""
    ref, got = run
    assert got["mesh"].tolist() == [2, 4]
    _check_loss(ref, got, "dp_tp", 2e-4)
    assert _check_grads(got, "dp_tp") > 10


def test_moe_ep_matches_local(run):
    """dbrx-132b reduced, impl="ep" (the all-to-all over model) against the
    reference's local path, capacity factor 8 (no drops): 5e-4; the f8
    dispatch's loss within 5e-2 of the bf16 one's."""
    ref, got = run
    _check_loss(ref, got, "ep", 5e-4)
    _check_grads(got, "ep")
    assert abs(float(got["ep/loss_mesh_f8"]) - float(got["ep/loss_mesh"])
               ) < 5e-2


def test_distributed_train_step_runs_and_grads_flow(run):
    """deepseek-v3-671b reduced (MLA, shared experts, MTP), two ZeRO-1
    train steps on 2 x 4: finite and changing losses, within 5e-4 of the
    reference's two tp=1 steps and rtol 1e-5 of the port's on one device;
    the gradients at the start and the parameters after two steps against
    one device's."""
    ref, got = run
    losses = [float(got[f"train/step_loss_mesh/{i}"]) for i in range(2)]
    assert all(np.isfinite(losses)) and losses[1] != losses[0]
    for i, loss in enumerate(losses):
        assert abs(loss - ref[f"train/step_loss/{i}"]) < 5e-4
        one = float(got[f"train/step_loss_1/{i}"])
        assert abs(loss - one) <= LOSS_RTOL * abs(one)
        gn1, gnm = (float(got[f"train/grad_norm_{w}/{i}"])
                    for w in ("1", "mesh"))
        assert abs(gnm - gn1) <= LOSS_RTOL * gn1
    _check_loss(ref, got, "train", 5e-4)
    _check_grads(got, "train")
    for i in range(2):   # int8 compression, at the whole tensors' scales
        one = float(got[f"train/int8_loss_1/{i}"])
        assert abs(float(got[f"train/int8_loss_mesh/{i}"]) - one) <= (
            LOSS_RTOL * abs(one))
    n = 0
    for k in got:
        if k.startswith("train/params_1/"):
            want, have = got[k], got[k.replace("params_1", "params_mesh")]
            assert np.abs(have - want).max() <= 1e-5 * np.abs(want).max(), k
            n += 1
    assert n > 10


def test_elastic_restore_smaller_mesh(run):
    """stablelm-12b reduced saved on 2 x 4, restored onto 1 x 4 after two
    of eight ranks are lost: the reference's parameters back (allclose),
    the loss within 2e-4 of the reference's and rtol 1e-5 of one device's,
    the gradients against one device's; a state one ZeRO-1 step on comes
    back bit for bit, moments included."""
    ref, got = run
    assert int(got["elastic/restored_step"]) == 5
    assert int(got["elastic/restored_tp"]) == 4
    assert got["elastic/small_mesh"].tolist() == [1, 4]
    loss = float(got["elastic/loss_small"])
    assert np.isfinite(loss)
    assert abs(loss - ref["elastic/loss"]) < 2e-4
    one = float(got["elastic/loss_1"])
    assert abs(loss - one) <= LOSS_RTOL * abs(one)
    _check_grads(got, "elastic", mesh="grad_small")
    # the port's tree holds the reference's stacked layers one by one
    from repro_torch import convert
    from repro_torch.configs import get_config
    import dataclasses
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(),
                              dtype="float32")
    tree = {}
    for k, v in ref.items():
        if k.startswith("elastic/params/"):
            node = tree
            *head, last = k[len("elastic/params/"):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    want = convert.params_from_jax(tree, cfg, device="cpu")
    from repro_torch.tree import leaves_with_paths
    for path, leaf in leaves_with_paths(want):
        np.testing.assert_allclose(got[f"elastic/params_small/{path}"],
                                   leaf.numpy())
    assert bool(got["elastic/stepped_bit_for_bit"])
    assert bool(got["elastic/restored_1x1_bit_for_bit"])


def test_elastic_restore_onto_a_data_parallel_mesh(run):
    """stablelm-12b reduced, one ZeRO-1 step with bf16 moments on a
    (data=4, model=2) mesh, saved, restored onto the (2, 2) mesh six ranks
    leave: every leaf back bit for bit in its dtype, the moments as the
    (2, 2) mesh's ZeRO-1 shards; a second step there gives one device's
    loss (rtol 1e-5) and parameters (1e-5 * max|p| a leaf)."""
    _, got = run
    assert got["elastic_dp/small_mesh"].tolist() == [2, 2]
    assert int(got["elastic_dp/restored_step"]) == 1
    assert bool(got["elastic_dp/bit_for_bit"])
    assert got["elastic_dp/moment_dtypes"].tolist() == ["torch.bfloat16"]
    assert int(got["elastic_dp/moments_split"]) > 10
    for i in range(2):
        one = float(got[f"elastic_dp/loss_1/{i}"])
        mesh = float(got[f"elastic_dp/loss_mesh/{i}"])
        assert abs(mesh - one) <= LOSS_RTOL * abs(one), (i, mesh, one)
    n = 0
    for k in got:
        if k.startswith("elastic_dp/params_1/"):
            want, have = got[k], got[k.replace("params_1", "params_mesh")]
            assert np.abs(have - want).max() <= 1e-5 * np.abs(want).max(), k
            n += 1
    assert n > 10


def test_moe_ep2d_decode_matches_local(run):
    """deepseek-v3-671b reduced, one decode step with 2D expert sharding
    (experts over model, their ffn over data) from the single-device
    prefill's state: within 5e-3 of the reference's tp=1 logits, and within
    1e-5 * max|logits| of the port's on one device."""
    ref, got = run
    logits = got["ep2d/logits_mesh"]
    assert logits.shape == ref["ep2d/logits"].shape
    assert np.abs(logits - ref["ep2d/logits"]).max() < 5e-3
    one = got["ep2d/logits_1"]
    assert np.abs(logits - one).max() <= LOSS_RTOL * np.abs(one).max()


def test_serving_on_a_4x2_mesh(run):
    """dbrx-132b reduced on a (data=4, model=2) mesh, two experts a rank:
    the loss and gradients through the all-to-all against one device; a
    prefill through impl="ep" (its kv heads split over model) within 5e-3
    of the reference's tp=1 logits, and it and two ep2d decode steps
    within 1e-5 * max|logits| of the port's on one device."""
    ref, got = run
    loss_mesh, loss_1 = (float(got[f"serve/loss_{w}"]) for w in ("mesh",
                                                                   "1"))
    assert abs(loss_mesh - loss_1) <= LOSS_RTOL * abs(loss_1)
    _check_grads(got, "serve")
    assert np.abs(got["serve/logits_mesh/0"]
                  - ref["serve/prefill_logits"]).max() < 5e-3
    for i in range(3):
        one, mesh = got[f"serve/logits_1/{i}"], got[f"serve/logits_mesh/{i}"]
        assert mesh.shape == one.shape
        assert np.abs(mesh - one).max() <= LOSS_RTOL * np.abs(one).max(), i


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_data_parallel_only_families(run, arch):
    """The families whose tp > 1 forward is ROADMAP item 8 run
    data-parallel: reduced, on a (data=8, model=1) mesh, the loss rtol
    1e-5 of one device's and every gradient leaf within 1e-4 * max|g|."""
    _, got = run
    one = float(got[f"dp_only/{arch}/loss_1"])
    assert abs(float(got[f"dp_only/{arch}/loss_mesh"]) - one) <= (
        LOSS_RTOL * abs(one))
    assert _check_grads(got, f"dp_only/{arch}") > 5


def test_a_2x4_checkpoint_restores_in_the_reference(run):
    """The elastic case's checkpoint, saved from 2 x 4 (each leaf gathered,
    the mesh's first rank writing the one ``state.npz`` layout): its
    parameters, stacked back into the reference's layout, give the
    reference's loss on the reference's own parameters."""
    ref, got = run
    path = os.path.join(got["workdir"], "ckpt", "step_5", "state.npz")
    cfg = reduced_f32("stablelm-12b")
    with np.load(path) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    layers = [{} for _ in range(cfg.n_layers)]
    tree = {}
    for k, v in flat.items():
        head, *rest = k.split("/")
        node = layers[int(rest[0])] if head == "layers" else tree
        keys = rest[1:] if head == "layers" else [head] + rest
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    tree["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    toks = jnp.asarray(np.load(os.path.join(got["workdir"],
                                            "case_elastic.npz"))["tokens"])
    loss = float(ref_M.loss_fn(cfg, RefRuntime(tp=1, moe_impl="local"),
                               jax.tree.map(jnp.asarray, tree),
                               {"tokens": toks})[0])
    assert abs(loss - ref["elastic/loss"]) <= 1e-6, (loss, ref["elastic/loss"])
