"""Sequence parallelism on eight gloo ranks (a data=2 x model=4 mesh, on
the CPU): the rule ``seq -> model`` that the reference's ``--seq-shard``
installs, under which the training trunks and the encoder keep each rank's
``S / 4`` rows of the residual stream between their blocks. Seven families
reduced (mamba2-2.7b, recurrentgemma-2b, llama-3.2-vision-11b,
seamless-m4t-large-v2, stablelm-12b, dbrx-132b through the all-to-all
path, deepseek-v3-671b with MLA, a shared expert and MTP), each held
against the port on one device (loss rtol 1e-5, every gradient leaf
within ``1e-4 * max|g|`` and nonzero, the norms' gains and the VLM's gates
among them by name), the reference's single-device ``Runtime(tp=1)``
oracle (loss within 2e-4), and the same mesh without the rule (a train
step's parameters within ``1e-5 * max|p|``); the enc-dec's prefill and
decode steps under the rule. Then int8 gradient compression on the ep2d
layout (the experts' ffn stored over data) against the ffn whole and one
device.

The reference computes in this process; the eight ranks run the port in
``tests/test_torch_distributed_worker.py``, launched once for this file's
cases.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.models import decode as ref_D
from repro.models import model as ref_M
from repro.models.transformer import Runtime as RefRuntime

from conftest import reduced_f32

HERE = os.path.dirname(os.path.abspath(__file__))
#: the eight ranks' launch for this file's cases (about 30 s here)
RUN_TIMEOUT_S = 240
TEST_TIMEOUT_S = RUN_TIMEOUT_S + 120
#: case -> arch, as tests/test_torch_distributed_worker.SEQ_PARALLEL_CASES
CASES = {"sp_ssm": "mamba2-2.7b", "sp_hybrid": "recurrentgemma-2b",
         "sp_vlm": "llama-3.2-vision-11b",
         "sp_encdec": "seamless-m4t-large-v2", "sp_dense": "stablelm-12b",
         "sp_ep": "dbrx-132b", "sp_mla": "deepseek-v3-671b"}
#: the loss's batch rows and tokens (32 inputs: 8 a rank of model's 4),
#: the prompt's length, the decode state's length and the decode steps
BATCH, TOKENS, PROMPT, MAX_LEN, STEPS = 4, 33, 16, 24, 2
#: the rows the worker cuts off the batch for the refusal: 29 inputs
CUT = 3
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
PARAM_SHARE = 1e-5
#: the step's gate on a leaf that starts at zero, in units of its max
ZERO_START_SHARE = 1e-2


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


def _inputs(cfg, seed):
    """(loss batch, prompt, decode tokens) as numpy arrays; the VLM's and
    the enc-dec's frontend at the residual stream's scale."""
    rng = np.random.default_rng(seed)

    def batch(rows, length):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, length),
                                    dtype=np.int32)}
        if cfg.frontend_seq:
            b["frontend"] = rng.standard_normal(
                (rows, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        return b

    nxt = [rng.integers(0, cfg.vocab_size, (BATCH, 1), dtype=np.int32)
           for _ in range(STEPS)]
    return batch(BATCH, TOKENS), batch(BATCH, PROMPT), nxt


def _reference(workdir, ref, name, arch, seed):
    """The reference's tp=1 loss of ``arch`` reduced (and the enc-dec's
    prefill and decode logits), at the inflated capacity the worker runs
    (no drops), the VLM's tanh gates drawn N(0, 1); writes the port's
    parameters, converted from the reference's tree, and the inputs."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = reduced_f32(arch)
    rt1 = RefRuntime(tp=1, moe_impl="local")
    params, _ = ref_M.init_params(cfg, rt1, jax.random.PRNGKey(seed))
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        cross = dict(params["layers"]["cross"])
        for g in ("gate_a", "gate_m"):
            cross[g] = jnp.asarray(rng.standard_normal(cross[g].shape),
                                   jnp.float32)
        params = {**params, "layers": {**params["layers"], "cross": cross}}
    batch, prompt, nxt = _inputs(cfg, seed)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    old = ref_moe.CAPACITY_FACTOR
    ref_moe.CAPACITY_FACTOR = 8.0
    try:
        ref[f"{name}/loss"] = float(ref_M.loss_fn(cfg, rt1, params,
                                                  jb(batch))[0])
        if cfg.family == "encdec":
            logits, st = ref_D.prefill(cfg, rt1, params, jb(prompt), MAX_LEN)
            ref[f"{name}/logits/0"] = np.asarray(logits)
            for i, tok in enumerate(nxt):
                logits, st = ref_D.decode_step(cfg, rt1, params,
                                               jnp.asarray(tok),
                                               jnp.int32(PROMPT + i), st)
                ref[f"{name}/logits/{i + 1}"] = np.asarray(logits)
    finally:
        ref_moe.CAPACITY_FACTOR = old
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)

    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}
    torch.save({"params": convert.params_from_jax(tree, tcfg, device="cpu"),
                "batch": tensors(batch), "prompt": tensors(prompt),
                "max_len": MAX_LEN,
                "next": [torch.from_numpy(t) for t in nxt]},
               os.path.join(workdir, f"case_{name}.pt"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference outputs, the eight ranks' outputs)."""
    workdir = str(tmp_path_factory.mktemp("seq"))
    signal.alarm(TEST_TIMEOUT_S)
    ref = {}
    for i, (name, arch) in enumerate(CASES.items()):
        _reference(workdir, ref, name, arch, 70 + i)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump([*CASES, "ep2d_int8"], f)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "test_torch_distributed_worker.py"),
         workdir], env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-6000:]
    with np.load(os.path.join(workdir, "out.npz")) as z:
        got = {k: z[k] for k in z.files}
    print(f"the eight ranks' launch: {time.time() - t0:.1f} s")
    return ref, got


def _grad_keys(got, name, side):
    keys = sorted(k for k in got if k.startswith(f"{name}/grad_1/"))
    assert keys
    return keys, [k.replace("/grad_1/", f"/grad_{side}/") for k in keys]


@pytest.mark.parametrize("name", list(CASES))
def test_seq_parallel_loss_matches_one_device_and_the_reference(run, name):
    """The loss under the rule rtol 1e-5 of the port's on one device and
    within 2e-4 of the reference's tp=1 loss."""
    ref, got = run
    have, one = float(got[f"{name}/loss_mesh"]), float(got[f"{name}/loss_1"])
    assert abs(have - one) <= LOSS_RTOL * abs(one), (have, one)
    assert abs(have - ref[f"{name}/loss"]) < 2e-4, (have, ref[f"{name}/loss"])


@pytest.mark.parametrize("name", list(CASES))
def test_seq_parallel_grads_match_one_device(run, name):
    """Every gradient leaf under the rule within 1e-4 * max|g| of one
    device's, and nonzero: the residual norms' gains (and the VLM's tanh
    gates), which each rank applies to its own rows only, among them by
    name."""
    _, got = run
    keys, mesh = _grad_keys(got, name, "mesh")
    for k, m in zip(keys, mesh):
        want, have = got[k], got[m]
        assert have.shape == want.shape, k
        assert np.abs(have).max() > 0, f"{k}: zero gradient under the rule"
        lim = GRAD_SHARE * np.abs(want).max()
        assert np.abs(have - want).max() <= lim, (
            k, float(np.abs(have - want).max()), float(lim))
    leaves = {k.split("/grad_1/")[1] for k in keys}
    names = {leaf.rsplit("/", 1)[-1] for leaf in leaves}
    assert "ln_f" in leaves and "ln1" in names, sorted(leaves)
    if CASES[name] != "mamba2-2.7b":
        assert "ln2" in names, sorted(leaves)
    if CASES[name] == "llama-3.2-vision-11b":
        assert {"gate_a", "gate_m", "ln_x", "ln_m"} <= names
    if CASES[name] == "seamless-m4t-large-v2":
        assert any(leaf.startswith("encoder/") and leaf.endswith("/ln1")
                   for leaf in leaves)
    if CASES[name] == "deepseek-v3-671b":
        assert {"mtp/ln_h", "mtp/ln_e", "mtp/w_proj"} <= leaves


@pytest.mark.parametrize("name", list(CASES))
def test_seq_parallel_matches_the_unsplit_mesh(run, name):
    """The same mesh without the rule: the loss rtol 1e-5 and every
    gradient leaf within 1e-4 * max|g| (a norm's gain counted once per
    rank, or tp times over, would stand out here)."""
    _, got = run
    have, whole = (float(got[f"{name}/loss_{w}"]) for w in ("mesh", "whole"))
    assert abs(have - whole) <= LOSS_RTOL * abs(whole), (have, whole)
    _, mesh = _grad_keys(got, name, "mesh")
    _, unsplit = _grad_keys(got, name, "whole")
    for m, w in zip(mesh, unsplit):
        lim = GRAD_SHARE * np.abs(got[w]).max()
        assert np.abs(got[m] - got[w]).max() <= lim, m


@pytest.mark.parametrize("name", list(CASES))
def test_seq_parallel_train_step_matches_the_unsplit_mesh(run, name):
    """One ZeRO-1 train step under the rule against the same step without
    it on the same mesh: the loss rtol 1e-5, every parameter leaf within
    1e-5 * max|p|. A leaf that starts at zero (RG-LRU's and the SSD's
    biases) holds AdamW's first update alone after the step, g / (|g| +
    eps) times the learning rate, which turns f32 rounding of an element
    whose gradient is near eps into a change of ~1e-3 of the update: such a
    leaf is held within ZERO_START_SHARE of its max instead."""
    _, got = run
    have, whole = (float(got[f"{name}/step_loss_{w}"])
                   for w in ("seq", "whole"))
    assert abs(have - whole) <= LOSS_RTOL * abs(whole)
    keys = [k for k in got if k.startswith(f"{name}/step_whole/")]
    assert len(keys) > 5
    n_zero_start = 0
    for k in keys:
        want, p = got[k], got[k.replace("/step_whole/", "/step_seq/")]
        zero_start = not np.abs(got[k.replace("/step_whole/",
                                              "/step_before/")]).any()
        n_zero_start += zero_start
        share = ZERO_START_SHARE if zero_start else PARAM_SHARE
        assert np.abs(p - want).max() <= share * np.abs(want).max(), k
    assert n_zero_start < len(keys) / 2


@pytest.mark.parametrize("name", list(CASES))
def test_seq_parallel_refuses_an_uneven_sequence(run, name):
    """29 positions do not split over model's 4 ranks: ValueError naming
    the length and the axis, nothing padded."""
    _, got = run
    msg = str(got[f"{name}/refusal"])
    assert msg.startswith("ValueError"), msg
    assert str(TOKENS - 1 - CUT) in msg and "'model'" in msg, msg


def test_seq_parallel_encdec_prefill_and_decode(run):
    """seamless-m4t-large-v2 reduced under the rule (its encoder split over
    the frames, the decoder's prefill whole, as in the reference): a
    prefill of 16 tokens and two decode steps, the logits within 1e-5 *
    max|logits| of one device's and within 5e-3 of the reference's tp=1
    logits."""
    ref, got = run
    for i in range(1 + STEPS):
        one = got[f"sp_encdec/logits_1/{i}"]
        mesh = got[f"sp_encdec/logits_mesh/{i}"]
        assert mesh.shape == one.shape == (BATCH, 1, mesh.shape[-1]), i
        assert np.isfinite(mesh).all()
        assert np.abs(mesh - one).max() <= LOSS_RTOL * np.abs(one).max(), i
        assert np.abs(mesh - ref[f"sp_encdec/logits/{i}"]).max() < 5e-3, i


def test_ep2d_int8_matches_the_whole_ffn(run):
    """dbrx-132b reduced, two whole-moment int8 train steps under the ep2d
    rules against the same steps with the experts' ffn whole: the losses
    rtol 1e-5, every parameter and error-feedback leaf within 1e-5 *
    max|p| of the leaf; the error state of the split ffn local."""
    _, got = run
    for i in range(2):
        have, whole = (float(got[f"ep2d_int8/loss_{w}/{i}"])
                       for w in ("ep2d", "whole"))
        assert abs(have - whole) <= LOSS_RTOL * abs(whole), i
    n = 0
    for kind in ("params", "error"):
        for k in [k for k in got if k.startswith(f"ep2d_int8/{kind}_whole/")]:
            want = got[k]
            have = got[k.replace(f"{kind}_whole", f"{kind}_ep2d")]
            assert np.abs(have - want).max() <= (
                PARAM_SHARE * np.abs(want).max()), k
            n += 1
    assert n > 20
    from repro_torch.configs import get_config
    cfg = get_config("dbrx-132b").reduced()
    assert got["ep2d_int8/error_wi_shape"].tolist() == [
        cfg.n_experts // 4, cfg.d_model, cfg.d_ff // 2]


def test_ep2d_int8_matches_one_device(run):
    """The same two ep2d int8 steps against the port's int8 steps on one
    device: the losses rtol 1e-5."""
    _, got = run
    for i in range(2):
        have, one = (float(got[f"ep2d_int8/loss_{w}/{i}"])
                     for w in ("ep2d", "1"))
        assert abs(have - one) <= LOSS_RTOL * abs(one), i


def test_ep2d_int8_train_step_builds_on_a_fake_world():
    """make_train_step with int8 compression and whole moments under the
    ep2d rules (the expert ffn split over data) builds, where it raised
    NotImplementedError: a fake world of 8 ranks, a 2 x 4 mesh, no data
    moved."""
    code = textwrap.dedent("""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch import steps
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import mesh_over
        from repro_torch.models.common import ShardingRules, default_rules
        from repro_torch.models.transformer import Runtime
        from repro_torch.optim import OptConfig
        fake_world(8)
        mesh = mesh_over(range(8), (2, 4), ("data", "model"))
        cfg = get_config("dbrx-132b").reduced()
        rules = ShardingRules(rules={**default_rules().rules,
                                     "expert_ff": "data"})
        rt = Runtime(tp=4, mesh=mesh, moe_impl="ep", moe_ep2d_decode=True)
        step = steps.make_train_step(
            cfg, rt, OptConfig(grad_compression="int8"), rules, zero1=False)
        print("built", callable(step))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "built True" in out.stdout
