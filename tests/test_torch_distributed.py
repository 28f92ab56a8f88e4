"""The port on eight gloo ranks (a data=2 x model=4 mesh, on the CPU): the
five cases of tests/test_distributed.py, serving on a data=4 x model=2
mesh (two experts a rank, the prefill and decode paths), the SSM, hybrid,
VLM and enc-dec families split over model (training, prefill and decode),
the decode cache split over the sequence (``decode_cache_shard="seq"``)
and the train step with whole moments (``zero1=False``), each held against
the reference's
single-device ``Runtime(tp=1, moe_impl="local")`` outputs (the oracle those
tests use; the reference's own 2 x 4 runs do not run on this jax) at their
tolerances, and against the port on one device: losses rtol 1e-5, every
gradient leaf within ``1e-4 * max|g|`` of the one-device leaf, and none of
them zero.

The reference computes in this process; the eight ranks run the port in
``tests/test_torch_distributed_worker.py`` (one ``torch.multiprocessing`` launch for
every case, a FileStore under ``tmp_path``), which writes what they got
for the tests below to check.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.launch import steps as ref_steps
from repro.models import decode as ref_D
from repro.models import model as ref_M
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import OptConfig as RefOptConfig
from repro.optim import init_opt_state as ref_init_opt

from conftest import reduced_f32

HERE = os.path.dirname(os.path.abspath(__file__))
#: the eight ranks' launch, every case (about 40 s here)
RUN_TIMEOUT_S = 300
TEST_TIMEOUT_S = RUN_TIMEOUT_S + 120
#: the SSM, hybrid, VLM and enc-dec families on the 2 x 4 mesh: case -> arch
TP_FAMILIES = {"tp_ssm": "mamba2-2.7b", "tp_hybrid": "recurrentgemma-2b",
               "tp_vlm": "llama-3.2-vision-11b",
               "tp_encdec": "seamless-m4t-large-v2"}
#: the decode cache split over the sequence: case -> arch (reduced, 2 kv
#: heads or MLA's latent cache on model = 4)
SEQ_CACHE = {"seq_gqa": "stablelm-12b", "seq_mla": "deepseek-v3-671b",
             "seq_vlm": "llama-3.2-vision-11b",
             "seq_encdec": "seamless-m4t-large-v2"}
CASES = ("dp_tp", "ep", "train", "elastic", "elastic_dp", "ep2d", "serve",
         "dp_only", *TP_FAMILIES, "tp_hybrid_padded", "pairs", *SEQ_CACHE,
         "no_zero1", "moe_local", "moe_dense", "ep2d_train", "ep2d_multi")
#: the MoE archs the local dispatch and the dense oracle run on split
#: experts (reduced: 4 experts, one a rank of model's 4), at the
#: reference's CAPACITY_FACTOR, each router skewed toward expert 0
SPLIT_EXPERT_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
#: the tp family cases' inputs: the loss's batch rows and tokens, the
#: prompt's rows and length, the decode state's length and the decode steps
TP_BATCH, TP_TOKENS, TP_PROMPT, TP_MAX_LEN, TP_STEPS = 4, 33, 16, 24, 2
#: the sequence-split cases: the cache's length (8 positions a rank of
#: model's 4), the lock-step prompt (every step inside rank 0's shard: ranks
#: 1 to 3 hold no valid row), the ragged prompts' lengths (the first ends
#: inside rank 0's shard, the second's third step writes position 8, the
#: first of rank 1's, the last ends in rank 3's; the longest a multiple of
#: 4, as the MoE's all-to-all splits a prompt over model) and the steps
SEQ_MAX_LEN, SEQ_PROMPT, SEQ_LENGTHS, SEQ_STEPS = 32, 4, (3, 6, 17, 28), 3
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
    for i, arch in enumerate(SPLIT_EXPERT_ARCHS):
        _split_expert_reference(workdir, ref, arch, 60 + i)
    for name, arch in TP_FAMILIES.items():
        _tp_family_reference(workdir, ref, name, arch)
    for name, arch in SEQ_CACHE.items():
        _seq_cache_reference(workdir, ref, name, arch)
    _tp_padded_case(workdir)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(list(CASES), f)
    return ref


def _skew(params, cfg, seed):
    """``params`` with one direction ``v`` added to every embedding row
    (0.5 against rows of norm ~0.16) and to each router's expert-0 column:
    nearly every token then routes one of its k pairs to expert 0, past
    the global capacity (1.25 x k / E of the tokens)."""
    v = np.random.default_rng(seed).standard_normal(cfg.d_model)
    v = jnp.asarray(0.5 * v / np.linalg.norm(v), jnp.float32)

    def skew(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name == "emb":
            return a + v
        if name.endswith("router"):
            return a.at[..., :, 0].add(v)
        return a
    return jax.tree_util.tree_map_with_path(skew, params)


def _split_expert_reference(workdir, ref, arch, seed):
    """The reference's tp=1 loss and gradients of ``arch`` reduced with a
    skewed router (:func:`_skew`), for ``moe_impl`` "local" at its own
    CAPACITY_FACTOR (1.25) and "dense"; writes the case's parameters and
    tokens."""
    cfg = reduced_f32(arch)
    key = jax.random.PRNGKey(seed)
    params = _skew(ref_M.init_params(cfg, RefRuntime(tp=1), key)[0], cfg,
                   seed)
    toks = _tokens(key, cfg, 4, 33)
    batch = {"tokens": jnp.asarray(toks)}
    assert ref_moe.CAPACITY_FACTOR == 1.25
    for impl in ("local", "dense"):
        rt1 = RefRuntime(tp=1, moe_impl=impl)
        loss, g = jax.value_and_grad(
            lambda p: ref_M.loss_fn(cfg, rt1, p, batch)[0])(params)
        ref[f"moe_{impl}/{arch}/loss"] = float(loss)
        ref[f"moe_{impl}/{arch}/grad"] = jax.tree.map(np.asarray, g)
    np.savez(os.path.join(workdir, f"case_moe_{arch}.npz"), tokens=toks,
             **_flat(params, "params/"))


def _tp_inputs(cfg, seed):
    """(loss batch, prompt, decode tokens) as numpy arrays: tokens and,
    for the VLM and enc-dec, a frontend at the residual stream's scale."""
    rng = np.random.default_rng(seed)

    def batch(rows, length):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, length),
                                    dtype=np.int32)}
        if cfg.frontend_seq:
            b["frontend"] = rng.standard_normal(
                (rows, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        return b

    nxt = [rng.integers(0, cfg.vocab_size, (TP_BATCH, 1), dtype=np.int32)
           for _ in range(TP_STEPS)]
    return batch(TP_BATCH, TP_TOKENS), batch(TP_BATCH, TP_PROMPT), nxt


def _save_tp_case(workdir, name, params, batch, prompt, nxt, **cfg):
    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}
    torch.save({"cfg": cfg, "params": params, "batch": tensors(batch),
                "prompt": tensors(prompt), "max_len": TP_MAX_LEN,
                "next": [torch.from_numpy(t) for t in nxt]},
               os.path.join(workdir, f"case_{name}.pt"))


def _tp_family_reference(workdir, ref, name, arch):
    """The reference's tp=1 loss, prefill and decode logits of ``arch``
    reduced (the VLM's tanh gates drawn N(0, 1), so its cross blocks
    count); the port's parameters converted from its tree."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = reduced_f32(arch)
    rt1 = RefRuntime(tp=1, moe_impl="local")
    key = jax.random.PRNGKey(20 + len(ref))
    params, _ = ref_M.init_params(cfg, rt1, key)
    if cfg.family == "vlm":
        rng = np.random.default_rng(3)
        cross = dict(params["layers"]["cross"])
        for g in ("gate_a", "gate_m"):
            cross[g] = jnp.asarray(rng.standard_normal(cross[g].shape),
                                   jnp.float32)
        params = {**params, "layers": {**params["layers"], "cross": cross}}
    batch, prompt, nxt = _tp_inputs(cfg, len(ref))
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    ref[f"{name}/loss"] = float(ref_M.loss_fn(cfg, rt1, params,
                                              jb(batch))[0])
    logits, st = ref_D.prefill(cfg, rt1, params, jb(prompt), TP_MAX_LEN)
    ref[f"{name}/logits/0"] = np.asarray(logits)
    for i, tok in enumerate(nxt):
        logits, st = ref_D.decode_step(cfg, rt1, params, jnp.asarray(tok),
                                       jnp.int32(TP_PROMPT + i), st)
        ref[f"{name}/logits/{i + 1}"] = np.asarray(logits)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    _save_tp_case(workdir, name, convert.params_from_jax(tree, tcfg,
                                                         device="cpu"),
                  batch, prompt, nxt)


def _seq_cache_reference(workdir, ref, name, arch):
    """The reference's tp=1 logits of ``arch`` reduced for a sequence-split
    case: a lock-step prompt of SEQ_PROMPT tokens and SEQ_STEPS decode
    steps at one position, and right-padded prompts of SEQ_LENGTHS tokens
    and SEQ_STEPS steps at each sequence's own position; the port's
    parameters converted from its tree; the capacity inflated as the
    worker's (no drops)."""
    old = ref_moe.CAPACITY_FACTOR
    ref_moe.CAPACITY_FACTOR = 8.0
    try:
        _seq_cache_run(workdir, ref, name, arch)
    finally:
        ref_moe.CAPACITY_FACTOR = old


def _seq_cache_run(workdir, ref, name, arch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = reduced_f32(arch)
    rt1 = RefRuntime(tp=1, moe_impl="local")
    params, _ = ref_M.init_params(cfg, rt1, jax.random.PRNGKey(40 + len(ref)))
    if cfg.family == "vlm":
        rng = np.random.default_rng(4)
        cross = dict(params["layers"]["cross"])
        for g in ("gate_a", "gate_m"):
            cross[g] = jnp.asarray(rng.standard_normal(cross[g].shape),
                                   jnp.float32)
        params = {**params, "layers": {**params["layers"], "cross": cross}}
    rng = np.random.default_rng(len(ref))
    B = len(SEQ_LENGTHS)

    def batch(length):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, length),
                                    dtype=np.int32)}
        if cfg.frontend_seq:
            b["frontend"] = rng.standard_normal(
                (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        return b

    prompt, ragged = batch(SEQ_PROMPT), batch(max(SEQ_LENGTHS))
    nxt = [rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
           for _ in range(SEQ_STEPS)]
    lengths = np.array(SEQ_LENGTHS, np.int32)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    for leg, b, lens in (("lock", prompt, None), ("ragged", ragged,
                                                  lengths)):
        logits, st = ref_D.prefill(cfg, rt1, params, jb(b), SEQ_MAX_LEN,
                                   lengths=None if lens is None
                                   else jnp.asarray(lens))
        ref[f"{name}/{leg}/logits/0"] = np.asarray(logits)
        for i, tok in enumerate(nxt):
            pos = (jnp.int32(SEQ_PROMPT + i) if lens is None
                   else jnp.asarray(lens + i))
            logits, st = ref_D.decode_step(cfg, rt1, params,
                                           jnp.asarray(tok), pos, st)
            ref[f"{name}/{leg}/logits/{i + 1}"] = np.asarray(logits)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)

    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}
    torch.save({"params": convert.params_from_jax(tree, tcfg, device="cpu"),
                "prompt": tensors(prompt), "ragged": tensors(ragged),
                "lengths": torch.from_numpy(lengths), "batch": B,
                "max_len": SEQ_MAX_LEN,
                "next": [torch.from_numpy(t) for t in nxt]},
               os.path.join(workdir, f"case_{name}.pt"))


def _tp_padded_case(workdir):
    """recurrentgemma-2b reduced with the full config's 10 q heads and its
    one kv head: at model = 4 the q heads pad to 12 (as the full config's
    pad to 16 at tp = 16); the port's parameters drawn at that padding."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    n_heads = get_config("recurrentgemma-2b").n_heads
    cfg = dataclasses.replace(reduced_f32("recurrentgemma-2b"),
                              n_heads=n_heads)
    params = M.init_params(cfg, Runtime(tp=4),
                           torch.Generator().manual_seed(9), device="cpu")
    _save_tp_case(workdir, "tp_hybrid_padded", params,
                  *_tp_inputs(cfg, 9), n_heads=n_heads)


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
    """The SSM, hybrid, VLM and enc-dec families data-parallel only:
    reduced, on a (data=8, model=1) mesh, the loss rtol 1e-5 of one
    device's and every gradient leaf within 1e-4 * max|g|."""
    _, got = run
    one = float(got[f"dp_only/{arch}/loss_1"])
    assert abs(float(got[f"dp_only/{arch}/loss_mesh"]) - one) <= (
        LOSS_RTOL * abs(one))
    assert _check_grads(got, f"dp_only/{arch}") > 5


def test_ssd_cut_is_misaligned_at_model_4():
    """The SSD's shards at model = 4 do not line up with its heads (as at
    tp = 16 at full width): ``w_in``'s columns and the conv channels cut
    into runs that are not a rank's x channels."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssm_dims
    tp = 4
    cfg = get_config("mamba2-2.7b").reduced()
    d_in, H, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    w_in, conv = 2 * d_in + 2 * G * ds + H, d_in + 2 * G * ds
    assert (w_in // tp, conv // tp, d_in // tp) == (74, 40, 32)
    assert G < tp and H % tp == 0


@pytest.mark.parametrize("name", list(TP_FAMILIES))
def test_tp_family_loss_and_grads(run, name):
    """The SSM (its w_in / conv cut across heads), the hybrid RG-LRU, the
    VLM and the enc-dec reduced on (data=2, model=4): the loss rtol 1e-5 of
    the port's on one device and within 2e-4 of the reference's tp=1 loss;
    every gradient leaf within 1e-4 * max|g| of one device's and
    nonzero."""
    ref, got = run
    _check_loss(ref, got, name, 2e-4)
    assert _check_grads(got, name) > 5


def _check_logits(got, name, ref=None):
    for i in range(1 + TP_STEPS):
        one, mesh = got[f"{name}/logits_1/{i}"], got[f"{name}/logits_mesh/{i}"]
        assert mesh.shape == one.shape == (TP_BATCH, 1, mesh.shape[-1]), i
        assert np.isfinite(mesh).all()
        assert np.abs(mesh - one).max() <= LOSS_RTOL * np.abs(one).max(), i
        if ref is not None:
            want = ref[f"{name}/logits/{i}"]
            assert np.abs(mesh - want).max() < 5e-3, i


@pytest.mark.parametrize("name", list(TP_FAMILIES))
def test_tp_family_prefill_and_decode(run, name):
    """A prefill of 16 tokens and two decode steps on (data=2, model=4),
    each rank holding its shard of the parameters and of the decode state:
    the logits within 1e-5 * max|logits| of the port's on one device, and
    within 5e-3 of the reference's tp=1 logits."""
    ref, got = run
    _check_logits(got, name, ref)


def test_recurrentgemma_padded_heads_on_model_4(run):
    """recurrentgemma-2b reduced with its full config's 10 q heads and one
    kv head, padded to 12 at model = 4 (the kv head picked by each rank's
    q heads): loss, gradients, prefill and decode against one device."""
    _, got = run
    name = "tp_hybrid_padded"
    loss_mesh, loss_1 = (float(got[f"{name}/loss_{w}"]) for w in ("mesh",
                                                                   "1"))
    assert abs(loss_mesh - loss_1) <= LOSS_RTOL * abs(loss_1)
    assert got[f"{name}/grad_1/layers/2/attn/wq"].shape[1] == 12
    assert _check_grads(got, name) > 5
    _check_logits(got, name)


@pytest.mark.parametrize("pair,which", [("gather_to", "forward"),
                                        ("gather_to", "gradient"),
                                        ("reduce_scatter_from", "forward"),
                                        ("reduce_scatter_from", "gradient")])
def test_collective_pairs_match_the_gathered_autograd(run, pair, which):
    """gather_to (all-gather forward, reduce-scatter backward) and
    reduce_scatter_from (reduce-scatter forward, all-gather backward) over
    model's four ranks against autograd through the gathered whole: each
    within 1e-6 of its scale on every rank."""
    _, got = run
    i = {("gather_to", "forward"): 0, ("gather_to", "gradient"): 1,
         ("reduce_scatter_from", "forward"): 2,
         ("reduce_scatter_from", "gradient"): 3}[(pair, which)]
    assert got["pairs/errs"][i] <= 1e-6 * float(got["pairs/scale"])


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


@pytest.mark.parametrize("leg", ["lock", "ragged"])
@pytest.mark.parametrize("name", list(SEQ_CACHE))
def test_seq_split_decode_matches_one_device(run, name, leg):
    """``decode_cache_shard="seq"`` on (data=2, model=4), the GQA, MLA,
    VLM-self and enc-dec-self caches split over model's 4 ranks (8
    positions each): a prefill and SEQ_STEPS decode steps, lock-step (ranks
    1 to 3 hold no valid row) or at each sequence's own position (ragged:
    one sequence inside rank 0's shard, one crossing into rank 1's). The
    logits within 5e-3 of the reference's tp=1 logits and within 1e-5 *
    max|logits| of the port's on one device."""
    ref, got = run
    key = f"{name}/{leg}"
    for i in range(1 + SEQ_STEPS):
        one, mesh = got[f"{key}/logits_1/{i}"], got[f"{key}/logits_mesh/{i}"]
        assert mesh.shape == one.shape == (len(SEQ_LENGTHS), 1,
                                           mesh.shape[-1]), i
        assert np.isfinite(mesh).all(), i
        assert np.abs(mesh - one).max() <= LOSS_RTOL * np.abs(one).max(), i
        assert np.abs(mesh - ref[f"{key}/logits/{i}"]).max() < 5e-3, i


@pytest.mark.parametrize("leg", ["lock", "ragged"])
@pytest.mark.parametrize("name", list(SEQ_CACHE))
def test_seq_split_cache_shards(run, name, leg):
    """Each rank's shard of the split cache: after the prefill, bit for
    bit the slice at its positions of the cache the same mesh holds
    unsplit (the prompt's rows at their local offsets, nothing else);
    after the decode steps, gathered over model, within 1e-5 * max of one
    device's cache (every leaf, the unsplit cross caches included). Both
    self-cache leaves (K and V, or the latent and its rope key) are split.
    """
    _, got = run
    key = f"{name}/{leg}"
    assert bool(got[f"{key}/prefill_shards_bit_for_bit"])
    assert int(got[f"{key}/split_leaves"]) == 2
    assert float(got[f"{key}/cache_rel_err"]) <= LOSS_RTOL


def test_whole_moment_train_step_matches_zero1(run):
    """stablelm-12b reduced (f32) on (data=2, model=4): two train steps with
    whole moments (``zero1=False``) against two ZeRO-1 steps on the same
    mesh and two on one device: losses rtol 1e-5, and every parameter leaf
    within 1e-5 * max|p|."""
    _, got = run
    for i in range(2):
        zero = float(got[f"no_zero1/loss_zero1/{i}"])
        for other in ("whole", "1"):
            have = float(got[f"no_zero1/loss_{other}/{i}"])
            assert abs(have - zero) <= LOSS_RTOL * abs(zero), (i, other)
    n = 0
    for k in got:
        if k.startswith("no_zero1/params_zero1/"):
            want = got[k]
            for other in ("whole", "1"):
                have = got[k.replace("params_zero1", f"params_{other}")]
                assert np.abs(have - want).max() <= (
                    LOSS_RTOL * np.abs(want).max()), (k, other)
            n += 1
    assert n > 10


def test_whole_moments_on_every_rank_and_restore(run):
    """The whole-moment state: every rank's moments of its parameter
    shard's shape, equal on both data rows (where ZeRO-1 splits most
    leaves over data); saved by its shardings and restored by
    ``elastic_restore(zero1=False)`` bit for bit, step included."""
    _, got = run
    assert bool(got["no_zero1/moments_whole_on_every_rank"])
    assert int(got["no_zero1/zero1_moments_split"]) > 10
    assert bool(got["no_zero1/restore_bit_for_bit"])


def _ref_grads_in_port_layout(ref, name, arch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return dict(leaves_with_paths_np(convert.params_from_jax(
        ref[f"{name}/grad"], cfg, device="cpu")))


def leaves_with_paths_np(tree):
    from repro_torch.tree import leaves_with_paths
    return [(k, v.numpy()) for k, v in leaves_with_paths(tree)]


@pytest.mark.parametrize("impl", ["local", "dense"])
@pytest.mark.parametrize("arch", SPLIT_EXPERT_ARCHS)
def test_moe_on_split_experts_matches_the_reference(run, arch, impl):
    """``moe_impl`` "local" / "dense" on (data=2, model=4), one expert a
    rank, the routers skewed and the capacity factor the reference's 1.25:
    the loss within 5e-4 of the reference's tp=1 loss and rtol 1e-5 of the
    port's on one device, every gradient leaf within 1e-4 * max|g| of one
    device's and of the reference's, and nonzero. The local dispatch drops
    pairs at the global capacity (counted on one device)."""
    ref, got = run
    name = f"moe_{impl}/{arch}"
    _check_loss(ref, got, name, 5e-4)
    assert _check_grads(got, name) > 5
    want = _ref_grads_in_port_layout(ref, name, arch)
    for path, w in want.items():
        have = got[f"{name}/grad_mesh/{path}"]
        assert np.abs(have - w).max() <= GRAD_SHARE * np.abs(w).max(), path
    if impl == "local":
        assert int(got[f"{name}/dropped_1"]) > 0


@pytest.mark.parametrize("arch", SPLIT_EXPERT_ARCHS)
def test_local_dispatch_takes_global_slots(run, arch):
    """The local block on the first MoE layer, its input the skewed
    embeddings: on the mesh (rows over data, experts over model) within
    1e-5 * max|y| of one device's on the whole batch; each data rank's
    rows alone at its own capacity and slots (the fault the global slots
    repair) differ from it by more than 1e-2 * max|y|."""
    _, got = run
    name = f"moe_local/{arch}"
    scale = float(got[f"{name}/block_scale"])
    assert float(got[f"{name}/block_mesh_err"]) <= LOSS_RTOL * scale
    assert float(got[f"{name}/block_per_rank_err"]) > 1e-2 * scale


def test_ep2d_prefill_and_whole_moment_train(run):
    """dbrx-132b reduced on (data=2, model=4) under the ep2d rules (the
    experts' ffn stored over data): a prefill through the all-to-all path
    within 5e-3 of the reference's tp=1 logits and 1e-5 * max|logits| of
    one device's; two train steps with whole moments against two on one
    device (losses rtol 1e-5, parameters 1e-5 * max|p|), the moments split
    as the parameters (the expert ffn over data), a save and
    elastic_restore bit for bit; ZeRO-1 refused naming the axis twice, as
    the reference's DuplicateSpecError; int8 compression built (its steps
    are held in tests/test_torch_seq_parallel.py)."""
    ref, got = run
    one, mesh = (got[f"ep2d_train/prefill_logits_{w}"] for w in ("1", "mesh"))
    assert mesh.shape == one.shape
    assert np.abs(mesh - one).max() <= LOSS_RTOL * np.abs(one).max()
    assert np.abs(mesh - ref["serve/prefill_logits"]).max() < 5e-3
    for i in range(2):
        one = float(got[f"ep2d_train/loss_1/{i}"])
        have = float(got[f"ep2d_train/loss_mesh/{i}"])
        assert abs(have - one) <= LOSS_RTOL * abs(one), i
    n = 0
    for k in got:
        if k.startswith("ep2d_train/params_1/"):
            want, have = got[k], got[k.replace("params_1", "params_mesh")]
            assert np.abs(have - want).max() <= 1e-5 * np.abs(want).max(), k
            n += 1
    assert n > 10
    from repro_torch.configs import get_config
    cfg = get_config("dbrx-132b").reduced()
    assert got["ep2d_train/moment_wi_shape"].tolist() == [
        cfg.n_experts // 4, cfg.d_model, cfg.d_ff // 2]
    assert bool(got["ep2d_train/moments_as_params"])
    assert bool(got["ep2d_train/restore_bit_for_bit"])
    zero1, int8 = got["ep2d_train/refusals"].tolist()
    assert zero1.startswith("ValueError") and "'data' twice" in zero1
    assert "experts/wi" in zero1
    assert int8 == ""


def test_ep2d_decode_on_a_multi_pod_mesh(run):
    """deepseek-v3-671b reduced, one ep2d decode step on (pod=2, data=2,
    model=2): the expert ffn stored over data alone, each rank taking its
    pod's half of its shard; the logits within 5e-3 of the reference's
    tp=1 logits and 1e-5 * max|logits| of one device's."""
    ref, got = run
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b").reduced()
    assert got["ep2d_multi/stored_wi_shape"].tolist() == [
        cfg.n_experts // 2, cfg.d_model, cfg.d_ff // 2]
    logits, one = got["ep2d_multi/logits_mesh"], got["ep2d_multi/logits_1"]
    assert logits.shape == one.shape == ref["ep2d/logits"].shape
    assert np.abs(logits - ref["ep2d/logits"]).max() < 5e-3
    assert np.abs(logits - one).max() <= LOSS_RTOL * np.abs(one).max()
