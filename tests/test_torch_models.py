"""repro_torch.models on the CPU against the reference package's models.

Both packages run the reduced qwen2.5-14b and stablelm-12b configs in f32
on the same parameters: the reference's ``init_params`` tree, with its
zero-initialised biases and unit norm gains replaced by random values so
that those code paths carry weight, handed to the port as numpy arrays
through :func:`repro_torch.convert.params_from_jax`.

Tolerance: rtol = atol = 1e-5 on logits, caches and every building block.
The two packages multiply in different orders (XLA's dot against PyTorch's
matmul, one fused projection against an einsum) and take exp / rsqrt /
cos from different libraries, so f32 results differ in the last bits; over
two layers and a vocab projection that stays below 1e-5 on these shapes
(the largest difference seen is about 3e-6). Configs, parameter shapes and
the analytic roofline terms are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core import roofline as ref_roofline
from repro.core.hardware import CHIPS as REF_CHIPS
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, all_configs, get_config
from repro_torch.core import roofline
from repro_torch.core.hardware import CHIPS
from repro_torch.models import attention as attn
from repro_torch.models import common, decode, model
from repro_torch.models.transformer import Runtime

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2.5-14b", "stablelm-12b"]


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reduced(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, params; port cfg, params) on shared parameters."""
    rcfg, cfg = _reduced(request.param)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    rng = np.random.default_rng(1)
    layers = tree["layers"]
    for name in ("ln1", "ln2"):
        layers[name] = 1.0 + 0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32)
    tree["ln_f"] = 1.0 + 0.1 * rng.standard_normal(
        tree["ln_f"].shape).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            layers["attn"][name] = 0.1 * rng.standard_normal(
                layers["attn"][name].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    return rcfg, rparams, cfg, params


# ---------------------------------------------------------------------------
# configs, parameters, roofline terms
# ---------------------------------------------------------------------------
def test_configs_equal_the_reference():
    ref = ref_all_configs()
    ours = all_configs()
    assert set(ours) == set(ref) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(ours[arch]) == dataclasses.asdict(ref[arch])
        assert (dataclasses.asdict(ours[arch].reduced())
                == dataclasses.asdict(ref[arch].reduced()))
        assert ours[arch].param_count() == ref[arch].param_count()
        assert (ours[arch].param_count(active_only=True)
                == ref[arch].param_count(active_only=True))
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in REF_SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_terms_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape, rshape in zip(SHAPES, REF_SHAPES):
        assert roofline.model_flops(cfg, shape) == \
            ref_roofline.model_flops(rcfg, rshape)
        for chips in (1, 4, 256):
            for name in ("h100-sxm", "tpu-v5e"):
                assert roofline.memory_floor_s(
                    cfg, shape, chips, CHIPS[name]) == \
                    ref_roofline.memory_floor_s(rcfg, rshape, chips,
                                                REF_CHIPS[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    rcfg, cfg = _reduced(arch)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(cfg, Runtime(), gen, device="cpu")
    assert set(params) == set(rparams)
    for name in ("emb", "ln_f", "unemb"):
        assert tuple(params[name].shape) == rparams[name].shape
    assert len(params["layers"]) == cfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(rparams["layers"])[0]
    for path, leaf in flat:
        t = params["layers"][0]
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape[1:], path
        assert t.dtype == torch.float32
    # the draws: zero biases, unit gains, normal weights at 1/sqrt(fan-in)
    lay = params["layers"][1]
    assert torch.equal(lay["ln1"], torch.ones(cfg.d_model))
    w = lay["mlp"]["wi"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = model.init_params(cfg, Runtime(),
                              torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["emb"], params["emb"])


@pytest.mark.parametrize("family_arch", ["dbrx-132b", "deepseek-v3-671b",
                                         "mamba2-2.7b", "recurrentgemma-2b",
                                         "llama-3.2-vision-11b",
                                         "seamless-m4t-large-v2"])
def test_families_still_to_port_raise(family_arch):
    cfg = dataclasses.replace(get_config(family_arch).reduced(),
                              dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 1"):
        model.init_params(cfg, Runtime(), device="cpu")
    with pytest.raises(NotImplementedError):
        decode.init_decode_state(cfg, Runtime(), 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_rms_norm_matches():
    x, g = _normal(1, 3, 5, 64), _normal(2, 64)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # bf16 input: f32 inside, cast back, then the gain
    xb = torch.from_numpy(x).bfloat16()
    got = common.rms_norm(xb, torch.from_numpy(g).bfloat16())
    want = ref_common.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(g).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    x = _normal(3, 2, 7, 3, 16)
    for pos in (np.arange(7, dtype=np.int32)[None],
                np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 9, 10, 11, 12]],
                         np.int32)):
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _np(common.rope_freqs(16, theta)),
        np.asarray(ref_common.rope_freqs(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches(act):
    p = {k: _normal(i, *s, scale=0.2) for i, (k, s) in enumerate(
        (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16))))}
    x = _normal(9, 2, 3, 16)
    got = common.gated_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), act)
    want = ref_common.gated_mlp(p, jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", [
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=False),
    dict(causal=True, q_offset=7),
    dict(causal=False, kv_valid_len=11),
    dict(causal=True, q_offset=4, kv_valid_len=20, window=9),
])
@pytest.mark.parametrize("chunks", [(2048, 1024), (4, 8)])
def test_chunked_attention_matches(case, chunks):
    Sq = 8 if "q_offset" in case else 24
    q = _normal(11, 2, Sq, 4, 16)
    k, v = _normal(12, 2, 24, 2, 16), _normal(13, 2, 24, 2, 16)
    kw = dict(case, q_chunk=chunks[0], kv_chunk=chunks[1])
    rkw = dict(kw)
    tkw = dict(kw)
    if "kv_valid_len" in case:
        rkw["kv_valid_len"] = jnp.int32(case["kv_valid_len"])
        tkw["kv_valid_len"] = torch.tensor(case["kv_valid_len"])
    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **rkw)
    got = attn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_dense_decode_attend_matches():
    q, k, v = (_normal(20 + i, 3, n, h, 16)
               for i, (n, h) in enumerate(((1, 4), (12, 2), (12, 2))))
    for valid in (np.int32(5), np.array([1, 7, 12], np.int32)):
        got = attn._dense_decode_attend(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.as_tensor(valid), 0.25)
        want = ref_attn._dense_decode_attend(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(valid), 0.25)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
def _tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape, dtype=np.int32)


def test_forward_logits_match(pair):
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 5, 2, 13)
    want = ref_model.forward_logits(rcfg, RefRuntime(tp=1), rparams,
                                    {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(cfg, Runtime(), params,
                               {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, 12, cfg.padded_vocab(1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lengths", [None, (16, 9)])
def test_prefill_logits_and_cache_match(pair, lengths):
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 6, 2, 16)
    rl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    want, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams,
                                      {"tokens": jnp.asarray(toks)}, 24,
                                      lengths=rl)
    got, state = decode.prefill(cfg, Runtime(), params,
                                {"tokens": torch.from_numpy(toks)}, 24,
                                lengths=tl)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in ("k", "v"):
        assert tuple(state["layers"][name].shape) == \
            rstate["layers"][name].shape
        np.testing.assert_allclose(_np(state["layers"][name]),
                                   np.asarray(rstate["layers"][name]), **TOL)


def test_decode_steps_match_scalar_and_per_slot(pair):
    """Per-slot positions (slot-pool decode) after a masked prefill, then a
    lock-step scalar position, each step on the state the step before
    left; the port updates its cache in place."""
    rcfg, rparams, cfg, params = pair
    rrt, rt = RefRuntime(tp=1), Runtime()
    toks = _tokens(cfg, 7, 2, 16)
    lengths = np.array([16, 9], np.int32)
    _, rstate = ref_decode.prefill(rcfg, rrt, rparams,
                                   {"tokens": jnp.asarray(toks)}, 24,
                                   lengths=jnp.asarray(lengths))
    _, state = decode.prefill(cfg, rt, params,
                              {"tokens": torch.from_numpy(toks)}, 24,
                              lengths=torch.from_numpy(lengths))
    for i in range(3):
        tok = _tokens(cfg, 30 + i, 2, 1)
        pos = lengths + i
        want, rstate = ref_decode.decode_step(
            rcfg, rrt, rparams, jnp.asarray(tok), jnp.asarray(pos), rstate)
        cache = state["layers"]["k"]
        got, state = decode.decode_step(
            cfg, rt, params, torch.from_numpy(tok), torch.from_numpy(pos),
            state)
        assert state["layers"]["k"] is cache           # written in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for impl in ("chunked", "dense"):
        tok = _tokens(cfg, 40, 2, 1)
        want, rs = ref_decode.decode_step(
            rcfg, RefRuntime(tp=1, decode_impl=impl), rparams,
            jnp.asarray(tok), jnp.int32(19), rstate)
        got, st = decode.decode_step(
            cfg, Runtime(decode_impl=impl), params, torch.from_numpy(tok),
            torch.tensor(19), convert.decode_state_from_jax(
                jax.tree.map(np.asarray, rstate), device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(st["layers"][name]),
                                       np.asarray(rs["layers"][name]), **TOL)


def test_decode_state_layout_matches(pair):
    rcfg, _, cfg, _ = pair
    rstate = ref_decode.init_decode_state(rcfg, RefRuntime(tp=1), 3, 40)
    state = decode.init_decode_state(cfg, Runtime(), 3, 40, device="cpu")
    for name in ("k", "v"):
        assert tuple(state["layers"][name].shape) == \
            rstate["layers"][name].shape
        assert state["layers"][name].dtype == torch.float32
        assert not state["layers"][name].any()
    full = decode.init_decode_state(get_config("qwen2.5-14b"), Runtime(), 1,
                                    4, device="meta")
    assert full["layers"]["k"].dtype == torch.bfloat16
    assert tuple(full["layers"]["k"].shape) == (48, 1, 4, 8, 128)


@pytest.mark.parametrize("window", [0, 8])
def test_init_kv_cache_matches(window):
    rcfg, cfg = _reduced("qwen2.5-14b")
    want = ref_attn.init_kv_cache(rcfg, 2, 20, window=window,
                                  dtype=jnp.float32)
    got = attn.init_kv_cache(cfg, 2, 20, window=window, dtype=torch.float32,
                             device="cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
