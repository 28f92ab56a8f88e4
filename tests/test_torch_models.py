"""repro_torch.models on the CPU against the reference package's models.

Both packages run the reduced qwen2.5-14b and stablelm-12b configs (dense,
GQA), dbrx-132b (MoE, GQA) and deepseek-v3-671b (MoE with a shared expert,
MLA attention, a multi-token-prediction head) in f32 on the same
parameters: the reference's ``init_params`` tree, with its
zero-initialised biases and unit norm gains replaced by random values so
that those code paths carry weight, handed to the port as numpy arrays
through :func:`repro_torch.convert.params_from_jax`. MoE runs the local
path (``Runtime(tp=1, moe_impl="local")``, the reference's single-device
path) unless a test says otherwise; its discrete routing is equal in both
packages on these inputs, so its outputs are held to the same tolerance.

The recurrent families run too: mamba2-2.7b (SSM) and recurrentgemma-2b
(hybrid RG-LRU / local attention), reduced, with every leaf the reference
sets to zeros or ones (norm gains, ``A_log``, ``D``, ``dt_bias``,
``conv_b``, ``b_a``, ``b_i``, ``lam``) drawn at random.

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
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import Runtime
from torch_recurrent_params import redraw

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2.5-14b", "stablelm-12b", "dbrx-132b", "deepseek-v3-671b"]
#: leaves initialised to ones (norm gains), drawn at random in the tests
GAINS = ("ln1", "ln2", "q_norm", "kv_norm", "ln_h", "ln_e")


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
    _random_gains(tree, rng)
    tree["ln_f"] = 1.0 + 0.1 * rng.standard_normal(
        tree["ln_f"].shape).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            layers["attn"][name] = 0.1 * rng.standard_normal(
                layers["attn"][name].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    return rcfg, rparams, cfg, params


def _random_gains(tree, rng):
    """Every norm gain of :data:`GAINS` in ``tree``, at any depth, redrawn
    around 1."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _random_gains(v, rng)
        elif k in GAINS:
            tree[k] = 1.0 + 0.1 * rng.standard_normal(v.shape).astype(
                np.float32)

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
    # the multi-token-prediction head (unstacked in the reference too)
    assert ("mtp" in params) == bool(cfg.mtp_depth)
    if cfg.mtp_depth:
        flat = jax.tree_util.tree_flatten_with_path(rparams["mtp"])[0]
        assert len(flat) == len(list(_leaves(params["mtp"])))
        for path, leaf in flat:
            t = params["mtp"]
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
    # the draws: zero biases, unit gains, normal weights at shape[0] ** -0.5
    # (the reference's rule: 1/sqrt(fan-in) for a matrix; for an expert
    # tensor [E, d, ff] its first axis is the expert count)
    lay = params["layers"][1]
    assert torch.equal(lay["ln1"], torch.ones(cfg.d_model))
    mlp = lay["mlp"]
    w = mlp["wi"] if "wi" in mlp else mlp["experts"]["wi"]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.05
    again = model.init_params(cfg, Runtime(),
                              torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["emb"], params["emb"])


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


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
    assert list(state["layers"]) == list(rstate["layers"])
    for name in rstate["layers"]:
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
        cache = next(iter(state["layers"].values()))
        got, state = decode.decode_step(
            cfg, rt, params, torch.from_numpy(tok), torch.from_numpy(pos),
            state)
        assert next(iter(state["layers"].values())) is cache   # in place
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
        for name in rs["layers"]:
            np.testing.assert_allclose(_np(st["layers"][name]),
                                       np.asarray(rs["layers"][name]), **TOL)


def test_decode_state_layout_matches(pair):
    rcfg, _, cfg, _ = pair
    rstate = ref_decode.init_decode_state(rcfg, RefRuntime(tp=1), 3, 40)
    state = decode.init_decode_state(cfg, Runtime(), 3, 40, device="cpu")
    assert list(state["layers"]) == list(rstate["layers"])
    for name in rstate["layers"]:
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


# ---------------------------------------------------------------------------
# MoE and MLA
# ---------------------------------------------------------------------------
def test_trunk_aux_loss_matches(pair):
    """The MoE load-balance loss summed over the layers (0 for a dense
    trunk), on the reference's local path."""
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, 15, 2, 11)
    _, want, _ = ref_model.trunk_hidden(rcfg, RefRuntime(tp=1),
                                        rparams, {"tokens": jnp.asarray(toks)})
    _, got, _ = model.trunk_hidden(cfg, Runtime(), params,
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert (float(got) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_dense_oracle_runtime_matches(arch):
    """``Runtime(moe_impl="dense")`` runs every layer's FFN on the dense
    oracle, in both packages."""
    rcfg, cfg = _reduced(arch)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(3))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    toks = _tokens(cfg, 16, 2, 9)
    want = ref_model.forward_logits(rcfg, RefRuntime(tp=1, moe_impl="dense"),
                                    rparams, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(cfg, Runtime(moe_impl="dense"), params,
                               {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # impl="ep" splits the experts over a mesh; without one it refuses
    with pytest.raises(ValueError, match="mesh"):
        model.forward_logits(cfg, Runtime(moe_impl="ep"), params,
                             {"tokens": torch.from_numpy(toks)})


@pytest.fixture(scope="module")
def mla_layer():
    """Layer 0's MLA parameters of the reduced deepseek-v3-671b, with random
    norm gains, in both packages."""
    rcfg, cfg = _reduced("deepseek-v3-671b")
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(4))
    tree = jax.tree.map(lambda a: np.array(a[0], np.float32),
                        rparams["layers"]["attn"])
    _random_gains(tree, np.random.default_rng(5))
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("positions", ["arange", "per_row"])
def test_mla_blocks_match(mla_layer, positions):
    rcfg, rp, cfg, p = mla_layer
    x = _normal(50, 2, 10, cfg.d_model)
    pos = (np.arange(10, dtype=np.int32)[None] if positions == "arange"
           else np.array([np.arange(10), np.arange(3, 13)], np.int32))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for name in ("_mla_q", "_mla_latent"):
        want = getattr(ref_attn, name)(rp, rcfg, jx, jpos)
        got = getattr(attn, name)(p, cfg, tx, tpos)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    want, (wc, wr) = ref_attn.mla_attention(rp, rcfg, jx, jpos,
                                            return_cache=True)
    got, (gc, gr) = attn.mla_attention(p, cfg, tx, tpos, return_cache=True)
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    assert torch.equal(attn.mla_attention(p, cfg, tx, tpos), got)
    # q/k of qk_nope + qk_rope, v of v_head_dim: the kernel's (D, Dv)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (24, 16)


@pytest.mark.parametrize("pos", [np.int32(6), np.array([6, 2], np.int32)])
def test_mla_decode_matches(mla_layer, pos):
    """Absorbed decode over a latent cache, at a scalar position and at
    per-slot positions; the port writes the new rows in place."""
    rcfg, rp, cfg, p = mla_layer
    x = _normal(51, 2, 1, cfg.d_model)
    cache = {"c_kv": _normal(52, 2, 12, cfg.kv_lora_rank),
             "k_rope": _normal(53, 2, 12, cfg.qk_rope_dim)}
    want, wc = ref_attn.mla_decode(rp, rcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v)
                                    for k, v in cache.items()},
                                   jnp.asarray(pos))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gc = attn.mla_decode(p, cfg, torch.from_numpy(x), tcache,
                              torch.from_numpy(np.asarray(pos)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in cache:
        assert gc[name] is tcache[name]
        np.testing.assert_allclose(_np(gc[name]), np.asarray(wc[name]),
                                   **TOL)


def test_init_mla_cache_matches():
    rcfg, cfg = _reduced("deepseek-v3-671b")
    want = ref_attn.init_mla_cache(rcfg, 2, 20, dtype=jnp.float32)
    got = attn.init_mla_cache(cfg, 2, 20, dtype=torch.float32, device="cpu")
    assert list(got) == list(want) == ["c_kv", "k_rope"]
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()


def test_full_size_latent_cache_layout():
    """deepseek-v3-671b at full width: the decode state is the latent cache,
    512 + 64 values a token and layer, in bf16."""
    full = decode.init_decode_state(get_config("deepseek-v3-671b"),
                                    Runtime(), 2, 8, device="meta")
    assert list(full["layers"]) == ["c_kv", "k_rope"]
    assert tuple(full["layers"]["c_kv"].shape) == (61, 2, 8, 512)
    assert tuple(full["layers"]["k_rope"].shape) == (61, 2, 8, 64)
    assert full["layers"]["c_kv"].dtype == torch.bfloat16


def test_decode_state_from_jax_takes_the_latent_cache():
    rcfg, cfg = _reduced("deepseek-v3-671b")
    rstate = jax.tree.map(np.asarray, ref_decode.init_decode_state(
        rcfg, RefRuntime(tp=1), 2, 6))
    rstate["layers"]["c_kv"] = _normal(54, *rstate["layers"]["c_kv"].shape)
    state = convert.decode_state_from_jax(rstate, device="cpu")
    assert list(state["layers"]) == ["c_kv", "k_rope"]
    for name, want in rstate["layers"].items():
        np.testing.assert_array_equal(_np(state["layers"][name]), want)


def test_large_leaves_are_drawn_in_slabs(monkeypatch):
    """A leaf of more than SLAB_ELEMS elements is drawn slab by slab along
    its first axis, each slab in f32 from the same generator and cast into
    the leaf: the numbers of the draws one after the other."""
    monkeypatch.setattr(common, "SLAB_ELEMS", 64)
    shape, scale = (16, 8, 4), 16 ** -0.5
    mk = common.ParamMaker(torch.Generator().manual_seed(3), "bfloat16",
                           torch.device("cpu"))
    got = mk("w", shape)
    gen = torch.Generator().manual_seed(3)
    want = torch.cat([torch.randn((2, 8, 4), generator=gen) * scale
                      for _ in range(8)]).bfloat16()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert torch.equal(got, want)
    # a leaf at the limit is one draw, as before
    small = common.ParamMaker(torch.Generator().manual_seed(3), "float32",
                              torch.device("cpu"))("b", (8, 8))
    assert torch.equal(small, torch.randn(
        (8, 8), generator=torch.Generator().manual_seed(3)) * 8 ** -0.5)


# ---------------------------------------------------------------------------
# the recurrent families: SSM (mamba2-2.7b) and hybrid (recurrentgemma-2b)
# ---------------------------------------------------------------------------
REC_ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]


def _rec_models(arch, seed=0, **cuts):
    rcfg, cfg = _reduced(arch)
    rcfg = dataclasses.replace(rcfg, **cuts)
    cfg = dataclasses.replace(cfg, **cuts)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    redraw(tree, np.random.default_rng(seed + 1))
    tree["ln_f"] = 1.0 + 0.1 * np.random.default_rng(seed + 2) \
        .standard_normal(tree["ln_f"].shape).astype(np.float32)
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            convert.params_from_jax(tree, cfg, device="cpu"))


@pytest.fixture(scope="module", params=REC_ARCHS)
def rec_pair(request):
    return _rec_models(request.param)


def _flat_state(state):
    """A decode state's tensors in a fixed order: the port's list of
    per-layer dicts, or a dict of stacked tensors, keys sorted."""
    layers = state["layers"]
    dicts = layers if isinstance(layers, list) else [layers]
    return [(i, k, d[k]) for i, d in enumerate(dicts) for k in sorted(d)]


def _assert_states_match(got, want_ref):
    want = convert.decode_state_from_jax(jax.tree.map(np.asarray, want_ref),
                                         device="cpu")
    g, w = _flat_state(got), _flat_state(want)
    assert [(i, k, tuple(t.shape)) for i, k, t in g] == \
        [(i, k, tuple(t.shape)) for i, k, t in w]
    for (_, _, gt), (_, _, wt) in zip(g, w):
        np.testing.assert_allclose(_np(gt), _np(wt), **TOL)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recurrent_params_have_the_reference_layout(arch):
    """init_params gives each layer the leaves and shapes that the
    reference's tree gives it through params_from_jax: stacked SSM layers,
    and the hybrid's pattern groups and remainder layers, in layer order."""
    rcfg, cfg = _reduced(arch)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    carried = convert.params_from_jax(
        jax.tree.map(lambda a: np.array(a, np.float32), rparams), cfg,
        device="cpu")
    params = model.init_params(cfg, Runtime(),
                               torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == set(carried) == {"emb", "ln_f", "layers"}
    assert len(params["layers"]) == len(carried["layers"]) == cfg.n_layers

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in tree.items()}
    for mine, theirs in zip(params["layers"], carried["layers"]):
        assert shapes(mine) == shapes(theirs)
    if cfg.family == "hybrid":
        kinds = ["attn" if "attn" in p else "rglru"
                 for p in params["layers"]]
        assert kinds == ["rglru", "rglru", "attn", "rglru", "rglru"]
        assert kinds == [k if k == "attn" else "rglru"
                         for k in tfm.hybrid_kinds(cfg)]
        assert tfm.hybrid_group_counts(cfg) == (1, 2)
        full = get_config(arch)
        assert tfm.hybrid_kinds(full).count("attn") == 8
        assert tfm.hybrid_group_counts(full) == (8, 2)


@pytest.mark.parametrize("S", [12, 128])
def test_recurrent_forward_logits_match(rec_pair, S):
    """12 positions, and 128: one whole SSD chunk."""
    rcfg, rparams, cfg, params = rec_pair
    toks = _tokens(cfg, 105, 2, S + 1)
    want = ref_model.forward_logits(rcfg, RefRuntime(tp=1), rparams,
                                    {"tokens": jnp.asarray(toks)})
    got = model.forward_logits(cfg, Runtime(), params,
                               {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, S, cfg.padded_vocab(1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_recurrent_prefill_logits_and_state_match(rec_pair):
    rcfg, rparams, cfg, params = rec_pair
    toks = _tokens(cfg, 106, 2, 16)
    want, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams,
                                      {"tokens": jnp.asarray(toks)}, 24)
    got, state = decode.prefill(cfg, Runtime(), params,
                                {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_states_match(state, rstate)


def test_recurrent_decode_steps_match(rec_pair):
    """Three steps, each on the state the step before left (the port's
    updated in place), then one step from the reference's state carried
    over by decode_state_from_jax, on both decode impls."""
    rcfg, rparams, cfg, params = rec_pair
    rrt, rt = RefRuntime(tp=1), Runtime()
    toks = _tokens(cfg, 107, 2, 16)
    _, rstate = ref_decode.prefill(rcfg, rrt, rparams,
                                   {"tokens": jnp.asarray(toks)}, 24)
    _, state = decode.prefill(cfg, rt, params,
                              {"tokens": torch.from_numpy(toks)}, 24)
    first = _flat_state(state)[0][2]
    for i in range(3):
        tok = _tokens(cfg, 130 + i, 2, 1)
        want, rstate = ref_decode.decode_step(
            rcfg, rrt, rparams, jnp.asarray(tok), jnp.int32(16 + i), rstate)
        got, state = decode.decode_step(
            cfg, rt, params, torch.from_numpy(tok), torch.tensor(16 + i),
            state)
        assert _flat_state(state)[0][2] is first            # in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_states_match(state, rstate)
    for impl in ("chunked", "dense"):
        tok = _tokens(cfg, 140, 2, 1)
        want, rs = ref_decode.decode_step(
            rcfg, RefRuntime(tp=1, decode_impl=impl), rparams,
            jnp.asarray(tok), jnp.int32(19), rstate)
        got, st = decode.decode_step(
            cfg, Runtime(decode_impl=impl), params, torch.from_numpy(tok),
            torch.tensor(19), convert.decode_state_from_jax(
                jax.tree.map(np.asarray, rstate), device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        _assert_states_match(st, rs)


def test_hybrid_ring_window_matches():
    """recurrentgemma-2b with its local window cut to 8 at a 16-token
    prompt: the prefill leaves the last 8 keys in ring order (slot p % 8
    holds position p) and each decode step overwrites the oldest, as in
    the reference."""
    rcfg, rparams, cfg, params = _rec_models("recurrentgemma-2b", seed=3,
                                             local_window=8)
    toks = _tokens(cfg, 108, 2, 16)
    want, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams,
                                      {"tokens": jnp.asarray(toks)}, 24)
    got, state = decode.prefill(cfg, Runtime(), params,
                                {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert tuple(state["layers"][2]["k"].shape) == (2, 8, 1, 16)
    _assert_states_match(state, rstate)
    for i in range(3):
        tok = _tokens(cfg, 150 + i, 2, 1)
        want, rstate = ref_decode.decode_step(
            rcfg, RefRuntime(tp=1), rparams, jnp.asarray(tok),
            jnp.int32(16 + i), rstate)
        got, state = decode.decode_step(
            cfg, Runtime(), params, torch.from_numpy(tok),
            torch.tensor(16 + i), state)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_states_match(state, rstate)


@pytest.mark.parametrize("S,win", [(5, 8), (8, 8), (13, 8), (16, 8)])
def test_ring_from_kv_puts_position_p_at_slot_p_mod_window(S, win):
    k = torch.arange(S, dtype=torch.float32).reshape(1, S, 1, 1)
    ring = decode._ring_from_kv(k, win)[0, :, 0, 0]
    assert tuple(ring.shape) == (win,)
    for p in range(max(0, S - win), S):
        assert ring[p % win] == p
    assert not ring[S:].any()


def test_recurrent_prefill_rejects_lengths(rec_pair):
    _, _, cfg, params = rec_pair
    toks = torch.from_numpy(_tokens(cfg, 109, 2, 8))
    with pytest.raises(ValueError, match="absorbs pad tokens"):
        decode.prefill(cfg, Runtime(), params, {"tokens": toks}, 12,
                       lengths=torch.tensor([8, 5]))


def test_recurrent_decode_state_layout_matches(rec_pair):
    rcfg, _, cfg, _ = rec_pair
    want = convert.decode_state_from_jax(jax.tree.map(
        np.asarray, ref_decode.init_decode_state(rcfg, RefRuntime(tp=1), 3,
                                                 40)), device="cpu")
    got = decode.init_decode_state(cfg, Runtime(), 3, 40, device="cpu")
    g, w = _flat_state(got), _flat_state(want)
    assert [(i, k, tuple(t.shape)) for i, k, t in g] == \
        [(i, k, tuple(t.shape)) for i, k, t in w]
    assert all(t.dtype == torch.float32 and not t.any() for _, _, t in g)


def test_full_size_recurrent_state_layouts():
    """At full width: mamba2-2.7b's f32 SSD state and bf16 conv window over
    its 64 layers; recurrentgemma-2b's 18 RG-LRU states and 8 rings of
    min(2048, max_len) keys, one kv head of 256, in layer order."""
    mamba = decode.init_decode_state(get_config("mamba2-2.7b"), Runtime(),
                                     4, 2048, device="meta")["layers"]
    assert tuple(mamba["h"].shape) == (64, 4, 80, 64, 128)
    assert mamba["h"].dtype == torch.float32
    assert tuple(mamba["conv"].shape) == (64, 4, 3, 5120 + 2 * 128)
    assert mamba["conv"].dtype == torch.bfloat16
    for max_len, win in ((4096, 2048), (1056, 1056)):
        rg = decode.init_decode_state(get_config("recurrentgemma-2b"),
                                      Runtime(), 4, max_len,
                                      device="meta")["layers"]
        assert len(rg) == 26
        attn_layers = [i for i, c in enumerate(rg) if "k" in c]
        assert attn_layers == list(range(2, 26, 3))
        assert tuple(rg[2]["k"].shape) == (4, win, 1, 256)
        assert tuple(rg[0]["h"].shape) == (4, 2560)
        assert rg[0]["h"].dtype == torch.float32
        assert rg[0]["conv"].dtype == rg[2]["v"].dtype == torch.bfloat16


def test_recurrent_decode_matches_forward(rec_pair):
    """The port alone, as tests/test_serving_consistency.py holds the
    reference: prefill of the first 8 tokens and 8 decode steps reproduce
    the teacher-forced forward logits, rtol = atol = 2e-4."""
    _, _, cfg, params = rec_pair
    rt = Runtime()
    toks = torch.from_numpy(_tokens(cfg, 110, 2, 16))
    full = model.forward_logits(cfg, rt, params, {"tokens": torch.cat(
        [toks, torch.zeros((2, 1), dtype=toks.dtype)], 1)})
    logits, state = decode.prefill(cfg, rt, params, {"tokens": toks[:, :8]},
                                   16)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 7]),
                               rtol=2e-4, atol=2e-4)
    for t in range(8, 16):
        logits, state = decode.decode_step(cfg, rt, params,
                                           toks[:, t:t + 1],
                                           torch.tensor(t), state)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   rtol=2e-4, atol=2e-4)


def test_hybrid_embedding_scale_is_cast_to_bf16_first():
    """sqrt(2560) = 50.596 rounds to 50.5 in bf16; the reference multiplies
    bf16 embeddings by that bf16 scalar, and so does the port."""
    cfg = get_config("recurrentgemma-2b")
    emb = _normal(111, 6, cfg.d_model)
    toks = np.array([[0, 3, 5]], np.int32)
    want = ref_model.embed({"emb": jnp.asarray(emb, jnp.bfloat16)}, cfg,
                           jnp.asarray(toks))
    got = model.embed({"emb": torch.from_numpy(emb).bfloat16()}, cfg,
                      torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    ones = model.embed({"emb": torch.ones(1, cfg.d_model,
                                          dtype=torch.bfloat16)},
                       cfg, torch.zeros((1, 1), dtype=torch.int32))
    assert float(ones[0, 0, 0]) == 50.5
