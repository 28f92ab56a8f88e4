"""repro_torch's recurrent blocks on the CPU against the reference package:
Mamba2's SSD block (models/ssm.py) and RecurrentGemma's RG-LRU block
(models/rglru.py), in f32.

Both packages get the same weights and inputs, drawn with numpy from a
seed: every leaf the reference initialises to zeros or ones (``A_log``,
``D``, ``dt_bias``, ``norm_g``, ``conv_b``; ``b_a``, ``b_i``, ``lam``) is
drawn at random too (``torch_recurrent_params.REC_AROUND``), so that its
code path carries weight. The SSD block is drawn a second time with dt in
Mamba2's trained range (``SSD_TRAINED_AROUND``: ``dt_bias`` ~-4, ``A_log``
~0), where a chunk's decay exp(seg_L) is ~0.1 rather than ~exp(-100), so
that the state carried from chunk to chunk (``chunk_decay`` in the
inter-chunk loop) shows in the outputs. The configs are the reduced
``mamba2-2.7b`` (d_model 64, 8 heads of 16, state 16) and
``recurrentgemma-2b`` (lru_width 64).

Tolerances, f32:
- SSD: rtol = atol = 1e-5 up to 16 positions; 1e-4 over chunks of 100
  and more (S = 100, 128, and 256: two chunks of CHUNK = 128, where the
  inter-chunk recurrence runs). Each package takes the cumulative log
  decay ``seg`` by its own cumsum; over a chunk it reaches -200 in these
  draws, where one f32 step is 1.5e-5, and ``exp(seg_i - seg_j)`` carries
  that as a relative error into every output and state built on it. The
  largest difference seen is 6.6e-5, in a state entry of 5.7 (S = 128).
  In the trained-range draw the log decay stays within a few units, and
  the SSD is held to rtol = atol = 1e-5 over two and three chunks.
- RG-LRU: rtol = atol = 1e-5. The doubling scan multiplies the same
  factors as the reference's associative scan in another order; the
  largest difference seen is a few 1e-7.
- Decode steps: rtol = atol = 1e-5, one token each.
``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's softplus is the same
formula, equal to it at every input (``F.softplus`` would return ``x``
itself above 20, off by up to 2e-9), and the test holds it there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import common, rglru, ssm
from repro_torch.models.common import ParamMaker
from torch_recurrent_params import REC_AROUND, SSD_TRAINED_AROUND

TOL = dict(rtol=1e-5, atol=1e-5)
#: the SSD block over chunks of 100 positions and more (see the docstring)
TOL_CHUNKS = dict(rtol=1e-4, atol=1e-4)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfg(arch):
    import dataclasses
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _draw(params_fn, cfg, seed, around):
    """``params_fn``'s leaves at their shapes, drawn with numpy: normal at
    the port's scale (1 / sqrt(fan-in)), and ``around[name] = (centre,
    spread)`` for the leaves the reference sets to zeros or ones. Returns
    (numpy tree, port tree)."""
    shapes = params_fn(ParamMaker(torch.Generator().manual_seed(0),
                                  "float32", torch.device("cpu")),
                       "blk", cfg)
    rng = np.random.default_rng(seed)
    tree = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name in around:
            centre, spread = around[name]
            a = centre + spread * rng.standard_normal(shape)
        else:
            scale = 0.5 if name == "conv_w" else shape[0] ** -0.5
            a = scale * rng.standard_normal(shape)
        tree[name] = a.astype(np.float32)
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssd():
    rcfg, cfg = _cfg("mamba2-2.7b")
    tree, p = _draw(ssm.ssm_params, cfg, 11, REC_AROUND)
    return rcfg, _ref(tree), cfg, p


@pytest.fixture(scope="module")
def ssd_trained():
    """The SSD block with dt in Mamba2's trained range."""
    rcfg, cfg = _cfg("mamba2-2.7b")
    tree, p = _draw(ssm.ssm_params, cfg, 13, SSD_TRAINED_AROUND)
    return rcfg, _ref(tree), cfg, p


def _chunk_decay(tree, cfg, u):
    """exp of each chunk's summed log decay, [B, chunks, heads], in numpy
    from the draw: the factor the inter-chunk loop carries a state by."""
    H = ssm.ssm_dims(cfg)[1]
    raw = (u @ tree["w_in"])[..., -H:] + tree["dt_bias"]
    dt = np.logaddexp(raw, 0.0)
    B, S, _ = u.shape
    seg = (dt * -np.exp(tree["A_log"])).reshape(B, S // ssm.CHUNK,
                                               ssm.CHUNK, H).sum(2)
    return np.exp(seg)


def test_ssm_dims_and_param_shapes_match():
    rcfg, cfg = _cfg("mamba2-2.7b")
    assert ssm.ssm_dims(cfg) == ref_ssm.ssm_dims(rcfg) == (128, 8, 16, 16)
    assert ssm.CHUNK == ref_ssm.CHUNK == 128
    full = get_config("mamba2-2.7b")
    assert ssm.ssm_dims(full) == (5120, 80, 64, 128)
    p = ssm.ssm_params(ParamMaker(torch.Generator().manual_seed(0),
                                  "bfloat16", torch.device("meta")),
                       "ssm", full)
    # fused input projection [z, x, B, C, dt] and the conv over [x, B, C]
    assert tuple(p["w_in"].shape) == (2560, 2 * 5120 + 2 * 128 + 80)
    assert tuple(p["conv_w"].shape) == (4, 5120 + 2 * 128)
    assert p["w_in"].dtype == torch.bfloat16


def test_split_proj_matches(ssd):
    rcfg, _, cfg, _ = ssd
    width = 2 * 128 + 2 * 16 + 8
    z = _x(1, 2, 3, width)
    for got, want in zip(ssm._split_proj(cfg, torch.from_numpy(z)),
                         ref_ssm._split_proj(rcfg, jnp.asarray(z))):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_causal_convs_match():
    x, w, b = _x(2, 2, 7, 12), _x(3, 4, 12), _x(4, 12)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    rargs = [jnp.asarray(a) for a in (x, w, b)]
    np.testing.assert_allclose(_np(ssm._causal_conv(*args)),
                               np.asarray(ref_ssm._causal_conv(*rargs)),
                               **TOL)
    np.testing.assert_allclose(_np(rglru._causal_conv(*args)),
                               np.asarray(ref_rglru._causal_conv(*rargs)),
                               **TOL)


@pytest.mark.parametrize("x", [[-100.0, -30.0, -1.0, 0.0, 0.5, 19.0, 21.0,
                                30.0, 100.0]])
def test_softplus_is_the_reference_formula(x):
    """Equal to ``jax.nn.softplus`` past F.softplus's threshold too (to
    one part in 1e7; below the smallest normal f32, where XLA on the CPU
    flushes ``softplus(-100)`` to 0 and PyTorch keeps the subnormal
    3.8e-44, to that smallest normal)."""
    a = np.asarray(x, np.float32)
    np.testing.assert_allclose(_np(common.softplus(torch.from_numpy(a))),
                               np.asarray(jax.nn.softplus(jnp.asarray(a))),
                               rtol=1e-7, atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("S,tol", [(1, TOL), (2, TOL), (16, TOL),
                                   (100, TOL_CHUNKS), (128, TOL_CHUNKS),
                                   (256, TOL_CHUNKS)])
def test_ssd_forward_matches(ssd, S, tol):
    """One chunk at S < CHUNK and S not a multiple of it (100: one chunk of
    100), one whole chunk at 128, two chunks at 256 (the inter-chunk
    recurrence); the state for decode, with the conv tail left-padded at
    S < K - 1."""
    rcfg, rp, cfg, p = ssd
    u = _x(20 + S, 2, S, cfg.d_model)
    want, (wh, wtail) = ref_ssm.ssd_forward(rp, rcfg, jnp.asarray(u),
                                            return_state=True)
    got, (gh, gtail) = ssm.ssd_forward(p, cfg, torch.from_numpy(u),
                                       return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)
    assert gh.dtype == torch.float32 and tuple(gh.shape) == wh.shape
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **tol)
    assert tuple(gtail.shape) == wtail.shape == (2, 3, 128 + 2 * 16)
    np.testing.assert_allclose(_np(gtail), np.asarray(wtail), **TOL)
    again = ssm.ssd_forward(p, cfg, torch.from_numpy(u))
    np.testing.assert_array_equal(_np(again), _np(got))


def test_init_ssm_cache_matches(ssd):
    rcfg, _, cfg, _ = ssd
    want = ref_ssm.init_ssm_cache(rcfg, 3, dtype=jnp.float32)
    got = ssm.init_ssm_cache(cfg, 3, device="cpu")
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32 and not got[name].any()
    assert ssm.init_ssm_cache(cfg, 1, dtype=torch.bfloat16,
                              device="cpu")["h"].dtype == torch.float32


def test_ssd_decode_steps_match(ssd):
    """Three steps from a random state, each on the state the step before
    left; the port writes h and the conv window into the cache in place."""
    rcfg, rp, cfg, p = ssd
    h0 = _x(30, 2, 8, 16, 16, scale=0.5)
    c0 = _x(31, 2, 3, 160)
    rcache = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    cache = {"h": torch.from_numpy(h0.copy()),
             "conv": torch.from_numpy(c0.copy())}
    h_t = cache["h"]
    for i in range(3):
        u = _x(32 + i, 2, 1, cfg.d_model)
        want, rcache = ref_ssm.ssd_decode_step(rp, rcfg, jnp.asarray(u),
                                               rcache)
        got, cache = ssm.ssd_decode_step(p, cfg, torch.from_numpy(u), cache)
        assert cache["h"] is h_t                         # in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(_np(cache[name]),
                                       np.asarray(rcache[name]), **TOL)


@pytest.mark.parametrize("S", [256, 384])
def test_ssd_forward_carries_the_state_across_chunks(ssd_trained, S):
    """Two and three chunks with dt in Mamba2's trained range, where most
    heads pass more than a hundredth of a chunk's state on to the next and
    some more than a tenth (asserted of the draw), against the reference at
    1e-5: outputs and final state."""
    rcfg, rp, cfg, p = ssd_trained
    u = _x(90 + S, 2, S, cfg.d_model)
    decay = _chunk_decay({k: np.asarray(v) for k, v in rp.items()}, cfg, u)
    assert np.median(decay) > 0.01 and 0.1 < decay.max() < 1.0
    want, (wh, _) = ref_ssm.ssd_forward(rp, rcfg, jnp.asarray(u),
                                        return_state=True)
    got, (gh, _) = ssm.ssd_forward(p, cfg, torch.from_numpy(u),
                                   return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **TOL)


@pytest.mark.parametrize("S", [3, 130])
def test_ssd_forward_state_continues_in_decode(ssd, S):
    """The port alone: the chunked form over S tokens equals the recurrence
    run token by token from a zero cache, outputs and final state."""
    _, _, cfg, p = ssd
    u = torch.from_numpy(_x(40 + S, 2, S, cfg.d_model))
    want, (wh, wtail) = ssm.ssd_forward(p, cfg, u, return_state=True)
    cache = ssm.init_ssm_cache(cfg, 2, device="cpu")
    steps = [ssm.ssd_decode_step(p, cfg, u[:, t:t + 1], cache)[0]
             for t in range(S)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(want),
                               **TOL_CHUNKS)
    np.testing.assert_allclose(_np(cache["h"]), _np(wh), **TOL_CHUNKS)
    np.testing.assert_allclose(_np(cache["conv"]), _np(wtail), **TOL)


def test_ssd_forward_state_continues_in_decode_at_trained_dt(ssd_trained):
    """The port alone, two chunks with dt in Mamba2's trained range: the
    chunked form against 256 decode steps at 1e-5."""
    _, _, cfg, p = ssd_trained
    u = torch.from_numpy(_x(95, 2, 256, cfg.d_model))
    want, (wh, _) = ssm.ssd_forward(p, cfg, u, return_state=True)
    cache = ssm.init_ssm_cache(cfg, 2, device="cpu")
    steps = [ssm.ssd_decode_step(p, cfg, u[:, t:t + 1], cache)[0]
             for t in range(256)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(want), **TOL)
    np.testing.assert_allclose(_np(cache["h"]), _np(wh), **TOL)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lru():
    rcfg, cfg = _cfg("recurrentgemma-2b")
    tree, p = _draw(rglru.rglru_params, cfg, 12, REC_AROUND)
    return rcfg, _ref(tree), cfg, p


def test_rglru_constants_and_param_shapes_match(lru):
    rcfg, _, cfg, p = lru
    assert (rglru.RG_C, rglru.CONV_K) == (ref_rglru.RG_C, ref_rglru.CONV_K)
    assert tuple(p["w_a"].shape) == (64, 64)
    assert tuple(p["conv_w"].shape) == (rglru.CONV_K, 64)


def test_gates_match(lru):
    _, rp, _, p = lru
    x = _x(50, 2, 5, 64)
    for got, want in zip(rglru._gates(p, torch.from_numpy(x)),
                         ref_rglru._gates(rp, jnp.asarray(x))):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 17, 64])
def test_linear_scan_is_the_recurrence(S):
    """The doubling scan against the plain loop h_t = a_t h_{t-1} + b_t,
    at lengths that are and are not powers of two."""
    a = torch.from_numpy(np.random.default_rng(S).uniform(
        0.5, 1.0, (2, S, 8)).astype(np.float32))
    b = torch.from_numpy(_x(S + 1, 2, S, 8))
    h, want = torch.zeros(2, 8), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(_np(rglru._linear_scan(a, b)),
                               _np(torch.stack(want, 1)), **TOL)


@pytest.mark.parametrize("S", [1, 3, 64])
def test_rglru_forward_matches(lru, S):
    """S = 1 (no scan step), 3 (shorter than the conv window) and 64."""
    rcfg, rp, cfg, p = lru
    u = _x(60 + S, 2, S, cfg.d_model)
    want, (wh, wtail) = ref_rglru.rglru_forward(rp, rcfg, jnp.asarray(u),
                                                return_state=True)
    got, (gh, gtail) = rglru.rglru_forward(p, cfg, torch.from_numpy(u),
                                           return_state=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), **TOL)
    assert tuple(gtail.shape) == wtail.shape == (2, rglru.CONV_K - 1, 64)
    np.testing.assert_allclose(_np(gtail), np.asarray(wtail), **TOL)
    np.testing.assert_array_equal(
        _np(rglru.rglru_forward(p, cfg, torch.from_numpy(u))), _np(got))


def test_init_rglru_cache_matches(lru):
    rcfg, _, cfg, _ = lru
    want = ref_rglru.init_rglru_cache(rcfg, 3, dtype=jnp.float32)
    got = rglru.init_rglru_cache(cfg, 3, dtype=torch.bfloat16, device="cpu")
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
    assert got["h"].dtype == torch.float32
    assert got["conv"].dtype == torch.bfloat16


def test_rglru_decode_steps_match(lru):
    rcfg, rp, cfg, p = lru
    h0, c0 = _x(70, 2, 64, scale=0.5), _x(71, 2, 3, 64)
    rcache = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    cache = {"h": torch.from_numpy(h0.copy()),
             "conv": torch.from_numpy(c0.copy())}
    conv_t = cache["conv"]
    for i in range(3):
        u = _x(72 + i, 2, 1, cfg.d_model)
        want, rcache = ref_rglru.rglru_decode_step(rp, rcfg, jnp.asarray(u),
                                                   rcache)
        got, cache = rglru.rglru_decode_step(p, cfg, torch.from_numpy(u),
                                             cache)
        assert cache["conv"] is conv_t                   # in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(_np(cache[name]),
                                       np.asarray(rcache[name]), **TOL)


@pytest.mark.parametrize("S", [2, 37])
def test_rglru_forward_state_continues_in_decode(lru, S):
    """The port alone: the doubling scan over S tokens equals the
    recurrence run token by token from a zero cache."""
    _, _, cfg, p = lru
    u = torch.from_numpy(_x(80 + S, 2, S, cfg.d_model))
    want, (wh, wtail) = rglru.rglru_forward(p, cfg, u, return_state=True)
    cache = rglru.init_rglru_cache(cfg, 2, device="cpu")
    steps = [rglru.rglru_decode_step(p, cfg, u[:, t:t + 1], cache)[0]
             for t in range(S)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(want), **TOL)
    np.testing.assert_allclose(_np(cache["h"]), _np(wh), **TOL)
    np.testing.assert_allclose(_np(cache["conv"]), _np(wtail), **TOL)
