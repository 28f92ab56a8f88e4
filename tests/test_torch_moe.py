"""repro_torch.models.moe on the CPU against the reference package's
``models/moe.py``: routing, the sort-scatter dispatch, the local path, the
dense oracle and the capacity drops.

Both packages run tiny f32 MoE configs on the same parameters (the
reference's ``moe_params`` drawn from its own key, handed over as numpy
arrays) and the same inputs (numpy seeds). The parametrisation is the
reference test's: ``(E, k, shared)`` in ``(4,2,0), (8,2,1), (4,1,0)``.

Tolerance: the discrete routing — top-k indices, sort order, positions
within experts, which pairs are dropped — must be equal; weights, outputs
and the aux loss agree within rtol = atol = 1e-5 (the two packages multiply
and take exp in different orders, so f32 results differ in the last bits).
The port's local path is held against its own dense oracle within 2e-4,
the tolerance of the reference's test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import moe as ref_moe
from repro.models.common import ParamMaker as RefParamMaker
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(4, 2, 0), (8, 2, 1), (4, 1, 0)]


def _cfgs(E=4, k=2, shared=0, d=16):
    kw = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=E,
              experts_per_token=k, n_shared_experts=shared, dtype="float32")
    return RefModelConfig(**kw), ModelConfig(**kw)


def _params(rcfg, seed=0):
    """The reference's MoE parameters as numpy arrays."""
    p = ref_moe.moe_params(RefParamMaker(jax.random.PRNGKey(seed), "float32"),
                           "moe", rcfg)
    return jax.tree.map(lambda a: np.array(a, np.float32), p)


def _torch(tree):
    return {k: (_torch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in tree.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("E,k,shared", CASES)
def test_route_matches(E, k, shared):
    rcfg, _ = _cfgs(E, k, shared)
    x = _x(1, 64, rcfg.d_model)
    for w in (_params(rcfg)["router"],
              _x(2, rcfg.d_model, E) * 0.1):
        gw, gidx, gaux = moe._route(torch.from_numpy(w), torch.from_numpy(x),
                                    k)
        ww, widx, waux = ref_moe._route(jnp.asarray(w), jnp.asarray(x), k)
        np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
        assert gidx.dtype == torch.int32
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **TOL)
        np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, rtol=1e-5)
        np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 3), (2, 1)])
def test_route_breaks_ties_to_the_lower_expert(E, k):
    """A zero router gives every expert the same probability: as
    ``jax.lax.top_k``, the port takes experts 0 .. k-1, in that order."""
    x = _x(3, 20, 16)
    w = np.zeros((16, E), np.float32)
    gw, gidx, gaux = moe._route(torch.from_numpy(w), torch.from_numpy(x), k)
    ww, widx, waux = ref_moe._route(jnp.asarray(w), jnp.asarray(x), k)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(gidx.numpy(),
                                  np.broadcast_to(np.arange(k), (20, k)))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("seed,E,k", [(0, 4, 2), (1, 8, 2), (2, 4, 1),
                                      (3, 2, 1)])
def test_dispatch_indices_match(seed, E, k):
    idx = np.random.default_rng(seed).integers(0, E, (37, k)).astype(
        np.int32)
    got = moe._dispatch_indices(torch.from_numpy(idx))
    want = ref_moe._dispatch_indices(jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dispatch_indices_positions():
    idx = torch.tensor([[0], [1], [0], [0], [1]], dtype=torch.int32)
    order, sorted_e, pos = moe._dispatch_indices(idx)
    np.testing.assert_array_equal(sorted_e.numpy(), [0, 0, 0, 1, 1])
    np.testing.assert_array_equal(pos.numpy(), [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(order.numpy(), [0, 2, 3, 1, 4])


@pytest.mark.parametrize("E,k,shared", CASES)
def test_local_matches_the_reference(E, k, shared):
    rcfg, cfg = _cfgs(E, k, shared)
    tree = _params(rcfg)
    x = _x(9, 2, 16, cfg.d_model)
    got, gaux = moe.moe_block_local(_torch(tree), cfg, torch.from_numpy(x))
    want, waux = ref_moe.moe_block_local(tree, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("E,k,shared", CASES)
def test_dense_oracle_matches_the_reference(E, k, shared):
    rcfg, cfg = _cfgs(E, k, shared)
    tree = _params(rcfg)
    x = _x(10, 2, 16, cfg.d_model)
    got, gaux = moe.moe_block_dense(_torch(tree), cfg, torch.from_numpy(x))
    want, waux = ref_moe.moe_block_dense(tree, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("E,k,shared", CASES)
def test_local_matches_the_dense_oracle(E, k, shared):
    """The reference test's check, on the port alone: at capacity factor
    1.25 nothing is dropped at this size, so the two paths agree within
    2e-4."""
    _, cfg = _cfgs(E, k, shared)
    p = _torch(_params(_cfgs(E, k, shared)[0]))
    x = torch.from_numpy(_x(11, 2, 16, cfg.d_model))
    y_dense, aux_d = moe.moe_block_dense(p, cfg, x)
    y_local, aux_l = moe.moe_block_local(p, cfg, x)
    np.testing.assert_allclose(y_local.numpy(), y_dense.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux_l), float(aux_d), rtol=1e-5,
                               atol=1e-6)


def test_capacity_drops_contribute_zero_as_in_the_reference():
    """A zero router sends every token to expert 0 (the tie rule): capacity
    64 * 1 / 2 * 1.25 = 40, so the last 24 tokens are dropped and their
    rows are exactly 0, as in the reference."""
    rcfg, cfg = _cfgs(2, 1)
    tree = _params(rcfg, seed=3)
    tree["router"] = np.zeros_like(tree["router"])
    x = _x(4, 1, 64, cfg.d_model)
    got, _ = moe.moe_block_local(_torch(tree), cfg, torch.from_numpy(x))
    want, _ = ref_moe.moe_block_local(tree, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    zero_rows = (got[0] == 0.0).all(dim=-1)
    assert int(zero_rows.sum()) == 24
    assert bool(zero_rows[40:].all()) and not bool(zero_rows[:40].any())
    np.testing.assert_array_equal(zero_rows.numpy(),
                                  np.all(np.asarray(want)[0] == 0.0, -1))


@pytest.mark.parametrize("hot", [0, 3])
def test_partial_drops_match_the_reference(hot):
    """One expert biased to take most pairs of a top-2 router: some of its
    pairs pass the capacity and some do not; which ones, and what the
    others add, equal the reference's."""
    rcfg, cfg = _cfgs(4, 2)
    tree = _params(rcfg, seed=5)
    tree["router"] = _x(6, cfg.d_model, 4) * 0.05
    tree["router"][:, hot] += 0.5
    x = np.abs(_x(7, 2, 24, cfg.d_model))
    got, gaux = moe.moe_block_local(_torch(tree), cfg, torch.from_numpy(x))
    want, waux = ref_moe.moe_block_local(tree, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    # the hot expert got more pairs than its capacity
    _, idx, _ = moe._route(torch.from_numpy(tree["router"]),
                           torch.from_numpy(x.reshape(-1, cfg.d_model)), 2)
    assert int((idx == hot).sum()) > moe._capacity(48, cfg)


@pytest.mark.parametrize("tokens", [1, 4, 31, 64, 100, 1024, 4096])
@pytest.mark.parametrize("E,k", [(4, 2), (16, 4), (256, 8)])
def test_capacity_matches(tokens, E, k):
    rcfg, cfg = _cfgs(E, k)
    for factor in (None, 1.0, 2.0):
        c = moe._capacity(tokens, cfg, factor)
        assert c == ref_moe._capacity(tokens, rcfg, factor)
        assert c >= 8 and c % 8 == 0
    assert moe.CAPACITY_FACTOR == ref_moe.CAPACITY_FACTOR


def test_moe_block_routes_impls():
    rcfg, cfg = _cfgs(4, 2, 1)
    p = _torch(_params(rcfg))
    x = torch.from_numpy(_x(12, 1, 8, cfg.d_model))
    for impl, fn in (("dense", moe.moe_block_dense),
                     ("local", moe.moe_block_local)):
        y, aux = moe.moe_block(p, cfg, x, impl=impl)
        y2, aux2 = fn(p, cfg, x)
        assert torch.equal(y, y2) and torch.equal(aux, aux2)
    # the expert-parallel path needs a mesh (tests/test_torch_distributed.py
    # runs it on one)
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_block(p, cfg, x, impl="ep")
    with pytest.raises(ValueError):
        moe.moe_block(p, cfg, x, impl="nope")


def test_params_have_the_reference_layout():
    from repro_torch.models.common import ParamMaker
    for E, k, shared in CASES:
        rcfg, cfg = _cfgs(E, k, shared)
        want = _params(rcfg)
        got = moe.moe_params(ParamMaker(torch.Generator().manual_seed(0),
                                        "float32", torch.device("cpu")),
                             "moe", cfg)
        assert set(got) == set(want)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            t = got
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
        # the router's draw is at 0.02, the experts' at shape[0] ** -0.5
        assert abs(float(got["router"].std()) / 0.02 - 1) < 0.5
