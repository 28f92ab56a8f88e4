"""repro_torch's VLM and enc-dec families on the CPU against the reference
package: cross-attention, the encoder, the trunks, prefill and decode, the
engine's ``extra_batch`` route and the serve CLI.

Both packages run the reduced llama-3.2-vision-11b (VLM: groups of
self-attention layers, each followed by a gated cross-attention block over
the image's patch embeddings) and seamless-m4t-large-v2 (enc-dec: a
non-causal encoder over the audio frames, a decoder that also attends to
its output) in f32 on the same parameters: the reference's ``init_params``
tree, its norm gains redrawn around 1, handed to the port as numpy arrays
through :func:`repro_torch.convert.params_from_jax`.

The VLM's tanh gates ``gate_a`` / ``gate_m`` are zeros at init in both
packages (``tanh(0) = 0``), so a fresh VLM ignores its image, and a wrong
cross-attention would pass every parity test. The tests set them to
non-zero values in the reference's numpy tree before either package reads
it, and a witness checks that with the gates at 0 the frontend changes
nothing, and with them set it changes the logits. The enc-dec needs no
such change: its memory reaches every decoder layer ungated.

Tolerance: rtol = atol = 1e-5 on logits, caches and building blocks, as
in tests/test_torch_models.py (the packages multiply in different orders;
the largest difference seen here is about 6e-6). Greedy tokens are
equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models import transformer as ref_tfm
from repro.models.common import ParamMaker as RefParamMaker
from repro.models.transformer import Runtime as RefRuntime
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import decode, model
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamMaker
from repro_torch.models.transformer import Runtime
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VLM, ENCDEC]
#: norm gains (initialised to ones), drawn around 1
GAINS = ("ln1", "ln2", "ln_x", "ln_m", "ln_f")
#: the VLM's tanh gates in the tests: tanh(0.8) ~ 0.66, tanh(-0.6) ~ -0.54
GATES = (("gate_a", 0.8), ("gate_m", -0.6))
MAX_LEN = 32


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reduced(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _redraw_gains(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_gains(v, rng)
        elif k in GAINS:
            tree[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)


@functools.lru_cache(maxsize=None)
def _make(arch, gates=GATES):
    """(reference cfg, params; port cfg, params) of ``arch`` reduced, on the
    reference's parameters with redrawn gains and, for the VLM, its tanh
    gates set to ``gates`` ((name, value) pairs). Built once a module: no
    test changes them."""
    rcfg, cfg = _reduced(arch)
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    _redraw_gains(tree, np.random.default_rng(1))
    if cfg.family == "vlm":
        cross = tree["layers"]["cross"]
        for name, value in gates:
            cross[name] = np.full_like(cross[name], value)
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            convert.params_from_jax(tree, cfg, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _make(request.param)


def _tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape, dtype=np.int32)


def _frontend(cfg, seed, batch):
    """A frontend at the residual stream's scale, so that the VLM's
    cross-attention softmax is not flat."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _batches(toks, fe):
    return ({"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)},
            {"tokens": torch.from_numpy(toks), "frontend": torch.from_numpy(fe)})


def _close_states(got, want):
    """The port's state against the reference's, through
    :func:`convert.decode_state_from_jax`."""
    want = convert.decode_state_from_jax(jax.tree.map(np.asarray, want),
                                         device="cpu")
    assert list(got) == list(want) == ["self", "cross"]
    for part in want:
        for name in ("k", "v"):
            assert tuple(got[part][name].shape) == \
                tuple(want[part][name].shape)
            np.testing.assert_allclose(_np(got[part][name]),
                                       _np(want[part][name]), **TOL)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,F", [(5, 8), (12, 7), (1, 9)])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches(Sq, F, qkv_bias):
    """Queries from x, keys and values from a memory of another length,
    GQA (4 q heads over 2 kv heads), no rope, non-causal; a cross block has
    no biases even where the config has ``qkv_bias``."""
    _, cfg = _reduced("qwen2.5-14b")
    cfg = dataclasses.replace(cfg, qkv_bias=qkv_bias)
    rp = ref_attn.attention_params(
        RefParamMaker(jax.random.PRNGKey(3), "float32"), "xattn", cfg,
        cross=True)
    assert set(rp) == {"wq", "wk", "wv", "wo"}
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rp)
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    rng = np.random.default_rng(Sq + F)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, F, cfg.d_model)).astype(np.float32)
    want = ref_attn.cross_attention(rp, cfg, jnp.asarray(x), jnp.asarray(mem))
    got, (k, v) = attn.cross_attention(p, cfg, torch.from_numpy(x),
                                       torch.from_numpy(mem),
                                       return_cache=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert tuple(k.shape) == tuple(v.shape) == (2, F, cfg.n_kv_heads,
                                                cfg.resolved_head_dim)
    # one decode token against the cached K / V equals the whole-memory form
    step = attn.decode_cross_attention(p, cfg, torch.from_numpy(x[:, -1:]),
                                       {"k": k, "v": v})
    np.testing.assert_allclose(_np(step), np.asarray(want)[:, -1:], **TOL)


def test_cross_attention_params_have_no_bias():
    _, cfg = _reduced("qwen2.5-14b")
    cfg = dataclasses.replace(cfg, qkv_bias=True)
    mk = ParamMaker(torch.Generator().manual_seed(0), "float32",
                    torch.device("cpu"))
    assert set(attn.attention_params(mk, "xattn", cfg, cross=True)) == \
        {"wq", "wk", "wv", "wo"}
    assert "bq" in attn.attention_params(mk, "attn", cfg)


@pytest.mark.parametrize("F", [8, 21])
def test_encoder_forward_matches(F):
    """The enc-dec encoder: rope at arange(F), non-causal self-attention
    and the gelu FFN, every layer."""
    rcfg, rparams, cfg, params = _make(ENCDEC)
    fe = _frontend(dataclasses.replace(cfg, frontend_seq=F), 5, 2)
    want = ref_tfm.encoder_forward(rparams["encoder"], rcfg,
                                   RefRuntime(tp=1), jnp.asarray(fe))
    got = tfm.encoder_forward(params["encoder"], cfg, Runtime(),
                              torch.from_numpy(fe))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_encoder_is_not_causal():
    """Changing the last frame moves the encoder's first output row."""
    _, _, cfg, params = _make(ENCDEC)
    fe = torch.from_numpy(_frontend(cfg, 6, 1))
    a = tfm.encoder_forward(params["encoder"], cfg, Runtime(), fe)
    fe2 = fe.clone()
    fe2[:, -1] += 1.0
    b = tfm.encoder_forward(params["encoder"], cfg, Runtime(), fe2)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# parameters and state layouts
# ---------------------------------------------------------------------------
def _ref_shapes(rcfg):
    """The reference's parameter tree of ``rcfg`` as shapes alone."""
    return jax.eval_shape(lambda key: ref_model.init_params(
        rcfg, RefRuntime(tp=1), key)[0], jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's tree is the reference's with its stacked axes as lists:
    a VLM's self layers [n_groups, cross_attn_every] in layer order, its
    cross blocks [n_groups]; an enc-dec's encoder and decoder layers."""
    rcfg, cfg = _reduced(arch)
    rparams = _ref_shapes(rcfg)
    params = model.init_params(cfg, Runtime(),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    assert set(params) == set(rparams)
    if cfg.family == "vlm":
        stacks = [(params["layers"]["self"], rparams["layers"]["self"], 2),
                  (params["layers"]["cross"], rparams["layers"]["cross"], 1)]
        assert len(params["layers"]["self"]) == cfg.n_layers
        cross = params["layers"]["cross"][0]
        assert not cross["gate_a"].any() and not cross["gate_m"].any()
    else:
        stacks = [(params["encoder"], rparams["encoder"], 1),
                  (params["layers"], rparams["layers"], 1)]
        assert len(params["encoder"]) == cfg.n_encoder_layers
        assert "xattn" in params["layers"][0]
    for ours, theirs, n_stacked in stacks:
        for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]:
            t = ours[0]
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape[n_stacked:], path


def test_params_from_jax_orders_the_vlm_layers():
    """Group g's self layer j of the reference's [G, k] stack is the
    port's layer g * k + j, for a config of 2 groups of 3."""
    rcfg, cfg = _reduced(VLM)
    rcfg = dataclasses.replace(rcfg, n_layers=6, cross_attn_every=3)
    cfg = dataclasses.replace(cfg, n_layers=6, cross_attn_every=3)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _ref_shapes(rcfg))
    params = convert.params_from_jax(tree, cfg, device="cpu")
    wq = tree["layers"]["self"]["attn"]["wq"]
    assert wq.shape[:2] == (2, 3)
    for g in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                _np(params["layers"]["self"][3 * g + j]["attn"]["wq"]),
                wq[g, j])
        np.testing.assert_array_equal(
            _np(params["layers"]["cross"][g]["xattn"]["wk"]),
            tree["layers"]["cross"]["xattn"]["wk"][g])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_layout_matches(arch):
    rcfg, cfg = _reduced(arch)
    rstate = ref_decode.init_decode_state(rcfg, RefRuntime(tp=1), 3, 20)
    state = decode.init_decode_state(cfg, Runtime(), 3, 20, device="cpu")
    want = convert.decode_state_from_jax(jax.tree.map(np.asarray, rstate),
                                         device="cpu")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(state[part][name].shape) == \
                tuple(want[part][name].shape)
            assert state[part][name].dtype == torch.float32
            assert not state[part][name].any()


def test_full_size_state_layouts():
    """At full size, bf16: llama-3.2-vision-11b's 40 self layers and 8
    cross blocks over 1600 patches; seamless-m4t-large-v2's 24 decoder
    layers, each with a cross cache over 4096 frames."""
    vlm = decode.init_decode_state(get_config(VLM), Runtime(), 4, 2048,
                                   device="meta")
    assert tuple(vlm["self"]["k"].shape) == (40, 4, 2048, 8, 128)
    assert tuple(vlm["cross"]["v"].shape) == (8, 4, 1600, 8, 128)
    assert vlm["self"]["k"].dtype == torch.bfloat16
    ed = decode.init_decode_state(get_config(ENCDEC), Runtime(), 4, 512,
                                  device="meta")
    assert tuple(ed["self"]["v"].shape) == (24, 4, 512, 16, 64)
    assert tuple(ed["cross"]["k"].shape) == (24, 4, 4096, 16, 64)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
def test_forward_logits_match(pair):
    rcfg, rparams, cfg, params = pair
    rb, tb = _batches(_tokens(cfg, 5, 2, 13), _frontend(cfg, 6, 2))
    want = ref_model.forward_logits(rcfg, RefRuntime(tp=1), rparams, rb)
    got = model.forward_logits(cfg, Runtime(), params, tb)
    assert tuple(got.shape) == want.shape == (2, 12, cfg.padded_vocab(1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lengths", [None, (16, 9)])
def test_prefill_logits_and_state_match(pair, lengths):
    rcfg, rparams, cfg, params = pair
    rb, tb = _batches(_tokens(cfg, 7, 2, 16), _frontend(cfg, 8, 2))
    rl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    want, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams, rb,
                                      24, lengths=rl)
    got, state = decode.prefill(cfg, Runtime(), params, tb, 24, lengths=tl)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _close_states(state, rstate)


@pytest.mark.parametrize("lengths", [(16, 16), (16, 9)])
def test_decode_steps_match(pair, lengths):
    """Prefill, then three decode steps, each on the state the step before
    left (updated in place in the port): scalar positions for equal
    lengths, per-sequence positions for ragged ones. The cross K / V stay
    what prefill wrote."""
    rcfg, rparams, cfg, params = pair
    rrt, rt = RefRuntime(tp=1), Runtime()
    lengths = np.array(lengths, np.int32)
    ragged = lengths.min() != lengths.max()
    rb, tb = _batches(_tokens(cfg, 9, 2, 16), _frontend(cfg, 10, 2))
    _, rstate = ref_decode.prefill(
        rcfg, rrt, rparams, rb, 24,
        lengths=jnp.asarray(lengths) if ragged else None)
    _, state = decode.prefill(cfg, rt, params, tb, 24,
                              lengths=torch.from_numpy(lengths) if ragged
                              else None)
    cross_k = state["cross"]["k"].clone()
    for i in range(3):
        tok = _tokens(cfg, 30 + i, 2, 1)
        pos = lengths + i if ragged else np.int32(16 + i)
        want, rstate = ref_decode.decode_step(
            rcfg, rrt, rparams, jnp.asarray(tok), jnp.asarray(pos), rstate)
        k_before = state["self"]["k"]
        got, state = decode.decode_step(cfg, rt, params,
                                        torch.from_numpy(tok),
                                        torch.as_tensor(pos), state)
        assert state["self"]["k"] is k_before               # in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert torch.equal(state["cross"]["k"], cross_k)
    _close_states(state, rstate)


@pytest.mark.parametrize("decode_impl", ["chunked", "dense"])
def test_decode_step_on_the_reference_state(pair, decode_impl):
    """A decode step from the reference's own state, handed over through
    :func:`convert.decode_state_from_jax`."""
    rcfg, rparams, cfg, params = pair
    rb, _ = _batches(_tokens(cfg, 11, 2, 10), _frontend(cfg, 12, 2))
    _, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams, rb, 16)
    tok = _tokens(cfg, 13, 2, 1)
    want, rs = ref_decode.decode_step(
        rcfg, RefRuntime(tp=1, decode_impl=decode_impl), rparams,
        jnp.asarray(tok), jnp.int32(10), rstate)
    got, st = decode.decode_step(
        cfg, Runtime(decode_impl=decode_impl), params, torch.from_numpy(tok),
        torch.tensor(10), convert.decode_state_from_jax(
            jax.tree.map(np.asarray, rstate), device="cpu"))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _close_states(st, rs)


def test_decode_matches_the_forward(pair):
    """Greedy decode's logits at each new position equal the full-sequence
    forward's over the same tokens, in the port alone."""
    _, _, cfg, params = pair
    toks = _tokens(cfg, 14, 1, 8)
    fe = torch.from_numpy(_frontend(cfg, 15, 1))
    logits, state = decode.prefill(cfg, Runtime(), params,
                                   {"tokens": torch.from_numpy(toks),
                                    "frontend": fe}, 16)
    seq = list(toks[0])
    steps = [logits[0, 0]]
    for i in range(3):
        tok = int(torch.argmax(steps[-1][:cfg.vocab_size]))
        seq.append(tok)
        logits, state = decode.decode_step(
            cfg, Runtime(), params, torch.tensor([[tok]], dtype=torch.int32),
            torch.tensor(8 + i), state)
        steps.append(logits[0, 0])
    full = model.forward_logits(
        cfg, Runtime(), params,
        {"tokens": torch.tensor([seq + [0]], dtype=torch.int32),
         "frontend": fe})
    for i, lg in enumerate(steps):
        np.testing.assert_allclose(_np(lg), _np(full[0, 7 + i]), **TOL)


# ---------------------------------------------------------------------------
# the zero-gate witness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_the_frontend_reaches_the_logits(arch):
    """With the VLM's gates at 0 (its initial state) the frontend changes
    nothing, in both packages; with them set, and always for the enc-dec,
    a second frontend moves the logits far beyond the parity tolerance."""
    def moved(made):
        rcfg, rparams, cfg, params = made
        toks = _tokens(cfg, 16, 2, 9)
        out = []
        for seed in (17, 18):
            rb, tb = _batches(toks, _frontend(cfg, seed, 2))
            out.append((np.asarray(ref_model.forward_logits(
                rcfg, RefRuntime(tp=1), rparams, rb)),
                _np(model.forward_logits(cfg, Runtime(), params, tb))))
        (ra, ta), (rb_, tb_) = out
        return float(np.abs(ra - rb_).max()), float(np.abs(ta - tb_).max())

    ref_moved, port_moved = moved(_make(arch))
    assert ref_moved > 1e-2 and port_moved > 1e-2
    np.testing.assert_allclose(port_moved, ref_moved, rtol=1e-3)
    if arch == VLM:
        assert moved(_make(arch, gates=(("gate_a", 0.0),
                                        ("gate_m", 0.0)))) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# the kernel route: what reaches the flash kernel's op on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def recorded(monkeypatch):
    """Pretend the CPU is the card and record the op's calls, computing
    the kernel's plain version (p rounded to v's dtype for p.v)."""
    calls = []
    monkeypatch.setattr(attn, "_on_card", lambda q: True)

    def op(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1], kw["block_q"],
                      kw["block_k"]))
        return fa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                        scale=kw["scale"], round_p=True)
    monkeypatch.setattr(ops, "flash_attention_op", op)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_the_kernel_route_takes_the_noncausal_calls(recorded, arch):
    """On the card a prefill sends its causal self-attention (one call a
    decoder layer) and its non-causal calls (the VLM's cross blocks; the
    enc-dec's encoder layers and its decoder's cross-attention) to the
    kernel; a decode step sends only its cross-attention, at Sq = 1 over
    the whole memory (its self-attention reads a cache of written rows,
    which the kernel does not mask, and stays plain)."""
    _, _, cfg, params = _make(arch)
    S, F = 12, cfg.frontend_seq
    n_cross = (cfg.n_layers // cfg.cross_attn_every if arch == VLM
               else cfg.n_layers)
    n_enc = cfg.n_encoder_layers if arch == ENCDEC else 0
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 19, 2, S)),
             "frontend": torch.from_numpy(_frontend(cfg, 20, 2))}
    logits, state = decode.prefill(cfg, Runtime(), params, batch, 20)
    assert sorted(c[:3] for c in recorded) == sorted(
        [(True, S, S)] * cfg.n_layers + [(False, F, F)] * n_enc
        + [(False, S, F)] * n_cross)
    plain, _ = decode.prefill(cfg, Runtime(attn_impl="plain"), params,
                              batch, 20)
    assert len(recorded) == cfg.n_layers + n_enc + n_cross
    np.testing.assert_allclose(_np(logits), _np(plain), rtol=2e-5,
                               atol=2e-5)
    recorded.clear()
    decode.decode_step(cfg, Runtime(), params,
                       torch.zeros((2, 1), dtype=torch.int32),
                       torch.tensor(S), state)
    assert [c[:3] for c in recorded] == [(False, 1, F)] * n_cross


def test_flash_tiles_of_the_noncausal_calls():
    """Non-causal bf16 at head dims 128 and 64 takes 128 x 128; a query of
    at most 64 rows (a decode step's cross-attention) 64-row q tiles; the
    causal calls, f32 and (256, 256) keep their tiles."""
    bf16, f32 = torch.bfloat16, torch.float32
    for hd in (128, 64):
        assert attn.flash_tiles(bf16, (hd, hd), False, 1024) == (128, 128)
        assert attn.flash_tiles(bf16, (hd, hd), False, 1) == (64, 128)
        assert attn.flash_tiles(bf16, (hd, hd), True, 1024) == \
            attn.FLASH_TILES[bf16]
        assert fa.unsupported(2, hd, hd, 128, 128) is None
        assert fa.unsupported(2, hd, hd, 64, 128) is None
    assert attn.flash_tiles(bf16, (256, 256), False, 1) == (64, 64)
    assert attn.flash_tiles(bf16, (256, 256), False, 1024) == (64, 64)
    assert attn.flash_tiles(f32, (128, 128), False, 1) == attn.FLASH_TILES[f32]
    assert attn.flash_tiles(bf16, (128, 128), True, 16) == \
        attn.FLASH_TILES[bf16]


def test_cross_attention_reaches_the_kernel_op_at_its_tiles(recorded):
    """A bf16 cross-attention at the VLM's head dim on the card: the
    prefill's call at 128 x 128, a decode step's at 64 x 128, each equal to
    the plain route within the bf16 rounding of p."""
    _, cfg = _reduced(VLM)
    cfg = dataclasses.replace(cfg, head_dim=128, dtype="bfloat16")
    p = attn.attention_params(ParamMaker(torch.Generator().manual_seed(0),
                                         "bfloat16", torch.device("cpu")),
                              "xattn", cfg, cross=True)
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((2, 70, 64))).bfloat16()
    mem = torch.from_numpy(rng.standard_normal((2, 40, 64))).bfloat16()
    got, (k, v) = attn.cross_attention(p, cfg, x, mem, return_cache=True)
    step = attn.decode_cross_attention(p, cfg, x[:, -1:], {"k": k, "v": v})
    assert [c[3:] for c in recorded] == [(128, 128), (64, 128)]
    want = attn.cross_attention(p, cfg, x, mem, impl="plain").float()
    for out, ref in ((got, want), (step, want[:, -1:])):
        np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                                   rtol=2e-2,
                                   atol=1e-2 * float(ref.abs().max()))


def test_launches_by_head_dims_sum_the_call_shapes():
    """The enc-dec's prefill counted by call shape (24 encoder, 24 causal
    self and 24 cross launches) sums to 24 causal and 48 non-causal at
    64x64."""
    by_shape = {fa.launch_key(64, 64, False, 4096, 4096): 24,
                fa.launch_key(64, 64, True, 256, 256): 24,
                fa.launch_key(64, 64, False, 256, 4096): 24}
    assert list(by_shape) == ["64x64/noncausal q4096 kv4096",
                              "64x64 q256 kv256",
                              "64x64/noncausal q256 kv4096"]
    assert ops.flash_launches_by_head_dims(by_shape) == {
        "64x64": 24, "64x64/noncausal": 48}


def test_no_kernel_launch_on_cpu_tensors():
    _, _, cfg, params = _make(ENCDEC)
    ops.reset_launch_counts()
    decode.prefill(cfg, Runtime(), params,
                   {"tokens": torch.from_numpy(_tokens(cfg, 21, 1, 6)),
                    "frontend": torch.from_numpy(_frontend(cfg, 22, 1))}, 8)
    assert ops.launch_counts()["flash_attention"] == 0
    assert fa.LAUNCHES_BY_SHAPE == ops.flash_launches_by_head_dims() == {}


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------
def _requests(cfg, lengths, budget, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32),
                    max_new_tokens=budget) for n in lengths]


@pytest.mark.parametrize("lengths", [(9, 9, 9), (5, 12, 9)])
def test_generate_extra_batch_matches_the_reference(pair, lengths,
                                                    monkeypatch):
    """ServeEngine.generate with a frontend in ``extra_batch`` takes the
    lock-step route and gives the reference's greedy tokens, at equal and
    at ragged prompt lengths (per-sequence prefill logits and decode
    positions); generate_blocking gives the same."""
    rcfg, rparams, cfg, params = pair

    def no_slot_pool(*args, **kw):
        raise AssertionError("a call with a frontend took the slot pool")
    monkeypatch.setattr(ServeEngine, "_generate_continuous", no_slot_pool)
    reqs = _requests(cfg, lengths, 6, seed=len(set(lengths)))
    fe = _frontend(cfg, 23, len(reqs))
    reng = ref_serving.ServeEngine(rcfg, RefRuntime(tp=1), rparams,
                                   max_len=MAX_LEN)
    want = reng.generate([ref_serving.Request(r.prompt, r.max_new_tokens)
                          for r in reqs], extra_batch={
                              "frontend": jnp.asarray(fe)})
    eng = ServeEngine(cfg, Runtime(), params, max_len=MAX_LEN)
    got = eng.generate(reqs, extra_batch={"frontend": torch.from_numpy(fe)})
    again = eng.generate_blocking(reqs, extra_batch={"frontend": fe})
    for g, a, w in zip(got, again, want):
        assert g.shape == (6,)
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(a, g)


def test_a_dense_call_with_extra_batch_takes_the_lock_step_route(
        monkeypatch):
    """As in the reference, any call with an ``extra_batch`` takes the
    lock-step route, a slot family's too; what the trunk does not read
    changes nothing."""
    _, cfg = _reduced("qwen2.5-14b")
    params = model.init_params(cfg, Runtime(),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    eng = ServeEngine(cfg, Runtime(), params, max_len=MAX_LEN)
    reqs = _requests(cfg, (6, 6), 3)
    want = eng.generate(reqs)

    def no_slot_pool(*args, **kw):
        raise AssertionError("a call with extra_batch took the slot pool")
    monkeypatch.setattr(ServeEngine, "_generate_continuous", no_slot_pool)
    got = eng.generate(reqs, extra_batch={"unused": np.zeros(3)})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_slot_pool_rejects_the_family(arch):
    """The slot pool (and so serve(), which drives one) holds no memory for
    cross-attention: it refuses both families, as the reference's does."""
    _, _, cfg, params = _make(arch)
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousEngine(cfg, Runtime(), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(capsys, arch):
    """``launch/serve.py --reduced --device cpu``: a stub frontend drawn
    after the prompts, the lock-step route, the session's summary."""
    out = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "6",
                          "--new-tokens", "3", "--max-len", "32",
                          "--policy", "energy-aware"])
    assert len(out["outputs"]) == 2
    assert all(o.shape == (3,) for o in out["outputs"])
    assert out["summary"]["policy"] == "energy-aware"
    assert out["summary"]["steps"] == 3
    assert "savings" in capsys.readouterr().out


def test_check_family_refuses_an_unknown_family():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              family="nope")
    with pytest.raises(ValueError, match="unknown family"):
        model.init_params(cfg, Runtime(), device="cpu")
    assert set(tfm.FAMILIES) == {"dense", "moe", "ssm", "hybrid", "vlm",
                                 "encdec"}
