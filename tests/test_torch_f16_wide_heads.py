"""float16 and head dims above 256: the port's flash attention, its model
in ``ModelConfig(dtype="float16")``, its tuning space and its cost, against
the reference package on the CPU.

The reference's Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it; the port's op runs the kernels' plain
version on CPU tensors (p rounded to v's dtype for p.v, as the kernels and
the reference kernel round it). The CUDA kernels themselves run only on a
card; ``chip_smoke.py`` holds them against this plain version there.

Tolerances. Attention, against the reference kernel on the same numpy
inputs: f32 2e-5 (the reference's own: the sums run in another order);
bf16 ``2e-3 + 1e-2 * |want|`` (one bf16 step of the output is at most
2**-7 of it); f16 ``2.5e-4 + 1.25e-3 * |want|``, bf16's limit scaled by
f16's 8x finer step (2**-11 against 2**-8) — the worst case here reaches
0.6 of it. The float16 model, against the reference's on shared weights:
logits within 8e-3, four f16 steps (2**-9) of a logit in [2, 4), the
binade every reduced config's logits reach (the largest gap seen is 4.2e-3,
dbrx-132b's prefill)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tuning as ref_tuning
from repro.configs import get_config as ref_get_config
from repro.core import hardware as ref_hw
from repro.kernels import ops as ref_ops
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import decode, model
from repro_torch.models.common import torch_dtype
from repro_torch.models.transformer import Runtime
from repro_torch.optim import adamw
from repro_torch.tuning import FlashAttentionSpace, tune

#: (atol, rtol) against the reference kernel, by dtype (module docstring)
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-3, 1e-2),
            "float16": (2.5e-4, 1.25e-3)}
#: the float16 model's logits against the reference's (module docstring)
F16_LOGIT_ATOL = 8e-3
#: every family the reference runs in float16, reduced
F16_ARCHS = ("qwen2.5-14b", "stablelm-12b", "dbrx-132b", "deepseek-v3-671b",
             "mamba2-2.7b", "recurrentgemma-2b", "llama-3.2-vision-11b",
             "seamless-m4t-large-v2")


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _against_reference_kernel(dtype, D, Dv, causal, Hq=4, Hkv=2, Sq=128,
                              Skv=128):
    """The port's op (the model's tiles for these head dims) and the
    reference's (64 x 64 tiles) on the same numpy inputs, in f32."""
    arrays = [_normal(7 * D + Dv + i, 2, S, h, w) for i, (S, h, w) in
              enumerate(((Sq, Hq, D), (Skv, Hkv, D), (Skv, Hkv, Dv)))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in arrays)
    want = ref_ops.flash_attention_op(jq, jk, jv, causal=causal, block_q=64,
                                      block_k=64)
    tiles = attn.flash_tiles(getattr(torch, dtype), (D, Dv), causal, Sq)
    assert fa.unsupported(tq.element_size(), D, Dv, *tiles) is None
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, block_q=tiles[0],
                                 block_k=tiles[1])
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape == (2, Sq, Hq, Dv)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Dv", [(24, 16), (64, 64), (96, 96), (128, 128),
                                  (192, 128), (256, 256), (128, 64)])
def test_f16_op_matches_reference_kernel(D, Dv, causal):
    """float16 at several head-dim classes, GQA (4 q heads over 2 kv heads)
    and Dv != D, causal and not: within f16's limit of the reference kernel,
    which rounds p to f16 as the port's kernel does."""
    got, want = _against_reference_kernel("float16", D, Dv, causal)
    atol, rtol = ATTN_TOL["float16"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D,Dv", [(320, 384), (576, 512), (300, 64)])
def test_wide_op_matches_reference_kernel(D, Dv, dtype):
    """Head dims above 256 (the chunked kernels' case) in every dtype,
    causal with GQA, and non-causal with Sq != Skv: within each dtype's
    limit of the reference kernel."""
    atol, rtol = ATTN_TOL[dtype]
    for causal, Sq, Skv in ((True, 128, 128), (False, 64, 128)):
        got, want = _against_reference_kernel(dtype, D, Dv, causal, Sq=Sq,
                                              Skv=Skv)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("D,Dv", [(257, 257), (300, 64), (64, 300),
                                  (320, 384), (512, 512), (576, 512),
                                  (1024, 1024)])
def test_wide_split_states_the_chunked_kernels(D, Dv):
    """q and k in whole chunks of WIDE_CHUNK columns; v in slices of at
    most WIDE_MAX_SLICE = 512 columns (one slice up to Dv = 512, so S is
    computed once a kv tile) at the least slice class that holds an even
    share of them; every dtype has a tile the model picks, and the class
    pair is the widths the kernels compute."""
    chunks, cls, slices = fa.wide_split(D, Dv)
    assert fa.is_wide(D, Dv)
    assert fa.WIDE_SLICE_CLASSES == (128, 256, 512)
    assert (chunks - 1) * fa.WIDE_CHUNK < D <= chunks * fa.WIDE_CHUNK
    assert cls in fa.WIDE_SLICE_CLASSES and (slices - 1) * cls < Dv <= \
        slices * cls
    assert slices == -(-Dv // fa.WIDE_MAX_SLICE)
    assert (slices == 1) == (Dv <= 512)
    assert fa.head_dim_class(D, Dv) == (chunks * fa.WIDE_CHUNK,
                                        slices * cls)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for causal, seq_q in ((True, 1024), (False, 1)):
            tiles = attn.flash_tiles(dtype, (D, Dv), causal, seq_q)
            assert tiles in fa.WIDE_TILES[dtype.itemsize]
            assert fa.unsupported(dtype.itemsize, D, Dv, *tiles) is None


def test_chunked_shared_memory_formula():
    """The chunked kernels' shared memory, byte for byte with the sources'
    SmemChunked / WideLayout. wgmma (64 x 64, stages of 16 KB): 10240
    bytes of slack, P, the rows' factors and sums and the mbarriers; the V
    tile (a stage a 128-column piece), twice where two fit beside three K
    stages (four where Q streams); Q held (a stage a chunk) where it fits
    beside one V tile and two K stages; the K ring as many stages as fit,
    at most 8. f32: n_v + 2 stages of bk rows of 144 floats, P's two TF32
    parts, the row statistics, and Q's chunks (bq rows of 144 floats) held
    where they fit, else two chunk buffers."""
    assert fa.wide_split(512, 512) == (4, 512, 1)
    assert fa.wide_split(576, 512) == (5, 512, 1)
    assert fa.wide_split(300, 64) == (3, 128, 1)
    assert fa.wide_split(64, 300) == (1, 512, 1)
    assert fa.wide_split(1024, 1024) == (8, 512, 2)
    assert fa.wide_split(512, 640) == (4, 512, 2)
    s_ = fa.WIDE_SLOT_BYTES
    assert s_ == 16384
    fixed = 1024 + 2 * 64 * 64 + 2 * 64 * 4 + 512
    # (D, Dv): (q held, K stages, V tiles, bytes): Q + K ring + V tiles
    want = {(512, 512): (True, 5, 1, fixed + (4 + 5 + 4) * s_),
            (576, 512): (True, 4, 1, fixed + (5 + 4 + 4) * s_),
            (896, 512): (True, 2, 1, fixed + (7 + 2 + 4) * s_),
            (897, 512): (False, 5, 2, fixed + (5 + 8) * s_),
            (1024, 1024): (False, 5, 2, fixed + (5 + 8) * s_),
            (300, 64): (True, 8, 2, fixed + (3 + 8 + 2) * s_),
            (64, 300): (True, 4, 2, fixed + (1 + 4 + 8) * s_),
            (1281, 64): (False, 8, 2, fixed + (8 + 2) * s_)}
    for (D, Dv), layout in want.items():
        assert fa.wide_layout(2, D, Dv, 64, 64) == layout, (D, Dv)
    stage, q32, q64 = 4 * 32 * 144, 4 * 32 * 144, 4 * 64 * 144
    # six ring stages at a slice of 512
    rest32 = 6 * stage + 4 * 2 * 32 * 32 + 4 * (2 * 4 + 2) * 32
    assert fa.wide_layout(4, 512, 512, 32, 32) == (True, 6, 1,
                                                   rest32 + 4 * q32)
    assert fa.wide_layout(4, 768, 512, 32, 32)[0]
    assert fa.wide_layout(4, 769, 512, 32, 32) == (False, 6, 1,
                                                   rest32 + 2 * q32)
    rest64 = 6 * stage + 4 * 2 * 64 * 32 + 4 * (2 * 2 + 2) * 64
    assert fa.wide_layout(4, 512, 512, 64, 32) == (False, 6, 1,
                                                   rest64 + 2 * q64)
    assert fa.wide_layout(4, 300, 64, 64, 32) == (
        True, 3, 1, 3 * stage + 4 * 2 * 64 * 32 + 4 * 6 * 64 + 3 * q64)
    for it, bq, bk in ((2, 64, 64), (4, 32, 32), (4, 64, 32)):
        for D, Dv in ((512, 512), (576, 512), (1024, 1024), (300, 64)):
            assert fa.smem_bytes(it, D, bq, bk, Dv) == \
                fa.wide_layout(it, D, Dv, bq, bk)[3] <= fa.SMEM_LIMIT_BYTES


def test_every_wide_pair_has_a_tile_that_fits():
    """Every wide pair chip_smoke.py holds on the card, in every dtype, has
    a built tile (the model's among them) whose shared memory fits in the
    227 KB a block can have; so does every width up to 2048 at every built
    tile."""
    import chip_smoke
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        it = dtype.itemsize
        for D, Dv in chip_smoke.FLASH_WIDE_DIMS:
            tiles = [t for t in fa.WIDE_TILES[it]
                     if fa.unsupported(it, D, Dv, *t) is None]
            assert attn.flash_tiles(dtype, (D, Dv)) in tiles
            assert all(fa.smem_bytes(it, D, bq, bk, Dv)
                       <= fa.SMEM_LIMIT_BYTES for bq, bk in tiles)
        for w in range(257, 2049, 37):
            for bq, bk in fa.WIDE_TILES[it]:
                assert fa.unsupported(it, w, w, bq, bk) is None
                assert fa.unsupported(it, w, 64, bq, bk) is None


def _wide_dims():
    import chip_smoke
    return chip_smoke.FLASH_WIDE_DIMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D,Dv", _wide_dims())
def test_entry_points_take_their_default_tiles(D, Dv, dtype):
    """A call that names no tile takes ``default_tiles``, built at every
    wide pair chip_smoke.py holds on the card: the entry points refuse a
    tensor on neither the CPU nor the card for its device alone, and on
    the CPU they run the plain version at those tiles. The reference
    signature's divisibility rule still counts 64 x 64 blocks."""
    it = dtype.itemsize
    tiles = fa.default_tiles(it, D, Dv)
    assert fa.unsupported(it, D, Dv, *tiles) is None
    assert tiles == ((64, 64) if (64, 64) in fa.WIDE_TILES[it]
                     else fa.WIDE_TILES[it][-1])
    assert fa.default_tiles(it, 128, 128) == (fa.DEFAULT_BLOCK_Q,
                                              fa.DEFAULT_BLOCK_K)
    meta = [torch.empty((1, 16, 2, w), dtype=dtype, device="meta")
            for w in (D, D, Dv)]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ops.flash_attention_op(*meta)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention(*(t[:, :, 0] for t in meta))
    q, k, v = (torch.from_numpy(_normal(70 + i, 1, 48, 1, w)).to(dtype)
               for i, w in enumerate((D, D, Dv)))
    want = fa.flash_attention_plain(q, k, v, block_q=tiles[0],
                                    block_k=tiles[1], round_p=True)
    assert torch.equal(ops.flash_attention_op(q, k, v), want)
    assert torch.equal(fa.flash_attention(q[:, :, 0], k[:, :, 0],
                                          v[:, :, 0]), want[:, :, 0])


def test_cost_charges_s_recomputed_per_value_slice():
    """The chunked kernels' cost: 2 (D n_slices + Dv) flops a visited
    entry, where n_slices is 1 up to Dv = 512 (S computed once a kv tile)
    and 2 at Dv = 640; q and k read once a slice, q once where the block
    holds it and once for each kv tile it visits where it streams; the
    function's need (the bound) stays 2 (D + Dv) an entry."""
    bh, S, bq, bk = 8, 256, 64, 64
    entries, kv_rows, pairs = fa.flash_attention_work(
        S, S, causal=True, block_q=bq, block_k=bk)
    q_rows = sum(bq * (i + 1) for i in range(S // bq))   # causal tiles
    assert q_rows == pairs * bq
    for D, Dv in ((512, 512), (576, 512), (300, 64)):
        assert fa.wide_split(D, Dv)[2] == 1
        assert fa.wide_layout(2, D, Dv, bq, bk)[0]
        flops, byts = fa.flash_attention_cost(bh, S, S, D, Dv, 2,
                                              causal=True, block_q=bq,
                                              block_k=bk)
        assert flops == 2.0 * bh * entries * (D + Dv)
        assert byts == 2 * bh * (S * D + S * Dv + kv_rows * (D + Dv))
        need, _ = fa.attention_need(1, bh, bh, S, S, D, Dv, 2, True)
        assert need == 2.0 * bh * S * (S + 1) // 2 * (D + Dv) < flops
    # above 512 columns of v: two slices, each computing S
    D, Dv = 512, 640
    flops, byts = fa.flash_attention_cost(bh, S, S, D, Dv, 2, causal=True,
                                          block_q=bq, block_k=bk)
    assert flops == 2.0 * bh * entries * (2 * D + Dv)
    assert byts == 2 * bh * (S * D * 2 + S * Dv + kv_rows * (2 * D + Dv))
    # Q streamed (f32 at 64 x 32, D = 512): q once a visited kv tile
    assert not fa.wide_layout(4, 512, 512, 64, 32)[0]
    e32, kv32, _ = fa.flash_attention_work(S, S, causal=True, block_q=64,
                                           block_k=32)
    rows32 = sum(64 * (2 * i + 2) for i in range(S // 64))
    flops, byts = fa.flash_attention_cost(bh, S, S, 512, 512, 4,
                                          causal=True, block_q=64,
                                          block_k=32)
    assert flops == 2.0 * bh * e32 * 1024
    assert byts == 4 * bh * (rows32 * 512 + S * 512 + kv32 * 1024)
    # at head dims up to 256 nothing changes: one slice, q read once
    flops, byts = fa.flash_attention_cost(bh, S, S, 128, 128, 2, causal=True,
                                          block_q=bq, block_k=bk)
    assert flops == 2.0 * bh * entries * 256
    assert byts == 2 * bh * (S * 256 + kv_rows * 256)


@pytest.mark.parametrize("head_dim", [320, 512, 1024])
def test_flash_space_keeps_candidates_at_wide_head_dims(head_dim):
    """FlashAttentionSpace at head dims above 256 keeps the chunked f32
    kernel's tiles (its default options are the kernel's there), where the
    reference's space keeps candidates too, and tune() validates them on
    the CPU against kernels.ref within the space's 2e-5."""
    args = dict(batch_heads=2, seq_q=256, head_dim=head_dim)
    space = FlashAttentionSpace(chip=H100_SXM, device="cpu", **args)
    ref = ref_tuning.FlashAttentionSpace(chip=ref_hw.CHIPS["tpu-v5e"],
                                         **args)
    kept = [c.config_dict for c in space.candidates()]
    assert kept == [dict(block_k=32, block_q=32), dict(block_k=32,
                                                       block_q=64)]
    assert len(ref.candidates()) >= 1
    result = tune(space)
    meas = result.measurement
    assert len(meas.candidates) == 2
    assert max(meas.validation_err) <= space.tol


def test_dtype_strings_follow_the_reference():
    """``float16`` is a model dtype as in the reference; a moment dtype
    other than ``bfloat16`` is f32 there, float16 too; an unknown model
    dtype still raises by name."""
    assert torch_dtype("float16") is torch.float16
    with pytest.raises(ValueError, match="unknown dtype 'float64'"):
        torch_dtype("float64")
    params = {"w": torch.zeros(3, 2, dtype=torch.float16)}
    for name in ("float16", "float32", "bfloat16"):
        want = ref_adamw.init_opt_state({"w": jnp.zeros((3, 2))},
                                        moment_dtype=name)["m"]["w"].dtype
        got = adamw.init_opt_state(params, moment_dtype=name)["m"]["w"].dtype
        assert str(got).replace("torch.", "") == str(want)


def _f16_pair(arch):
    """(reference cfg, params; port cfg, params): the reduced config in
    float16, the reference's initial parameters shared with the port."""
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float16")
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, cfg, convert.params_from_jax(tree, cfg,
                                                       device="cpu")


@pytest.mark.parametrize("arch", F16_ARCHS)
def test_float16_model_matches_reference(arch):
    """ModelConfig(dtype="float16"): the port's init has the reference's
    float16 leaves; on shared weights the prefill's and two decode steps'
    logits are float16 within F16_LOGIT_ATOL of the reference's, all
    finite (the decode cache is f32, as the reference's init_decode_state
    keeps it for any dtype but bfloat16; its rows hold the f16 values)."""
    rcfg, rparams, cfg, params = _f16_pair(arch)
    own = model.init_params(cfg, Runtime(tp=1),
                            torch.Generator().manual_seed(0), device="cpu")
    mine, shared = _leaves(own), _leaves(params)
    assert [(t.shape, t.dtype) for t in mine] == \
        [(t.shape, t.dtype) for t in shared]
    assert {str(t.dtype) for t in shared} == {
        f"torch.{a.dtype}" for a in jax.tree.leaves(rparams)}
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    rbatch, batch = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks)}
    if cfg.frontend_seq:
        front = (rng.standard_normal((2, cfg.frontend_seq, cfg.d_model))
                 * 0.02).astype(np.float16)
        rbatch["frontend"] = jnp.asarray(front)
        batch["frontend"] = torch.from_numpy(front)
    want, rstate = ref_decode.prefill(rcfg, RefRuntime(tp=1), rparams,
                                      rbatch, 24)
    got, state = decode.prefill(cfg, Runtime(), params, batch, 24)
    steps = [(got, want)]
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
        want, rstate = ref_decode.decode_step(
            rcfg, RefRuntime(tp=1), rparams, jnp.asarray(tok),
            jnp.int32(16 + i), rstate)
        got, state = decode.decode_step(cfg, Runtime(), params,
                                        torch.from_numpy(tok),
                                        torch.tensor(16 + i), state)
        steps.append((got, want))
    for got, want in steps:
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        w = np.asarray(want, np.float32)
        assert np.isfinite(w).all() and torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=F16_LOGIT_ATOL)


def _leaves(tree):
    """The tensors of a nested dict / list tree, in jax.tree's order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_float16_cross_decode_reaches_the_kernel_in_one_dtype(monkeypatch,
                                                              arch):
    """A float16 VLM's or enc-dec's decode step attends over its memory's
    cache (f32, as the reference's init_decode_state keeps it) in the
    model's dtype: on the card that call is the kernel's case (non-causal,
    Sq = 1), which takes one dtype. With the CPU standing in for the card,
    the step's cross-attention reaches the kernel op with q, k and v all
    float16 and the step's logits equal the plain route's."""
    rcfg, rparams, cfg, params = _f16_pair(arch)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                         dtype=np.int32))
    front = torch.from_numpy((rng.standard_normal(
        (2, cfg.frontend_seq, cfg.d_model)) * 0.02).astype(np.float16))
    _, state = decode.prefill(cfg, Runtime(attn_impl="plain"), params,
                              {"tokens": toks, "frontend": front}, 16)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1),
                                        dtype=np.int32))
    want, _ = decode.decode_step(cfg, Runtime(attn_impl="plain"), params,
                                 tok, torch.tensor(8), state)
    calls = []

    def op(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype, q.shape[1]))
        fa._check_bshd(q, k, v, kw["block_q"], kw["block_k"])
        return fa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                        scale=kw["scale"],
                                        block_q=kw["block_q"],
                                        block_k=kw["block_k"], round_p=True)
    monkeypatch.setattr(attn, "_on_card", lambda q: True)
    monkeypatch.setattr(ops, "flash_attention_op", op)
    got, _ = decode.decode_step(cfg, Runtime(), params, tok,
                                torch.tensor(8), state)
    assert calls and all(c == (torch.float16,) * 3 + (1,) for c in calls)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=F16_LOGIT_ATOL)
