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
    """q and k in whole chunks of WIDE_CHUNK columns, v in slices of at
    most 256 columns at the least slice class that holds an even share of
    them; every dtype has a tile the model picks, and the class pair is the
    widths the kernels compute."""
    chunks, cls, slices = fa.wide_split(D, Dv)
    assert fa.is_wide(D, Dv)
    assert (chunks - 1) * fa.WIDE_CHUNK < D <= chunks * fa.WIDE_CHUNK
    assert cls in fa.WIDE_SLICE_CLASSES and (slices - 1) * cls < Dv <= \
        slices * cls
    assert slices == -(-Dv // fa.MAX_CLASS_DIM)
    assert fa.head_dim_class(D, Dv) == (chunks * fa.WIDE_CHUNK,
                                        slices * cls)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for causal, seq_q in ((True, 1024), (False, 1)):
            tiles = attn.flash_tiles(dtype, (D, Dv), causal, seq_q)
            assert tiles in fa.WIDE_TILES[dtype.itemsize]
            assert fa.unsupported(dtype.itemsize, D, Dv, *tiles) is None


def test_chunked_shared_memory_formula():
    """The chunked kernels' shared memory: f32 the tiles at D = WIDE_CHUNK
    and Dv the slice class, or the merge where that is larger (32 x 64 at
    a slice of 256); bf16 / f16 a ring of as many 32 KB stages as fit (a
    chunk of Q and of K at 64 x 64), two mbarriers each and the slack."""
    assert fa.wide_split(512, 512) == (4, 256, 2)
    tiles = 4 * (2 * 64 * 128 + 64 * 144 + 64 * 260)
    assert fa.smem_bytes(4, 512, 64, 64, 512) == tiles == 168960
    merge = 4 * (8 * 16 * (256 + 12) + 32)
    assert fa.smem_bytes(4, 512, 32, 64, 512) == merge == 137344
    assert fa.smem_bytes(4, 300, 32, 64, 64) == 4 * (
        2 * 32 * 128 + 64 * 144 + 64 * 68)
    assert fa.wide_stages(64, 64, 256) == 7
    for dv in (64, 300, 1024):
        assert fa.smem_bytes(2, 600, 64, 64, dv) == 7 * 32768 + 7 * 16 + 1024
        assert fa.smem_bytes(2, 600, 64, 64, dv) <= fa.SMEM_LIMIT_BYTES


def test_cost_charges_s_recomputed_per_value_slice():
    """The chunked kernels' cost: 2 (D n_slices + Dv) flops a visited
    entry, q and k read once a slice, q once for each kv tile it visits;
    the function's need (the bound) stays 2 (D + Dv) an entry."""
    bh, S, D, Dv, bq, bk = 8, 256, 512, 640, 64, 64
    entries, kv_rows, pairs = fa.flash_attention_work(
        S, S, causal=True, block_q=bq, block_k=bk)
    _, _, slices = fa.wide_split(D, Dv)
    assert slices == 3
    flops, byts = fa.flash_attention_cost(bh, S, S, D, Dv, 2, causal=True,
                                          block_q=bq, block_k=bk)
    assert flops == 2.0 * bh * entries * (D * slices + Dv)
    q_rows = sum(bq * (i + 1) for i in range(S // bq))   # causal tiles
    assert q_rows == pairs * bq
    assert byts == 2 * bh * (q_rows * D * slices + S * Dv
                             + kv_rows * (D * slices + Dv))
    need, _ = fa.attention_need(1, bh, bh, S, S, D, Dv, 2, True)
    assert need == 2.0 * bh * S * (S + 1) // 2 * (D + Dv) < flops
    # at head dims up to 256 nothing changes: one slice, q read once
    flops, byts = fa.flash_attention_cost(bh, S, S, 128, 128, 2, causal=True,
                                          block_q=bq, block_k=bk)
    assert flops == 2.0 * bh * entries * 256
    assert byts == 2 * bh * (S * 256 + kv_rows * 256)


@pytest.mark.parametrize("head_dim", [320, 512, 1024])
def test_flash_space_keeps_candidates_at_wide_head_dims(head_dim):
    """FlashAttentionSpace at head dims above 256 keeps the chunked f32
    kernel's tiles, where the reference's space keeps candidates too, and
    tune() validates them on the CPU against kernels.ref within the
    space's 2e-5."""
    args = dict(batch_heads=2, seq_q=256, head_dim=head_dim)
    space = FlashAttentionSpace(chip=H100_SXM, device="cpu", **args)
    ref = ref_tuning.FlashAttentionSpace(chip=ref_hw.CHIPS["tpu-v5e"],
                                         **args)
    kept = [c.config_dict for c in space.candidates()]
    assert kept == [dict(block_k=64, block_q=32), dict(block_k=64,
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
