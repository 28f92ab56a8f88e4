"""repro_torch's flash attention on the CPU (its plain version) against the
reference package's Pallas kernel, run in interpret mode as
tests/test_kernels.py runs it, and against both packages' oracles; the
wrapper's argument checks, its dispatch, the kernel's work count and the
model's dispatch of prefill attention.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against this plain version there.

Tolerances (the reference's own, tests/test_kernels.py): 2e-5 for f32 —
the blocked online softmax sums in another order than the naive oracle —
and 2e-2 for bf16, where the reference kernel rounds p to bf16 before p.v
and the port keeps it in f32. bf16 inputs are made in f32 with numpy and
rounded by each package to bf16 (both round to nearest even, so both see
the same values)."""
import jax  # noqa: F401  (the reference's kernel; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.tuning import FlashAttentionSpace as RefFlashAttentionSpace
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.tuning import FlashAttentionSpace

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    tt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(x).astype(getattr(jnp, dtype)), tt


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,bq,bk", [
    (256, 256, 4, 4, 64, 128, 128),
    (256, 256, 4, 2, 64, 64, 128),     # GQA
    (128, 128, 2, 1, 128, 128, 64),    # MQA
    (512, 512, 2, 2, 64, 256, 256),
])
def test_flash_op_matches_reference_kernel(Sq, Skv, Hq, Hkv, D, bq, bk,
                                           dtype):
    q_np = _normal(Sq + Hq, 2, Sq, Hq, D)
    k_np = _normal(Sq + Hq + 1, 2, Skv, Hkv, D)
    v_np = _normal(Sq + Hq + 2, 2, Skv, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype)
                                    for x in (q_np, k_np, v_np))
    want = ref_ops.flash_attention_op(jq, jk, jv, causal=True, block_q=bq,
                                      block_k=bk)
    got = ops.flash_attention_op(tq, tk, tv, causal=True, block_q=bq,
                                 block_k=bk)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, Sq, Hq, D)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # the oracle, on GQA-expanded heads folded into the batch
    G = Hq // Hkv
    fold = (lambda x, S: x.repeat_interleave(G, 2).permute(0, 2, 1, 3)
            .reshape(2 * Hq, S, D))
    oracle = ref.attention_ref(tq.permute(0, 2, 1, 3).reshape(2 * Hq, Sq, D),
                               fold(tk, Skv), fold(tv, Skv), causal=True)
    np.testing.assert_allclose(
        _f32(got), _f32(oracle.reshape(2, Hq, Sq, D).permute(0, 2, 1, 3)),
        rtol=tol, atol=tol)


def test_flash_noncausal_matches_reference_kernel():
    q, k, v = (_normal(70 + i, 1, 128, 2, 32) for i in range(3))
    want = ref_ops.flash_attention_op(q, k, v, causal=False, block_q=64,
                                      block_k=64)
    got = ops.flash_attention_op(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,bq,bk", [(128, 256, 64, 128),
                                          (256, 128, 128, 64)])
def test_flash_causal_sq_ne_skv_is_top_left_aligned(Sq, Skv, bq, bk, dtype):
    """Both positions count from 0: query i sees keys 0..i, whatever Skv
    is (SDPA and FlashAttention-2 align the other way when Sq != Skv)."""
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(Sq + Skv + i, 3, n, 64), dtype)
        for i, n in enumerate((Sq, Skv, Skv)))
    want = ref_fa.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                  block_k=bk)
    got = fa.flash_attention(tq, tk, tv, causal=True, block_q=bq,
                             block_k=bk)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    oracle = ref_ref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=tol, atol=tol)
    # row 0 attends to key 0 alone
    np.testing.assert_allclose(_f32(got)[:, 0], _f32(tv)[:, 0],
                               rtol=tol, atol=tol)


def test_port_oracle_matches_reference_oracle():
    q, k, v = (_normal(90 + i, 2, 64, 32) for i in range(3))
    for causal in (True, False):
        got = ref.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
        want = ref_ref.attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(block_q=64), dict(block_k=64),
                                dict(block_q=0), dict(block_k=1.5)])
def test_blocks_that_do_not_tile_raise(kw):
    q = torch.zeros((2, 96, 32))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, **kw)


def test_argument_checks():
    q = torch.zeros((1, 16, 4, 32))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention_op(q, torch.zeros((1, 16, 3, 32)),
                               torch.zeros((1, 16, 3, 32)))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_op(q, q.double(), q)
    with pytest.raises(ValueError, match=r"\[BH, S, D\]"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="B, Skv"):
        ops.flash_attention_op(q, torch.zeros((1, 16, 4, 16)), q)


def test_a_tensor_off_the_cpu_goes_to_the_kernel():
    """CPU tensors take the plain version; any other device goes to the
    CUDA kernel, which refuses what is not a CUDA tensor (no fallback)."""
    meta = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention_op(meta, meta, meta)
    ops.reset_launch_counts()
    cpu = torch.ones((1, 64, 2, 64))
    ops.flash_attention_op(cpu, cpu, cpu)
    assert ops.launch_counts()["flash_attention"] == 0


def test_plain_matches_the_oracle_with_a_tile_longer_than_the_sequence():
    q, k, v = (torch.from_numpy(_normal(30 + i, 2, 48, 1, 64))
               for i in range(3))
    got = fa.flash_attention_plain(q, k, v, block_q=128, block_k=64)
    want = ref.attention_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0])
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (0, 24), (40, 0)])
def test_plain_causal_skip_is_exact(q_offset, window):
    """The plain version skips the kv blocks past each q block's diagonal;
    a kv mask that masks nothing turns the skip off, and the outputs are
    equal bit for bit."""
    q = torch.from_numpy(_normal(33, 1, 96, 4, 32))
    k, v = (torch.from_numpy(_normal(34 + i, 1, 160, 2, 32))
            for i in range(2))
    kw = dict(causal=True, block_q=32, block_k=32, q_offset=q_offset,
              window=window)
    skipped = fa.flash_attention_plain(q, k, v, **kw)
    full = fa.flash_attention_plain(q, k, v, kv_valid_len=torch.tensor(160),
                                    **kw)
    assert torch.equal(skipped, full)


@pytest.mark.parametrize("itemsize,D,Dv,bq,bk,why", [
    (4, 128, 128, 32, 128, None),            # the model's f32 tile
    (2, 128, 128, 128, 128, None),           # the model's bf16 tile
    (2, 160, 160, 128, 128, None),           # stablelm-12b's head dim
    (4, 128, 128, 128, 128, "smem-overflow"),
    (4, 96, 96, 64, 64, "not-instantiated"),
    (4, 128, 64, 64, 64, "not-instantiated"),
    (4, 64, 64, 16, 64, "not-instantiated"),
])
def test_support_rules(itemsize, D, Dv, bq, bk, why):
    got = fa.unsupported(itemsize, D, Dv, bq, bk)
    assert got is None if why is None else why in got


@pytest.mark.parametrize("Sq,Skv,bq,bk", [(256, 256, 64, 64),
                                          (128, 512, 32, 128),
                                          (512, 128, 128, 64),
                                          (48, 48, 128, 128)])
def test_work_count_is_what_the_kernel_visits(Sq, Skv, bq, bk):
    entries, kv_rows, pairs = fa.flash_attention_work(
        Sq, Skv, causal=True, block_q=bq, block_k=bk)
    q_tile = np.arange(Sq)[:, None] // bq
    k_tile = np.arange(Skv)[None, :] // bk
    # a pair is visited iff its kv tile starts at or before the q tile's
    # last row
    last_row = np.minimum((q_tile + 1) * bq, Sq) - 1
    visited = k_tile * bk <= last_row
    assert entries == int(visited.sum())
    unmasked = int((np.arange(Skv)[None, :] <= np.arange(Sq)[:, None]).sum())
    assert unmasked <= entries <= Sq * Skv
    full = fa.flash_attention_work(Sq, Skv, causal=False, block_q=bq,
                                   block_k=bk)
    assert full[0] == Sq * Skv
    assert full[1] == -(-Sq // bq) * Skv
    assert pairs <= full[2] == -(-Sq // bq) * -(-Skv // bk)
    assert kv_rows <= full[1]


def test_shared_memory_formula():
    # f32, head dim 128: (64 x 129 + 64 x 129 + 64 x 128) x 4
    #                    + (64 x 65 + 3 x 64) x 4
    assert fa.smem_bytes(4, 128, 64, 64) == 116224
    assert fa.smem_bytes(4, 128, 128, 128) > fa.SMEM_LIMIT_BYTES
    assert fa.smem_bytes(2, 128, 128, 128) <= fa.SMEM_LIMIT_BYTES


def test_noncausal_cost_equals_the_reference_space():
    """Without the causal skip the port's cost model is the reference's:
    the full rectangle, K and V re-read once per q block."""
    ours = FlashAttentionSpace(
        batch_heads=2, seq_q=512, head_dim=64, causal=False,
        block_q_options=(128,), block_k_options=(128,), device="cpu")
    theirs = RefFlashAttentionSpace(batch_heads=2, seq_q=512, head_dim=64,
                                    causal=False, block_q_options=(128,),
                                    block_k_options=(128,))
    (a,), (b,) = ours.candidates(), theirs.candidates()
    assert a.flops == b.flops
    assert a.hbm_bytes == b.hbm_bytes


# ---------------------------------------------------------------------------
# the model's dispatch of prefill attention
# ---------------------------------------------------------------------------
@pytest.fixture
def recorded(monkeypatch):
    """Pretend the CPU is the card, and record the op's calls: the stand-in
    refuses what the kernel refuses (``unsupported`` and the block checks)
    and computes the plain version."""
    calls = []
    monkeypatch.setattr(attn, "_on_card", lambda q: True)

    def op(q, k, v, **kw):
        calls.append(kw)
        why = fa.unsupported(q.element_size(), q.shape[-1], v.shape[-1],
                             kw["block_q"], kw["block_k"])
        if why is not None:
            raise ValueError(why)
        fa._check_bshd(q, k, v, kw["block_q"], kw["block_k"])
        return fa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                        scale=kw["scale"],
                                        block_q=kw["block_q"],
                                        block_k=kw["block_k"])
    monkeypatch.setattr(ops, "flash_attention_op", op)
    return calls


def test_prefill_case_goes_to_the_kernel_and_others_do_not(recorded):
    q, k, v = (torch.from_numpy(_normal(40 + i, 1, 64, 4, 16))
               for i in range(3))
    kv = k[:, :, :2], v[:, :, :2]
    with pytest.raises(ValueError, match="not-instantiated"):
        attn.chunked_attention(q, *kv)       # head dim 16: raises, no plain
    q, k, v = (torch.from_numpy(_normal(40 + i, 1, 64, 4, 64))
               for i in range(3))
    kv = k[:, :, :2], v[:, :, :2]
    recorded.clear()
    out = attn.chunked_attention(q, *kv)
    assert len(recorded) == 1 and recorded[0]["causal"] is True
    assert (recorded[0]["block_q"], recorded[0]["block_k"]) == \
        attn.flash_tiles(torch.float32, 64, 64)
    plain = attn.chunked_attention(q, *kv, impl="plain", q_chunk=16,
                                   kv_chunk=32)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    for kw in (dict(window=8), dict(q_offset=3), dict(causal=False),
               dict(kv_valid_len=torch.tensor(20)), dict(impl="plain")):
        attn.chunked_attention(q, *kv, **kw)
    assert len(recorded) == 1


@pytest.mark.parametrize("dtype,D", [("float32", 128), ("bfloat16", 128),
                                     ("bfloat16", 160)])
def test_causal_prefill_on_the_card_reaches_the_kernel_op(recorded, dtype,
                                                          D):
    """f32 and bf16 prefills at the served head dim (and stablelm-12b's)
    go to ``ops.flash_attention_op`` with tiles the kernel is built for."""
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_normal(60, 1, 256, 4, D)).to(dt)
    k, v = (torch.from_numpy(_normal(61 + i, 1, 256, 1, D)).to(dt)
            for i in range(2))
    out = attn.chunked_attention(q, k, v)
    (kw,) = recorded
    assert fa.unsupported(q.element_size(), D, D, kw["block_q"],
                          kw["block_k"]) is None
    assert (kw["block_q"], kw["block_k"]) == attn.FLASH_TILES[dt]
    plain = attn.chunked_attention(q, k, v, impl="plain")
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(plain), rtol=tol, atol=tol)


def test_a_length_no_tile_divides_raises_on_the_card(recorded):
    q = torch.zeros((1, 300, 2, 128))
    with pytest.raises(ValueError, match="tile"):
        attn.chunked_attention(q, q, q)


@pytest.mark.parametrize("dtype,S,tiles", [
    (torch.bfloat16, 1024, (128, 128)),
    (torch.bfloat16, 16, (128, 128)),        # min(tile, S) = S divides
    (torch.bfloat16, 192, (64, 64)),
    (torch.float32, 1024, (32, 128)),
    (torch.float32, 96, (32, 128)),
    (torch.float32, 300, (32, 128)),         # none divides: the preference
])
def test_flash_tiles(dtype, S, tiles):
    assert attn.flash_tiles(dtype, S, S) == tiles


def test_cpu_tensors_never_reach_the_kernel():
    q = torch.from_numpy(_normal(50, 1, 32, 4, 16))
    ops.reset_launch_counts()
    attn.chunked_attention(q, q[:, :, :2], q[:, :, :2])
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.card
def test_f32_prefill_on_the_card_launches_the_kernel():
    """On a CUDA card: a causal f32 prefill at head dim 128 launches the
    kernel once and agrees with the plain route within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 256, 8, 128), generator=g, device="cuda")
    k, v = (torch.randn((1, 256, 2, 128), generator=g, device="cuda")
            for _ in range(2))
    ops.reset_launch_counts()
    out = attn.chunked_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1
    plain = attn.chunked_attention(q, k, v, impl="plain")
    assert float((out - plain).abs().max()) <= 2e-5
