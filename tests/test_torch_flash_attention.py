"""repro_torch's flash attention on the CPU (its plain version) against the
reference package's Pallas kernel, run in interpret mode as
tests/test_kernels.py runs it, and against both packages' oracles; the
wrapper's argument checks, its dispatch, the kernel's work count and the
model's dispatch of prefill attention.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds
them against this plain version there.

Tolerances (the reference's own, tests/test_kernels.py): 2e-5 for f32 —
the blocked online softmax sums in another order than the naive oracle —
and 2e-2 for bf16, where the model's plain route keeps p in f32 and the
kernels round it to bf16 before p.v. The kernels' plain version rounds p
as they and the reference kernel do, and is held to the reference kernel
within ``2e-3 + 1e-2 * |want|`` (one bf16 step of the output is at most
2**-7 of it). bf16 inputs are made in f32 with numpy and rounded by each
package to bf16 (both round to nearest even, so both see the same
values)."""
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
#: (atol, rtol) of the bf16 plain version, p rounded, against the
#: reference kernel
BF16_ROUNDED_P_TOL = (2e-3, 1e-2)


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


@pytest.mark.parametrize("Sq,Hq,Hkv,D,bq,bk", [
    (256, 4, 2, 64, 128, 64),
    (128, 2, 1, 128, 64, 64),
    (512, 2, 2, 64, 256, 256),
])
def test_bf16_plain_rounds_p_as_the_reference_kernel(Sq, Hq, Hkv, D, bq, bk):
    """With p rounded to bf16 for p.v (``round_p``, what the CPU op runs)
    the plain version is the reference kernel's arithmetic, up to sum
    order: within ``2e-3 + 1e-2 * |want|``, where the route that keeps p in
    f32 differs by a bf16 step of the output and more."""
    arrays = [_normal(Sq + i, 2, Sq, h, D)
              for i, h in enumerate((Hq, Hkv, Hkv))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "bfloat16") for x in arrays)
    want = _f32(ref_ops.flash_attention_op(jq, jk, jv, causal=True,
                                           block_q=bq, block_k=bk))
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, block_q=bq,
                                   block_k=bk, round_p=True)
    atol, rtol = BF16_ROUNDED_P_TOL
    np.testing.assert_allclose(_f32(got), want, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(
        _f32(ops.flash_attention_op(tq, tk, tv, causal=True, block_q=bq,
                                    block_k=bk)), _f32(got))
    # rounding p is a no-op on f32 inputs
    f32 = [torch.from_numpy(x) for x in arrays]
    assert torch.equal(
        fa.flash_attention_plain(*f32, block_q=bq, block_k=bk, round_p=True),
        fa.flash_attention_plain(*f32, block_q=bq, block_k=bk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Hq,Hkv,D,Dv,bq,bk", [
    (128, 2, 2, 48, 32, 64, 64),       # MLA's shape, cut: D = Dv + Dv / 2
    (256, 4, 2, 192, 128, 128, 64),    # MLA's head dims, GQA, two q tiles
])
def test_plain_at_dv_ne_d_matches_reference_kernel(Sq, Hq, Hkv, D, Dv, bq,
                                                   bk, dtype):
    """q/k of head dim D and v of Dv: the reference Pallas kernel (interpret
    mode) returns [B, Sq, Hq, Dv], and so does the port's op on CPU
    tensors, within the reference's tolerance."""
    arrays = [_normal(D + i, 1, Sq, h, w) for i, (h, w) in
              enumerate(((Hq, D), (Hkv, D), (Hkv, Dv)))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in arrays)
    want = ref_ops.flash_attention_op(jq, jk, jv, causal=True, block_q=bq,
                                      block_k=bk)
    got = ops.flash_attention_op(tq, tk, tv, causal=True, block_q=bq,
                                 block_k=bk)
    assert got.shape == want.shape == (1, Sq, Hq, Dv)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":        # p rounded, as the reference kernel
        atol, rtol = BF16_ROUNDED_P_TOL
    else:
        atol = rtol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (32, 32), (96, 96), (24, 16),
                                  (128, 64), (192, 128), (256, 256)])
def test_op_at_any_head_dim_matches_reference_kernel(D, Dv, causal, dtype):
    """At head dims the kernels take only since they take any (each runs at
    its head-dim class), the op against the reference's
    ``ops.flash_attention_op`` (interpret mode) on the same numpy inputs,
    GQA over 4 q heads and 2 kv heads, 2e-5 in f32 and 2e-2 in bf16. On the
    CPU the op runs the kernels' plain version; ``chip_smoke.py`` holds the
    CUDA kernels against that plain version at these head dims."""
    arrays = [_normal(3 * D + Dv + i, 2, 128, h, w) for i, (h, w) in
              enumerate(((4, D), (2, D), (2, Dv)))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in arrays)
    want = ref_ops.flash_attention_op(jq, jk, jv, causal=causal, block_q=64,
                                      block_k=64)
    tiles = attn.flash_tiles(getattr(torch, dtype), (D, Dv), causal, 128)
    assert fa.unsupported(tq.element_size(), D, Dv, *tiles) is None
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, block_q=tiles[0],
                                 block_k=tiles[1])
    assert got.shape == want.shape == (2, 128, 4, Dv)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


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


# ---------------------------------------------------------------------------
# the f32 kernel's arithmetic: 3xTF32 products (emulated on the CPU)
# ---------------------------------------------------------------------------
def _tf32(x) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on the CPU: f32 rounded to TF32's 10 explicit
    mantissa bits, to nearest with ties away from zero (add half of the 13
    dropped bits to the magnitude, then clear them)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _split(x: np.ndarray):
    big = _tf32(x)
    return big, _tf32(x - big)


def _matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the f32 kernel forms it: both operands split into TF32
    big + small, ``a_small b_big + a_big b_small + a_big b_big`` (small
    terms first, small . small dropped), products exact and sums in f32."""
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _matmul_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b from one TF32 product of the rounded operands."""
    return _tf32(a) @ _tf32(b)


def _blocked_attention(q, k, v, *, causal: bool, block_k: int, matmul):
    """q ``[BH, Sq, D]``, k/v ``[BH, Skv, D]`` f32 -> ``[BH, Sq, D]``: the
    online softmax over kv tiles of ``block_k`` (a ragged last tile is
    shorter), top-left causal mask filled with -1e30, both products by
    ``matmul``; everything else in f32."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    scale = np.float32(D ** -0.5)
    qpos = np.arange(Sq)[:, None]
    m = np.full((BH, Sq), -1e30, np.float32)
    l = np.zeros((BH, Sq), np.float32)
    acc = np.zeros((BH, Sq, D), np.float32)
    for k0 in range(0, Skv, block_k):
        kc, vc = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = matmul(q, kc.transpose(0, 2, 1)) * scale
        if causal:
            kpos = np.arange(k0, k0 + kc.shape[1])[None, :]
            s = np.where(kpos <= qpos, s, np.float32(-1e30))
        m_new = np.maximum(m, s.max(-1))
        p = np.exp(s - m_new[..., None])
        corr = np.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + matmul(p, vc)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[..., None]


def test_tf32_rounding_ties_and_signs():
    one = 0x3F800000
    x = np.array([one | 0x1000, one | 0xFFF, one | 0x1001, one | 0x2000,
                  one | 0x3000, 0x3FFFFFFF, 0, 0x80000000],
                 np.uint32).view(np.float32)
    want = np.array([one + 0x2000, one, one + 0x2000, one + 0x2000,
                     one + 0x4000, 0x40000000, 0, 0x80000000],
                    np.uint32).view(np.float32)
    got = _tf32(x)
    # a tie (half of the dropped bits) rounds away from zero, in both signs;
    # a carry reaches the exponent; zeros keep their sign
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(_tf32(-x).view(np.uint32),
                                  (-want).view(np.uint32))
    r = _normal(5, 4096) * np.float32(1e3)
    big, small = _split(r)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(r - big) <= np.abs(r) * 2.0 ** -11)
    # big + small is x to about 2^-22 of it
    assert np.all(np.abs(r - (big + small)) <= np.abs(r) * 2.0 ** -21)


#: (BH, Sq, Skv, D, causal, block_k of the emulation, block of the
#: reference kernel)
_TF32_CASES = {
    "spaces_reduced": (2, 256, 256, 128, True, 128, 128),
    "sq_ne_skv": (2, 128, 256, 64, True, 64, 64),
    "noncausal": (2, 128, 128, 64, False, 64, 64),
    "head_dim_160": (1, 128, 128, 160, True, 64, 64),
    "ragged_300": (1, 300, 300, 64, True, 64, 100),
}


def _tf32_case(name):
    BH, Sq, Skv, D, causal, bk, ref_block = _TF32_CASES[name]
    seed = sum(map(ord, name))
    q = _normal(seed, BH, Sq, D)
    k, v = (_normal(seed + i, BH, Skv, D) for i in (1, 2))
    want = np.asarray(ref_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=ref_block, block_k=ref_block))
    return (q, k, v), causal, bk, want


@pytest.mark.parametrize("name", sorted(_TF32_CASES))
def test_3xtf32_attention_meets_the_reference_kernel(name):
    """The f32 kernel's products, 3xTF32 over f32 sums, in the kernel's
    blocked online softmax, meet the reference Pallas kernel (interpret
    mode) within the f32 contract of 2e-5."""
    qkv, causal, bk, want = _tf32_case(name)
    got = _blocked_attention(*qkv, causal=causal, block_k=bk,
                             matmul=_matmul_3xtf32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(_TF32_CASES))
def test_single_tf32_product_misses_the_contract(name):
    """Why the split is there: with one TF32 product for each of Q K^T and
    P V, the same blocked attention on the same inputs errs by more than
    2e-5."""
    qkv, causal, bk, want = _tf32_case(name)
    got = _blocked_attention(*qkv, causal=causal, block_k=bk,
                             matmul=_matmul_tf32)
    assert np.abs(got - want).max() > 2e-5


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
    (2, 64, 64, 64, 64, None),               # one consumer warpgroup
    (4, 128, 128, 128, 128, "smem-overflow"),
    (4, 160, 160, 32, 128, None),            # D = 160 at 32 rows
    (4, 160, 160, 64, 128, "smem-overflow"),  # Q split in two does not fit
    (4, 160, 160, 128, 64, "smem-overflow"),
    (4, 64, 64, 128, 128, None),
    (4, 96, 96, 64, 64, None),               # the (96, 96) class
    (4, 128, 64, 64, 64, None),              # Dv != D: the (128, 128) class
    (4, 64, 64, 16, 64, "not-instantiated"),
    (2, 128, 128, 32, 64, "not-instantiated"),   # bf16: 64 rows a warpgroup
    (2, 128, 128, 128, 256, "not-instantiated"),
    # MLA prefill: q/k of 192, v of 128, at every tile that fits
    (2, 192, 128, 128, 64, None),
    (2, 192, 128, 128, 128, None),
    (2, 192, 128, 64, 64, None),
    (2, 192, 128, 64, 128, None),
    (4, 192, 128, 64, 64, None),             # f32 at Dv != D
    (4, 192, 128, 64, 128, "smem-overflow"),
    (2, 192, 192, 64, 64, None),             # the (192, 192) class
    (2, 192, 192, 128, 128, "smem-overflow"),
    (2, 128, 192, 64, 64, None),             # runs at (192, 192)
    (2, 128, 64, 64, 64, None),              # runs at (128, 128)
    # RecurrentGemma's local attention: head dim 256; the 128-row kv tiles
    # overflow shared memory even with two stages, and bf16's 128 x 64
    # fits but spills registers, so 64 x 64 is the one bf16 tile built
    (2, 256, 256, 128, 64, "spills"),
    (2, 256, 256, 64, 64, None),
    (2, 256, 256, 128, 128, "smem-overflow"),
    (2, 256, 256, 64, 128, "smem-overflow"),
    (4, 256, 256, 32, 64, None),             # f32: 32 x 64 alone fits
    (4, 256, 256, 64, 64, "smem-overflow"),
    (2, 256, 128, 64, 64, None),             # runs at (256, 256)
    (2, 200, 200, 128, 64, "spills"),        # (256, 256)'s rule
    # wider than the widest class: the chunked kernels, at their tiles
    (2, 257, 64, 64, 64, None),
    (4, 64, 300, 32, 32, None),
    (4, 64, 300, 32, 64, "not-instantiated"),
    (2, 300, 64, 128, 64, "not-instantiated"),
    (4, 1024, 1024, 64, 32, None),
    (4, 1024, 1024, 64, 64, "not-instantiated"),
    (4, 512, 512, 128, 64, "not-instantiated"),
    (4, 0, 64, 32, 64, "head-dim-range"),
])
def test_support_rules(itemsize, D, Dv, bq, bk, why):
    got = fa.unsupported(itemsize, D, Dv, bq, bk)
    assert got is None if why is None else why in got
    q_opts, k_opts = fa.tile_options(itemsize, D, Dv)
    cls = fa.head_dim_class(D, Dv)
    wide = cls is not None and fa.is_wide(D, Dv)
    assert (got is None) == (cls is not None
                             and bq in q_opts and bk in k_opts
                             and (not wide or (bq, bk)
                                  in fa.WIDE_TILES[itemsize])
                             and fa.smem_bytes(itemsize, D, bq, bk, Dv)
                             <= fa.SMEM_LIMIT_BYTES
                             and not (itemsize == 2 and not wide
                                      and (*cls, bq, bk)
                                      in fa.BF16_SPILLING_TILES))


def test_head_dims_by_kernel():
    """Both kernels are built at the same head-dim classes: the squares of
    HEAD_DIMS and MLA's (192, 128). A width runs at the least class that
    holds it; a pair that is not built runs at the square class of its
    larger width; 0 has no class; a pair with a width above 256 runs on
    the chunked kernels at whole chunks of q / k and slices of v."""
    assert fa.HEAD_DIMS == (32, 64, 96, 128, 160, 192, 256)
    assert fa.HEAD_DIM_PAIRS == \
        tuple((d, d) for d in fa.HEAD_DIMS) + ((192, 128),)
    assert fa.head_dim_class(1, 1) == (32, 32)
    assert fa.head_dim_class(24, 16) == (32, 32)
    assert fa.head_dim_class(33, 33) == (64, 64)
    assert fa.head_dim_class(128, 64) == (128, 128)
    assert fa.head_dim_class(150, 100) == (160, 160)
    assert fa.head_dim_class(170, 100) == (192, 128)
    assert fa.head_dim_class(192, 128) == (192, 128)
    assert fa.head_dim_class(100, 170) == (192, 192)
    assert fa.head_dim_class(200, 1) == (256, 256)
    assert fa.head_dim_class(0, 64) is None
    assert fa.head_dim_class(64, 257) == (128, 512)
    assert fa.head_dim_class(300, 64) == (384, 128)
    assert fa.head_dim_class(1024, 1024) == (1024, 1024)
    # the built dims are their own class
    for pair in fa.HEAD_DIM_PAIRS:
        assert fa.head_dim_class(*pair) == pair


#: (D, Dv) of the grid the kernel contract is held at: every kind of class
#: and its edges, Dv != D both ways
_GRID = (1, 8, 16, 20, 24, 32, 80, 96, 100, 200, 256, 257, 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", _GRID)
@pytest.mark.parametrize("Dv", _GRID)
def test_flash_tiles_are_built_at_every_head_dim(dtype, D, Dv):
    """For every (dtype, D, Dv) of the grid, up to 300, causal or not, at a
    long and at a one-row query, the model's tile is one ``unsupported``
    accepts: the kernels take every head dim the TPU kernel takes."""
    for causal, seq_q in ((True, 1024), (False, 1024), (False, 1)):
        tiles = attn.flash_tiles(dtype, (D, Dv), causal, seq_q)
        assert fa.unsupported(dtype.itemsize, D, Dv, *tiles) is None


def test_flash_tiles_are_built_at_every_pair_of_head_dims():
    """The contract over the classes' whole range, every (D, Dv) pair of
    1..256, in every dtype."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in range(1, fa.MAX_CLASS_DIM + 1):
            for Dv in range(1, fa.MAX_CLASS_DIM + 1):
                assert fa.unsupported(dtype.itemsize, D, Dv, *attn.flash_tiles(
                    dtype, (D, Dv))) is None, (dtype, D, Dv)


def test_wider_heads_and_float16_are_refused_by_name():
    """Head dims above 256 and float16 are the kernels' now: on a device
    that is neither the CPU (whose tensors take the plain version) nor the
    card, the wrapper refuses them for the device alone. A dtype the
    kernels do not take, float64, is still refused by name."""
    for shape, dtype in (((1, 16, 2, 264), torch.bfloat16),
                         ((1, 16, 2, 64), torch.float16),
                         ((1, 16, 2, 1024), torch.float16),
                         ((1, 16, 2, 320), torch.float32)):
        meta = torch.empty(shape, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            ops.flash_attention_op(meta, meta, meta)
    meta = torch.empty((1, 16, 2, 64), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="float32, bfloat16 or float16, "
                                         "got torch.float64"):
        ops.flash_attention_op(meta, meta, meta)
    assert fa.copy_rule_holds(torch.zeros((1, 8, 2, 64)))
    assert not fa.copy_rule_holds(torch.zeros((1, 8, 1, 20),
                                              dtype=torch.bfloat16))
    assert not fa.copy_rule_holds(torch.zeros((1, 8, 2, 64))[..., 1:9])
    padded = fa._padded(torch.ones((1, 8, 1, 20), dtype=torch.bfloat16))
    assert padded.shape == (1, 8, 1, 24) and fa.copy_rule_holds(padded)
    assert float(padded[..., 20:].abs().sum()) == 0.0


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
    # f32, head dim 128: Q_big and Q_small 32 x 128 each, K in rows of
    # 128 + 16 floats, V in rows of 128 + 4:
    # (2 x 32 x 128 + 128 x 144 + 128 x 132) x 4
    assert fa.smem_bytes(4, 128, 32, 128) == 174080
    assert fa.smem_bytes(4, 128, 64, 64) == 136192
    assert fa.smem_bytes(4, 128, 128, 128) > fa.SMEM_LIMIT_BYTES
    # what the kernels' tuning space keeps at head dim 128: every tile but
    # 128 x 128, the largest at 206848 and 201728 B
    assert fa.smem_bytes(4, 128, 64, 128) == 206848
    assert fa.smem_bytes(4, 128, 128, 64) == 201728
    # head dim 160: Q split in two leaves room for 32 x 128 and 64 x 64 only
    assert fa.smem_bytes(4, 160, 32, 128) == 215040 <= fa.SMEM_LIMIT_BYTES
    assert fa.smem_bytes(4, 160, 64, 64) == 168960
    assert fa.smem_bytes(4, 160, 64, 128) > fa.SMEM_LIMIT_BYTES
    assert fa.smem_bytes(4, 160, 128, 64) > fa.SMEM_LIMIT_BYTES
    # head dim 64: every f32 tile fits
    assert all(fa.smem_bytes(4, 64, bq, bk) <= fa.SMEM_LIMIT_BYTES
               for bq in fa.BLOCK_Q_OPTIONS for bk in fa.BLOCK_K_OPTIONS)
    # bf16, head dim 128: Q 128 x 128 x 2 + 3 stages x (K + V) 128 x 128 x 2
    #                     + 7 mbarriers x 8 + 1024 alignment slack
    assert fa.bf16_stages(128, 128, 128) == 3
    assert fa.smem_bytes(2, 128, 128, 128) == 32768 + 6 * 32768 + 56 + 1024
    # head dim 160 is the limit: at the largest bf16 tile a third stage
    # would need 288800 B, so the ring keeps two (205864 B)
    assert fa.bf16_stages(160, 128, 128) == 2
    assert fa.smem_bytes(2, 160, 128, 128) == 205864 <= fa.SMEM_LIMIT_BYTES
    assert fa.bf16_stages(160, 128, 64) == 3
    # every bf16 tile fits up to head dim 160 and at (192, 128); at (192,
    # 192) all but 128 x 128; at 256 only the 64-row kv tiles do
    # (test_shared_memory_formula_at_head_dim_256)
    assert all(fa.smem_bytes(2, D, bq, bk, Dv) <= fa.SMEM_LIMIT_BYTES
               for D, Dv in fa.HEAD_DIM_PAIRS if D <= 160 or Dv < D
               for bq in fa.BF16_BLOCK_Q_OPTIONS
               for bk in fa.BF16_BLOCK_K_OPTIONS)
    assert [(bq, bk) for bq in fa.BF16_BLOCK_Q_OPTIONS
            for bk in fa.BF16_BLOCK_K_OPTIONS
            if fa.smem_bytes(2, 192, bq, bk) > fa.SMEM_LIMIT_BYTES] == \
        [(128, 128)]
    # a call's head dims are priced at their class: D = 100 at (128, 128)
    assert fa.smem_bytes(2, 100, 128, 64) == fa.smem_bytes(2, 128, 128, 64)
    assert fa.smem_bytes(4, 20, 32, 64, 12) == fa.smem_bytes(4, 32, 32, 64)


def test_shared_memory_formula_at_head_dim_256():
    """bf16 at D = Dv = 256: at 128 x 64 three stages would need 263224 B,
    so the ring keeps two (197672 B); at 64 x 64 three fit (230456 B of the
    232448); a 128-row kv tile overflows with two stages at either q
    tile."""
    assert fa.bf16_stages(256, 128, 64) == 2
    assert fa.smem_bytes(2, 256, 128, 64) == \
        65536 + 2 * (32768 + 32768) + 40 + 1024 == 197672
    assert fa._bf16_smem(256, 128, 64, 3) == 263224 > fa.SMEM_LIMIT_BYTES
    assert fa.bf16_stages(256, 64, 64) == 3
    assert fa.smem_bytes(2, 256, 64, 64) == 230456 <= fa.SMEM_LIMIT_BYTES
    for bq in fa.BF16_BLOCK_Q_OPTIONS:
        assert fa._bf16_smem(256, bq, 128, 2) > fa.SMEM_LIMIT_BYTES


def test_shared_memory_formula_with_dv():
    """bf16 at D = 192, Dv = 128: 2 (D (bq + stages bk) + Dv stages bk)
    bytes of tiles + 8 (2 stages + 1) of mbarriers + 1024 of slack. At the
    model's 128 x 64 three stages fit: 48 + 3 (24 + 16) KB of tiles; at
    128-row kv tiles the ring keeps two."""
    assert fa.bf16_stages(192, 128, 64, 128) == 3
    assert fa.smem_bytes(2, 192, 128, 64, 128) == \
        49152 + 3 * (24576 + 16384) + 56 + 1024 == 173112
    assert fa.bf16_stages(192, 128, 128, 128) == 2
    assert fa.smem_bytes(2, 192, 128, 128, 128) == \
        49152 + 2 * (49152 + 32768) + 40 + 1024
    assert fa.bf16_stages(192, 64, 128, 128) == 2
    assert fa.bf16_stages(192, 64, 64, 128) == 3
    # three stages at D = Dv = 192 and 128 x 64 would not be the same
    # bytes: V's width counts on its own
    assert fa.smem_bytes(2, 192, 128, 64, 192) - \
        fa.smem_bytes(2, 192, 128, 64, 128) == 2 * 64 * 3 * 64
    # value_dim defaults to head_dim: the formula of Dv == D
    for D in fa.HEAD_DIMS:
        assert fa.smem_bytes(2, D, 128, 64) == \
            fa.smem_bytes(2, D, 128, 64, D)


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
    refuses what the kernel refuses (``unsupported`` and the shape checks;
    any length is taken, a ragged last tile runs masked) and computes the
    kernel's plain version (p rounded to v's dtype for p.v)."""
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
                                        block_k=kw["block_k"], round_p=True)
    monkeypatch.setattr(ops, "flash_attention_op", op)
    return calls


def test_prefill_case_goes_to_the_kernel_and_others_do_not(recorded):
    q, k, v = (torch.from_numpy(_normal(40 + i, 1, 64, 4, 264))
               for i in range(3))
    kv = k[:, :, :2], v[:, :, :2]
    out = attn.chunked_attention(q, *kv)     # head dim 264: the kernel op,
    assert len(recorded) == 1                # at the chunked kernel's tile
    assert (recorded[0]["block_q"], recorded[0]["block_k"]) == \
        attn.flash_tiles(torch.float32, (264, 264))
    np.testing.assert_allclose(
        out.numpy(), attn.chunked_attention(q, *kv, impl="plain").numpy(),
        rtol=2e-5, atol=2e-5)
    q, k, v = (torch.from_numpy(_normal(40 + i, 1, 64, 4, 64))
               for i in range(3))
    kv = k[:, :, :2], v[:, :, :2]
    recorded.clear()
    out = attn.chunked_attention(q, *kv)
    assert len(recorded) == 1 and recorded[0]["causal"] is True
    assert (recorded[0]["block_q"], recorded[0]["block_k"]) == \
        attn.flash_tiles(torch.float32)
    plain = attn.chunked_attention(q, *kv, impl="plain", q_chunk=16,
                                   kv_chunk=32)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    # non-causal over the whole kv (encoder and cross-attention) is the
    # kernel's case too
    out = attn.chunked_attention(q, *kv, causal=False)
    assert len(recorded) == 2 and recorded[1]["causal"] is False
    plain = attn.chunked_attention(q, *kv, causal=False, impl="plain")
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    for kw in (dict(window=8), dict(q_offset=3),
               dict(kv_valid_len=torch.tensor(20)), dict(impl="plain"),
               dict(causal=False, window=8),
               dict(causal=False, kv_valid_len=torch.tensor(20))):
        attn.chunked_attention(q, *kv, **kw)
    assert len(recorded) == 2


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [300, 1000])
def test_a_ragged_prefill_reaches_the_kernel_op(recorded, dtype, S):
    """A causal prefill whose length no tile divides (the lock-step route's
    longest prompt) reaches ``ops.flash_attention_op`` once, at the dtype's
    tiles, and equals the plain route."""
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_normal(S, 1, S, 4, 64)).to(dt)
    k, v = (torch.from_numpy(_normal(S + 1 + i, 1, S, 2, 64)).to(dt)
            for i in range(2))
    out = attn.chunked_attention(q, k, v)
    (kw,) = recorded
    assert kw["causal"] is True
    assert (kw["block_q"], kw["block_k"]) == attn.FLASH_TILES[dt]
    assert S % kw["block_q"] and S % kw["block_k"]
    plain = attn.chunked_attention(q, k, v, impl="plain")
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(plain), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_plain_matches_the_reference_chunked_path(causal):
    """The plain version at the bf16 kernel's tiles, over 300 query rows
    (two full tiles and a ragged one) with GQA, against the reference
    model's chunked ``_flash`` path on the CPU."""
    from repro.models import attention as ref_attn
    q_np = _normal(81, 2, 300, 4, 32)
    k_np, v_np = (_normal(82 + i, 2, 300, 2, 32) for i in range(2))
    want = ref_attn.chunked_attention(*(jnp.asarray(x)
                                        for x in (q_np, k_np, v_np)),
                                      causal=causal)
    bq, bk = attn.FLASH_TILES[torch.bfloat16]
    got = fa.flash_attention_plain(*(torch.from_numpy(x)
                                     for x in (q_np, k_np, v_np)),
                                   causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,S", [
    (torch.bfloat16, 1024),
    (torch.bfloat16, 16),                    # a tile longer than the prompt
    (torch.bfloat16, 1000),                  # ragged: the kernel masks it
    (torch.float32, 1024),
    (torch.float32, 96),
    (torch.float32, 300),
])
def test_flash_tiles(recorded, dtype, S):
    """A prefill of every length reaches the op at the dtype's preferred
    tile, one the kernel is built for."""
    tiles = attn.flash_tiles(dtype)
    assert tiles == attn.FLASH_TILES[dtype]
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert fa.unsupported(itemsize, 128, 128, *tiles) is None
    q, k, v = (torch.from_numpy(_normal(S + i, 1, S, 1, 64)).to(dtype)
               for i in range(3))
    attn.chunked_attention(q, k, v)
    (kw,) = recorded
    assert (kw["block_q"], kw["block_k"]) == tiles


@pytest.mark.parametrize("S,window,kernel", [
    (64, 64, True),           # the window reaches every key: masks nothing
    (40, 2048, True),         # RecurrentGemma's window, a shorter prompt
    (64, 63, False),          # one key of the last row falls outside it
    (65, 64, False),
])
def test_a_local_window_that_masks_no_key_reaches_the_kernel_op(
        recorded, S, window, kernel):
    """RecurrentGemma's local attention, bf16 at head dims (256, 256): a
    causal prefill at offset 0 whose window is at least its length masks
    no key, so it is the kernel's case, at the tiles of
    FLASH_TILES_BY_HEAD_DIMS; a longer prompt is masked by the window,
    which the kernel does not do, and takes the plain route (the kernel's
    contract). Both equal the plain route with the window."""
    dt = torch.bfloat16
    q = torch.from_numpy(_normal(S, 1, S, 4, 256)).to(dt)
    k, v = (torch.from_numpy(_normal(S + 1 + i, 1, S, 1, 256)).to(dt)
            for i in range(2))
    out = attn.chunked_attention(q, k, v, window=window)
    if kernel:
        (kw,) = recorded
        assert kw["causal"] is True
        assert (kw["block_q"], kw["block_k"]) == (64, 64) == \
            attn.flash_tiles(dt, (256, 256))
        assert fa.unsupported(2, 256, 256, 64, 64) is None
    else:
        assert recorded == []
    plain = attn.chunked_attention(q, k, v, window=window, impl="plain")
    np.testing.assert_allclose(_f32(out), _f32(plain), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


def test_flash_tiles_by_head_dims():
    """(256, 256) in bf16 takes 64 x 64, the one tile built there; every
    other head dim the dtype's tiles."""
    assert attn.flash_tiles(torch.bfloat16, (256, 256)) == (64, 64)
    assert [(bq, bk) for bq in fa.BF16_BLOCK_Q_OPTIONS
            for bk in fa.BF16_BLOCK_K_OPTIONS
            if fa.unsupported(2, 256, 256, bq, bk) is None] == [(64, 64)]
    for dims in ((128, 128), (192, 128), (160, 160)):
        assert attn.flash_tiles(torch.bfloat16, dims) == \
            attn.FLASH_TILES[torch.bfloat16]
    assert attn.flash_tiles(torch.float32, (256, 256)) == \
        attn.FLASH_TILES[torch.float32]


def test_mla_prefill_goes_to_the_kernel_at_192_128(recorded):
    """MLA prefill on the card: q/k of qk_nope + qk_rope = 192, v of
    v_head_dim = 128, at the full model's head dims (one layer cut to 2
    heads and a small latent), bf16. It reaches the kernel op at the
    model's bf16 tiles with scale 192 ** -0.5, and the output equals the
    plain route's within the bf16 rounding of p, carried through the bf16
    output projection: 2e-2 relative, or 1 % of the largest output."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import ParamMaker
    cfg = dataclasses.replace(
        get_config("deepseek-v3-671b"), d_model=64, n_heads=2, n_kv_heads=2,
        q_lora_rank=32, kv_lora_rank=16, dtype="bfloat16")
    p = attn.mla_params(ParamMaker(torch.Generator().manual_seed(0),
                                   "bfloat16", torch.device("cpu")),
                        "attn", cfg)
    x = torch.from_numpy(_normal(60, 1, 40, 64)).bfloat16()
    pos = torch.arange(40, dtype=torch.int32)[None]
    got = attn.mla_attention(p, cfg, x, pos)
    assert len(recorded) == 1
    assert recorded[0]["scale"] == 192 ** -0.5
    assert (recorded[0]["block_q"], recorded[0]["block_k"]) == \
        attn.flash_tiles(torch.bfloat16)
    want = attn.mla_attention(p, cfg, x, pos, impl="plain")
    assert len(recorded) == 1
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=2e-2,
                               atol=1e-2 * float(np.abs(want).max()))


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
