"""repro_torch's differentiable attention on the CPU against the reference
package: ``chunked_attention`` under autograd (the ``FlashAttention``
Function: the plain blocked online-softmax forward keeping ``(q, k, v,
out, lse)``, and a backward that recomputes p a block at a time) against
``jax.grad`` of the reference's ``chunked_attention`` (its ``_flash``
custom_vjp), its ``lse`` against the reference's ``_fwd_impl``, what it
saves, how calls route while autograd records, and the flash kernel op's
refusal of inputs that require grad.

The cases: the four of tests/test_attention.py at their own chunks (one
with Dv != D, one with a window of 24), non-causal cross-attention with
Sq != Skv and four query heads a kv head, and a causal length of 1536,
which the default kv chunk of 1024 does not divide (the kv chunk falls
back to 512, as in the reference, beside one q chunk of 1536). Inputs are drawn with numpy from a seed; the
loss is the sum of the output times a fixed random cotangent.

Tolerance: rtol = atol = 2e-5 on gradients, outputs and lse (both packages
sum the same f32 terms in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; several test workers share
    the host's cores, and torch's intra-op threads would spin against each
    other's. One thread each, restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: (B, Sq, Skv, Hq, Hkv, Dk, Dv, window, causal, q_chunk, kv_chunk)
CASES = {
    "case0": (2, 64, 64, 4, 2, 16, 16, 0, True, 16, 16),
    "case1_dv_ne_d": (2, 128, 128, 4, 1, 32, 16, 0, True, 32, 64),
    "case2_window24": (2, 96, 96, 2, 2, 16, 16, 24, True, 32, 16),
    "case3_one_chunk": (2, 128, 128, 8, 8, 8, 8, 0, True, 128, 128),
    "cross_g4": (2, 48, 80, 8, 2, 16, 16, 0, False, 16, 32),
    "causal_1536_default_chunks": (1, 1536, 1536, 4, 2, 8, 8, 0, True,
                                   2048, 1024),
}


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, Dk, Dv = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, Dk)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dk)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dv)).astype(np.float32)
    w = rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32)
    return q, k, v, w


def _kwargs(case):
    window, causal, qc, kc = case[7:]
    return dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_reference(name):
    case = CASES[name]
    q, k, v, w = _inputs(case)
    kw = _kwargs(case)

    def ref_loss(q, k, v):
        return jnp.sum(ref_attn.chunked_attention(q, k, v, **kw) * w)

    want_out = ref_attn.chunked_attention(q, k, v, **kw)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn.chunked_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_lse_matches_reference(name):
    case = CASES[name]
    q, k, v, _ = _inputs(case, seed=1)
    B, Sq, Skv, Hq, Hkv, Dk = case[:6]
    window, causal, qc, kc = case[7:]
    qc, kc = attn._pick_chunk(Sq, qc), attn._pick_chunk(Skv, kc)
    scale = Dk ** -0.5
    want_out, want_lse = ref_attn._fwd_impl(q, k, v, causal, window, scale,
                                            qc, kc, 0, None)
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        scale=scale, block_q=qc, block_k=kc, window=window, return_lse=True)
    assert lse.shape == (B, Hkv, Hq // Hkv, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)


def test_return_lse_leaves_the_output_bits_alone():
    q, k, v, _ = _inputs(CASES["cross_g4"], seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for kw in (dict(causal=True, block_q=16, block_k=32),
               dict(causal=False, block_q=32, block_k=16, window=24)):
        plain = fa.flash_attention_plain(tq, tk, tv, **kw)
        out, _ = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
        assert torch.equal(plain, out)


def test_saved_tensors_are_q_k_v_out_lse():
    """Autograd keeps (q, k, v, out, lse) and nothing of Sq x Skv."""
    B, Sq, Skv, Hq, Hkv, D = 1, 64, 96, 4, 2, 16
    q, k, v, _ = _inputs((B, Sq, Skv, Hq, Hkv, D, D), seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attn.chunked_attention(tq, tk, tv, causal=False, q_chunk=16,
                               kv_chunk=32)
    assert saved == [(B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                     (B, Sq, Hq, D), (B, Hkv, Hq // Hkv, Sq)]
    assert all(np.prod(s) < Sq * Skv for s in saved)


def test_recording_calls_route_by_offset_and_mask():
    """While autograd records, offset 0 without a kv mask takes the
    Function, a query offset or a kv mask the plain route (autograd through
    its loops); without grad no graph is built, and both recording routes
    give the same gradients at offset 0."""
    q, k, v, w = _inputs((1, 32, 32, 4, 2, 16, 16), seed=4)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn.chunked_attention(tq, tk, tv, q_chunk=8, kv_chunk=16)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    g_flash = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                  (tq, tk, tv))
    masked = attn.chunked_attention(tq, tk, tv, q_chunk=8, kv_chunk=16,
                                    kv_valid_len=torch.tensor(32))
    assert type(masked.grad_fn).__name__ != "FlashAttentionBackward"
    g_plain = torch.autograd.grad((masked * torch.from_numpy(w)).sum(),
                                  (tq, tk, tv))
    for a, b in zip(g_flash, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    offset = attn.chunked_attention(tq[:, 16:], tk, tv, q_offset=16,
                                    q_chunk=8, kv_chunk=16)
    assert type(offset.grad_fn).__name__ != "FlashAttentionBackward"
    np.testing.assert_allclose(offset.detach().numpy(),
                               out.detach().numpy()[:, 16:], **TOL)
    with torch.no_grad():
        assert attn.chunked_attention(tq, tk, tv).grad_fn is None


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, w = _inputs((1, 40, 40, 4, 2, 16, 8), seed=5)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = attn.chunked_attention(tq, tk, tv, q_chunk=16, kv_chunk=8)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))
    ref = [t.float().detach().requires_grad_() for t in (tq, tk, tv)]
    out32 = attn.chunked_attention(*ref, q_chunk=16, kv_chunk=8)
    (out32 * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        lim = 1e-2 * float(r.grad.abs().max())
        assert float((t.grad.float() - r.grad).abs().max()) <= lim


def test_flash_attention_op_refuses_inputs_that_require_grad():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    k = v = torch.zeros((1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q, k, v, block_q=8, block_k=8)
    with torch.no_grad():
        ops.flash_attention_op(q, k, v, block_q=8, block_k=8)
    ops.flash_attention_op(q.detach(), k, v, block_q=8, block_k=8)


@pytest.mark.card
def test_training_call_on_the_card_launches_no_kernel():
    """On a CUDA card: a recording call at offset 0 takes the Function,
    launches no flash kernel, and gives q, k and v nonzero gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 256, 8, 128), generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    ops.reset_launch_counts()
    attn.chunked_attention(q, k, v).float().square().sum().backward()
    assert ops.launch_counts()["flash_attention"] == 0
    assert all(float(t.grad.abs().max()) > 0 for t in (q, k, v))
