"""Attention: chunked online-softmax forward and GQA, with per-slot KV
caches for decode.

:func:`chunked_attention` dispatches on its arguments, as the reference's
``chunked_attention`` picks its flash path. Prefill self-attention on the
card — CUDA tensors, causal, no window, offset 0, no kv mask — is the case
the hand-written flash kernel computes, the same function with the same
outputs: it goes to :func:`repro_torch.kernels.ops.flash_attention_op` with
the tiles :func:`flash_tiles` picks, and what the kernel is not built for
(a head dim, a dtype, a length no instantiated tile divides) raises there.
Every other case (CPU tensors, windows, query offsets, kv masks) takes the
plain blocked online softmax,
:func:`repro_torch.kernels.flash_attention.flash_attention_plain`.

Decode writes each new K/V row into the cache in place (``index_copy_`` /
index assignment on the cache tensors) and returns the same tensors.
MLA and cross-attention are ROADMAP queue A item 1's remaining families.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import ParamMaker, apply_rope

NEG_INF = -1e30

#: the flash kernel's tiles on the model's prefill path, by dtype: for bf16
#: the fastest instantiated tile at the served model's prefill shape, for
#: f32 the tuner's fastest at the SPACES shape, both on the H100 (PERF.md);
#: f32 at (128, 128) does not fit in shared memory
FLASH_TILES = {torch.bfloat16: (128, 128), torch.float32: (32, 128)}

IntOrTensor = Union[int, torch.Tensor]


def _pick_chunk(n: int, pref: int) -> int:
    c = min(pref, n)
    while c > 1 and n % c:
        c //= 2
    if n % c:  # odd sizes: fall back to divisor search
        for c in range(min(pref, n), 0, -1):
            if n % c == 0:
                return c
    return max(c, 1)


def flash_tiles(dtype: torch.dtype, seq_q: int,
                seq_kv: int) -> Tuple[int, int]:
    """The kernel's ``(block_q, block_k)`` for a prefill of ``dtype``: the
    largest instantiated tile up to :data:`FLASH_TILES`' whose
    ``min(tile, S)`` divides the sequence (prefill pages are powers of two,
    so the preferred tile always does); where none does, the preferred
    tile, which the wrapper refuses with a ``ValueError``."""
    pref_q, pref_k = FLASH_TILES.get(dtype, (fa.DEFAULT_BLOCK_Q,
                                             fa.DEFAULT_BLOCK_K))

    def pick(pref, options, n):
        for b in sorted((b for b in options if b <= pref), reverse=True):
            if n % min(b, n) == 0:
                return b
        return pref
    return (pick(pref_q, fa.BLOCK_Q_OPTIONS, seq_q),
            pick(pref_k, fa.BLOCK_K_OPTIONS, seq_kv))


def _on_card(q: torch.Tensor) -> bool:
    return q.is_cuda


def _kernel_case(q, causal: bool, q_offset, kv_valid_len,
                 window: int) -> bool:
    """Prefill self-attention on the card, what the flash kernel computes:
    CUDA tensors, causal, no window, offset 0, no kv mask."""
    return (_on_card(q) and causal and not window and kv_valid_len is None
            and isinstance(q_offset, int) and q_offset == 0)


def chunked_attention(
    q: torch.Tensor,                 # [B, Sq, Hq, Dk]
    k: torch.Tensor,                 # [B, Skv, Hkv, Dk]
    v: torch.Tensor,                 # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: IntOrTensor = 0,       # absolute position of q[0]
    kv_valid_len: Optional[torch.Tensor] = None,  # mask kv positions >= this
    window: int = 0,                 # 0 = global; >0 = local attention width
    softmax_scale: Optional[float] = None,
    q_chunk: int = 2048,
    kv_chunk: int = 1024,
    impl: str = "kernel",
) -> torch.Tensor:
    """Doubly-chunked online-softmax attention; f32 accumulation.

    ``impl="kernel"`` sends the flash kernel's case on the card to the
    kernel (see the module docstring); ``impl="plain"`` keeps every call on
    the plain version (the route the end-to-end check compares against)."""
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, Dv = v.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    scale = softmax_scale if softmax_scale is not None else Dk ** -0.5
    if impl == "kernel" and _kernel_case(q, causal, q_offset, kv_valid_len,
                                         window):
        from repro_torch.kernels import ops
        bq, bk = flash_tiles(q.dtype, Sq, Skv)
        return ops.flash_attention_op(q, k, v, causal=True, block_q=bq,
                                      block_k=bk, scale=scale)
    return fa.flash_attention_plain(
        q, k, v, causal=causal, scale=scale,
        block_q=_pick_chunk(Sq, q_chunk), block_k=_pick_chunk(Skv, kv_chunk),
        q_offset=q_offset, window=window, kv_valid_len=kv_valid_len)


# ---------------------------------------------------------------------------
# Standard GQA attention block (dense trunks)
# ---------------------------------------------------------------------------
def attention_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
                     tp: int = 1, cross: bool = False) -> Dict:
    if cross:
        raise NotImplementedError(
            "cross-attention (vlm / enc-dec families) is ROADMAP queue A "
            "item 1's remaining work")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    p = {
        "wq": mk(f"{prefix}.wq", (d, nh, hd)),
        "wk": mk(f"{prefix}.wk", (d, nkv, hd)),
        "wv": mk(f"{prefix}.wv", (d, nkv, hd)),
        "wo": mk(f"{prefix}.wo", (nh, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = mk(f"{prefix}.bq", (nh, hd), init="zeros")
        p["bk"] = mk(f"{prefix}.bk", (nkv, hd), init="zeros")
        p["bv"] = mk(f"{prefix}.bv", (nkv, hd), init="zeros")
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _qkv(p: Dict, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def self_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: int = 0,
                   use_rope: bool = True, return_cache: bool = False,
                   impl: str = "kernel"):
    """Training / prefill self-attention over a full sequence.
    ``return_cache`` additionally returns the (roped) K and V for caching."""
    q, k, v = _qkv(p, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=True, window=window, impl=impl)
    y = _out_proj(out, p["wo"])
    if return_cache:
        return y, (k, v)
    return y


# --- KV caches --------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                  window: int = 0, dtype=torch.bfloat16,
                  device=None) -> Dict:
    from repro_torch import as_device
    nkv, hd = cfg.padded_kv_heads(tp), cfg.resolved_head_dim
    slots = min(window, max_len) if window else max_len
    dev = as_device(device)
    return {
        "k": torch.zeros((batch, slots, nkv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, slots, nkv, hd), dtype=dtype, device=dev),
    }


def _dense_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Single-einsum decode attention. q: [B,1,Hq,Dk]; k/v: [B,S,Hkv,D*];
    valid: scalar or per-sequence [B]."""
    B, S, Hkv, Dk = k.shape
    G = q.shape[2] // Hkv
    qg = q.reshape(B, 1, Hkv, G, Dk)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * scale
    kv_pos = torch.arange(S, dtype=torch.int32, device=k.device)
    if valid.ndim == 1:
        mask = (kv_pos[None, :] < valid[:, None])[:, None, None, None, :]
    else:
        mask = (kv_pos < valid)[None, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, 1, q.shape[2], v.shape[-1])


def _batch_scatter(cache: torch.Tensor, new: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
    """Per-sequence cache write, in place: cache [B,S,...], new [B,1,...],
    slot [B]. Returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def decode_self_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          cache: Dict, pos: torch.Tensor, window: int = 0,
                          use_rope: bool = True,
                          impl: str = "chunked") -> Tuple[torch.Tensor, Dict]:
    """One-token decode. ``pos`` is the absolute position — a 0-d tensor for
    lock-step batches, or a per-sequence ``[B]`` vector (slot-pool decode:
    each sequence ropes, writes and masks at its own position). Keys are
    roped at write time; local attention uses a ring buffer of ``window``.
    The new K/V rows are written into ``cache`` in place."""
    per_seq = pos.ndim == 1
    q, k, v = _qkv(p, x)                      # [B, 1, H(kv), hd]
    if use_rope:
        if per_seq:
            posm = pos.to(torch.int32)[:, None]              # [B, 1]
        else:
            posm = pos.reshape(1).to(torch.int32)[None, :]   # [1, 1]
        q = apply_rope(q, posm, cfg.rope_theta)
        k = apply_rope(k, posm, cfg.rope_theta)
    slots = cache["k"].shape[1]
    slot = pos % slots
    ck, cv = cache["k"], cache["v"]
    if per_seq:
        _batch_scatter(ck, k, slot)
        _batch_scatter(cv, v, slot)
    else:
        idx = slot.reshape(1).long()
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
    # Ring semantics: every written slot is within the window by
    # construction, so masking only needs "slot has been written".
    valid = torch.clamp(pos + 1, max=slots)
    scale = cfg.resolved_head_dim ** -0.5
    if impl == "dense" or per_seq:
        out = _dense_decode_attend(q, ck, cv, valid, scale)
    else:
        out = chunked_attention(q, ck, cv, causal=False, kv_valid_len=valid,
                                softmax_scale=scale)
    y = _out_proj(out, p["wo"])
    return y, {"k": ck, "v": cv}
