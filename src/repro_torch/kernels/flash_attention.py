"""Flash attention (forward) — blocked online-softmax attention.

:func:`flash_attention` keeps the reference's signature: ``q [BH, Sq, D]``,
``k [BH, Skv, D]``, ``v [BH, Skv, Dv]`` -> ``[BH, Sq, Dv]`` in ``q``'s
dtype, ``scale = D ** -0.5`` by default, the causal mask ``kpos <= qpos``
with both positions counted from 0, masked scores filled with ``-1e30``.
:func:`flash_attention_bshd` takes the ``[B, S, H, D]`` layout of the model
with GQA (``Hq`` a multiple of ``Hkv``); the kernel indexes kv head
``h // (Hq // Hkv)`` instead of repeating K and V.

A CPU tensor goes to :func:`flash_attention_plain` — the same blocked online
softmax in plain PyTorch, f32 arithmetic throughout, skipping the kv blocks
that the causal mask covers wholly (exact: they add ``exp(-1e30 - m) = 0``).
It also takes query offsets, local windows and kv masks, and is the model's
plain attention route. Any other tensor goes to the hand-written kernel in
``csrc/flash_attention.cu``, or the call raises.

``block_q`` / ``block_k`` are the kernel's tiles. As in the reference,
``min(block, S)`` must divide the sequence (``ValueError`` otherwise). What
the kernel is built for — the tiles in :data:`BLOCK_Q_OPTIONS` x
:data:`BLOCK_K_OPTIONS`, head dims :data:`HEAD_DIMS` with ``Dv == D``, and
the shared memory a block may have — is stated once, in
:func:`unsupported`; a tile longer than the sequence runs with its tail
masked.
"""
from __future__ import annotations

import operator
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

BLOCK_Q_OPTIONS = (32, 64, 128)
BLOCK_K_OPTIONS = (64, 128)
HEAD_DIMS = (64, 128, 160)
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
#: shared memory one thread block may use on an H100 (227 KB)
SMEM_LIMIT_BYTES = 232448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by the wrappers (only where they launch)
LAUNCHES = 0


def smem_bytes(itemsize: int, head_dim: int, block_q: int,
               block_k: int) -> int:
    """Shared memory of one thread block of the kernel (the ``Smem``
    formula of ``csrc/flash_attention.cu``): Q and K tiles with rows padded
    by one 32-bit word, the V tile, S/P in f32 with rows padded by one, and
    three f32 row statistics."""
    pitch = head_dim + 4 // itemsize
    return (itemsize * (block_q * pitch + block_k * pitch
                        + block_k * head_dim)
            + 4 * (block_q * (block_k + 1) + 3 * block_q))


def flash_attention_work(seq_q: int, seq_kv: int, *, causal: bool,
                         block_q: int, block_k: int) -> Tuple[int, int, int]:
    """What one (batch, head) of the kernel evaluates: ``(score entries,
    kv rows read, tile pairs)``. Entries count the in-range rows x columns
    of every (q tile, kv tile) pair the kernel visits — causal attention
    visits only the kv tiles that reach the q tile's last row. Each entry
    costs ``2 * (D + Dv)`` flops; each kv row read moves ``D + Dv``
    elements."""
    entries = kv_rows = pairs = 0
    for q0 in range(0, seq_q, block_q):
        rows = min(block_q, seq_q - q0)
        k_end = min(seq_kv, q0 + rows) if causal else seq_kv
        for k0 in range(0, k_end, block_k):
            cols = min(block_k, seq_kv - k0)
            entries += rows * cols
            kv_rows += cols
            pairs += 1
    return entries, kv_rows, pairs


def _positive(name: str, value) -> int:
    try:
        value = operator.index(value)
    except TypeError:
        raise ValueError(f"{name} must be an int, got {value!r}") from None
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")
    return value


def _check_bshd(q, k, v, block_q, block_k) -> Tuple[int, int]:
    """Shapes, dtypes and blocks of the ``[B, S, H, D]`` form; returns the
    clamped blocks ``(min(block_q, Sq), min(block_k, Skv))``."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q, k, v must be [B, S, H, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if (k.shape[0] != B or v.shape[0] != B or k.shape[1] != v.shape[1]
            or k.shape[2] != v.shape[2] or k.shape[3] != D):
        raise ValueError(
            f"k, v must be [B, Skv, Hkv, D/Dv] with q's B and D; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} q heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share one dtype; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    bq = min(_positive("block_q", block_q), Sq)
    bk = min(_positive("block_k", block_k), k.shape[1])
    if Sq % bq or k.shape[1] % bk:
        raise ValueError(
            f"blocks do not tile the sequences: Sq {Sq} % block_q {bq} = "
            f"{Sq % bq}, Skv {k.shape[1]} % block_k {bk} = "
            f"{k.shape[1] % bk}")
    return bq, bk


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: int, kv_valid_len) -> Optional[torch.Tensor]:
    """[rows, cols] mask of one (q block, kv block) pair, or None."""
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window:
        w = kpos[None, :] > qpos[:, None] - window
        mask = w if mask is None else mask & w
    if kv_valid_len is not None:
        kv = (kpos < kv_valid_len)[None, :]
        mask = kv if mask is None else mask & kv
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K,
                          q_offset: Union[int, torch.Tensor] = 0,
                          window: int = 0,
                          kv_valid_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: q ``[B, Sq,
    Hq, D]``, k/v ``[B, Skv, Hkv, D/Dv]`` -> ``[B, Sq, Hq, Dv]`` in v's
    dtype, f32 products and accumulation, blocks of ``block_q`` x
    ``block_k`` (a ragged last block is fine).

    Beyond the kernel's case it takes ``q_offset`` (absolute position of
    ``q[0]``), a local ``window`` (keys ``kpos > qpos - window``) and
    ``kv_valid_len`` (keys ``kpos < kv_valid_len``): the model's plain
    attention route. The kv blocks wholly past a q block's last row are
    skipped when the offset is a known int >= 0 and there is no kv mask;
    then every row has met its own diagonal before them, so they would add
    ``exp(-1e30 - m) = 0`` and rescale by 1, and skipping them is exact."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    dev = q.device
    sc = _scale(scale, D)
    skip = (causal and kv_valid_len is None and isinstance(q_offset, int)
            and q_offset >= 0)
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, Hq, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        rows = min(block_q, Sq - q0)
        qc = qg[:, q0:q0 + rows]
        qpos = q_offset + q0 + torch.arange(rows, dtype=torch.int32,
                                            device=dev)
        m = torch.full((B, Hkv, G, rows), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, rows), device=dev)
        acc = torch.zeros((B, Hkv, G, rows, Dv), device=dev)
        k_end = min(Skv, q_offset + q0 + rows) if skip else Skv
        for k0 in range(0, k_end, block_k):
            cols = min(block_k, Skv - k0)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc,
                             kf[:, k0:k0 + cols]) * sc
            kpos = torch.arange(k0, k0 + cols, dtype=torch.int32, device=dev)
            mask = _block_mask(qpos, kpos, causal, window, kv_valid_len)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k0 + cols])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 3, 1, 2, 4).reshape(
            B, rows, Hq, Dv)
    return out.to(v.dtype)


def _scale(scale: Optional[float], head_dim: int) -> float:
    return head_dim ** -0.5 if scale is None else float(scale)


def unsupported(itemsize: int, head_dim: int, value_dim: int, block_q: int,
                block_k: int) -> Optional[str]:
    """Why the kernel is not built for these head dims and tiles, or
    ``None`` when it is: the one statement of what ``csrc/flash_attention.cu``
    instantiates, read by the wrapper and by the tuning space's prune."""
    if head_dim not in HEAD_DIMS or value_dim != head_dim:
        return (f"not-instantiated (head dims {HEAD_DIMS} with Dv == D; got "
                f"D {head_dim}, Dv {value_dim})")
    if block_q not in BLOCK_Q_OPTIONS or block_k not in BLOCK_K_OPTIONS:
        return (f"not-instantiated (the kernel is built for block_q in "
                f"{BLOCK_Q_OPTIONS}, block_k in {BLOCK_K_OPTIONS}; got "
                f"({block_q}, {block_k}))")
    smem = smem_bytes(itemsize, head_dim, block_q, block_k)
    if smem > SMEM_LIMIT_BYTES:
        return (f"smem-overflow (tiles ({block_q}, {block_k}) need {smem} B "
                f"of shared memory at {itemsize}-byte elements, head dim "
                f"{head_dim}; a block has {SMEM_LIMIT_BYTES} B)")
    return None


def _refusal(q, k, v, block_q: int, block_k: int) -> Optional[str]:
    """Why the CUDA kernel does not take these ``[B, S, H, D]`` tensors and
    tiles, or ``None`` when it does."""
    if not q.is_cuda:
        return (f"the flash_attention kernel takes CUDA tensors (or CPU "
                f"tensors for the plain version); got device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        return f"the kernel takes float32 or bfloat16, got {q.dtype}"
    why = unsupported(q.element_size(), q.shape[-1], v.shape[-1], block_q,
                      block_k)
    if why is not None:
        return why
    if any(t.stride(3) != 1 for t in (q, k, v)):
        return "the last dim of q, k and v must be contiguous"
    return None


def _launch(q, k, v, causal: bool, scale: float, block_q: int,
            block_k: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise)."""
    global LAUNCHES
    why = _refusal(q, k, v, block_q, block_k)
    if why is not None:
        raise ValueError(why)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    from repro_torch.kernels import build
    lib = build.load_library()
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_flash_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), scale, block_q, block_k,
            stream)
    build.check_launch(code, f"flash_attention(q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, {q.dtype}, "
                             f"blocks ({block_q}, {block_k}))")
    LAUNCHES += 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D/Dv]`` -> ``[B, Sq, Hq,
    Dv]``; GQA by indexing. CPU tensors take the plain version; any other
    tensor goes to the CUDA kernel, and what it does not take raises."""
    bq, bk = _check_bshd(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=bq, block_k=bk)
    return _launch(q, k, v, causal, _scale(scale, q.shape[-1]), block_q,
                   block_k)


def _as_bshd(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.ndim != 3:
        raise ValueError(f"{name} must be [BH, S, D]; got {tuple(x.shape)}")
    return x.unsqueeze(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: ``[BH, Sq, D]``, k/v: ``[BH, Skv, D/Dv]`` -> ``[BH, Sq, Dv]``.

    Batch and heads are folded into the leading dim, as in the reference
    (GQA lives in :func:`flash_attention_bshd`)."""
    out = flash_attention_bshd(_as_bshd(q, "q"), _as_bshd(k, "k"),
                               _as_bshd(v, "v"), causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    return out[:, :, 0]
