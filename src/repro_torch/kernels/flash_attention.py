"""Flash attention (forward) — blocked online-softmax attention.

:func:`flash_attention` keeps the reference's signature: ``q [BH, Sq, D]``,
``k [BH, Skv, D]``, ``v [BH, Skv, Dv]`` -> ``[BH, Sq, Dv]`` in ``q``'s
dtype, ``scale = D ** -0.5`` by default, the causal mask ``kpos <= qpos``
with both positions counted from 0, masked scores filled with ``-1e30``.
:func:`flash_attention_bshd` takes the ``[B, S, H, D]`` layout of the model
with GQA (``Hq`` a multiple of ``Hkv``); the kernel indexes kv head
``h // (Hq // Hkv)`` instead of repeating K and V.

A CPU tensor goes to :func:`flash_attention_plain` — the same blocked online
softmax in plain PyTorch, f32 arithmetic with p rounded to v's dtype for
p.v as in the kernels (``round_p``), skipping the kv blocks
that the causal mask covers wholly (exact: they add ``exp(-1e30 - m) = 0``).
It also takes query offsets, local windows and kv masks, and is the model's
plain attention route. Any other tensor goes to a hand-written kernel, or
the call raises: f32 to the tensor-core kernel of
``csrc/flash_attention_f32.cuh`` (3xTF32 products on ``mma.sync``, K/V
through a ring of ``cp.async`` copies), bf16 to the tensor-core kernel of
``csrc/flash_attention_sm90.cuh`` (wgmma fed by TMA copies), both behind
the C entry point ``repro_flash_attention`` of ``csrc/flash_attention.cu``
(each kernel's instantiations are split over two ``.cu`` files that
``nvcc`` builds in parallel).

``block_q`` / ``block_k`` are the kernel's tiles. The ``[B, S, H, D]`` form
takes any sequence lengths: a ragged last tile runs masked. The
reference-signature :func:`flash_attention` keeps the reference's rule that
``min(block, S)`` divides the sequence (``ValueError`` otherwise). Both
kernels take every pair of head dims ``1 <= D, Dv <= 256``, as the
reference's kernel takes any: each call runs at its head-dim class
(:func:`head_dim_class`: each width rounded up to one of
:data:`HEAD_DIMS`, the pair to the square class of the larger where the
pair is not one of :data:`HEAD_DIM_PAIRS`), its padded columns zero, its
scale and its cost those of the true dims. What the kernels are built for
— that range, the tiles of :func:`tile_options` at each class, and the
shared memory and registers a block may have — is stated once, in
:func:`unsupported`; a tile longer than the sequence runs with its tail
masked. A tensor that breaks the kernels' 16-byte copy rule (a base that
is not 16-byte aligned, a stride that is not a multiple of 16 bytes, a
last dim that is not contiguous) is copied into a zero-padded buffer and
the kernel runs on that (:data:`PADDED_COPIES` counts the copies).
"""
from __future__ import annotations

import operator
from typing import Dict, Optional, Tuple, Union

import torch

NEG_INF = -1e30

#: f32 tiles (the 3xTF32 kernel): 8 warps over BQ / 16 row groups of 16
#: rows and 128 / BQ kv splits
BLOCK_Q_OPTIONS = (32, 64, 128)
BLOCK_K_OPTIONS = (64, 128)
#: bf16 tiles (the tensor-core kernel): 64 query rows a consumer warpgroup
BF16_BLOCK_Q_OPTIONS = (64, 128)
BF16_BLOCK_K_OPTIONS = (64, 128)
#: the head-dim classes of both kernels: a width ``1..256`` runs at the
#: least of these that holds it (multiples of 32: the bf16 kernel's 64- and
#: 128-byte swizzles, the f32 kernel's 16-column steps)
HEAD_DIMS = (32, 64, 96, 128, 160, 192, 256)
#: the widest head dim either kernel takes; wider ones are ROADMAP queue B
MAX_HEAD_DIM = HEAD_DIMS[-1]
#: ``(D, Dv)`` class pairs both kernels are instantiated for: the squares
#: of HEAD_DIMS and MLA's prefill (q/k of qk_nope + qk_rope = 192, v of
#: v_head_dim = 128); any other pair runs at the square class of its
#: larger width (:func:`head_dim_class`)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
#: ``(D, Dv, block_q, block_k)`` class pairs and tiles of the bf16 kernel
#: that fit in shared memory but are not built (``kBuilt`` in the source):
#: at (256, 256), 128 x 64 spills 216 bytes of registers (a 384-thread
#: block leaves a thread 168 at compile time) and ran 2.2x slower than 64 x
#: 64 (PERF.md §6)
BF16_SPILLING_TILES = frozenset({(256, 256, 128, 64)})
#: stages of the bf16 kernel's K/V ring: three where they fit in shared
#: memory, else two (``SmemSm90::kStages`` in the source)
BF16_MAX_STAGES = 3
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
#: shared memory one thread block may use on an H100 (227 KB)
SMEM_LIMIT_BYTES = 232448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by the wrappers (only where they launch): in all,
#: and by call shape (:func:`launch_key`; ``ops.flash_launches_by_head_dims``
#: sums them by head dims and mask)
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Dict[str, int] = {}
#: q, k or v tensors the wrapper copied into a zero-padded buffer before a
#: launch, because they broke the kernels' 16-byte copy rule
PADDED_COPIES = 0


def launch_key(D: int, Dv: int, causal: bool, Sq: int, Skv: int) -> str:
    """The key of a launch in :data:`LAUNCHES_BY_SHAPE`: ``"<D>x<Dv>
    q<Sq> kv<Skv>"`` for a causal call, ``"<D>x<Dv>/noncausal q<Sq>
    kv<Skv>"`` for the others."""
    return f"{D}x{Dv}{'' if causal else '/noncausal'} q{Sq} kv{Skv}"


def tile_options(itemsize: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(block_q options, block_k options)`` the kernel of this element
    size is instantiated for: bf16 (2 bytes) or f32 (4)."""
    if itemsize == 2:
        return BF16_BLOCK_Q_OPTIONS, BF16_BLOCK_K_OPTIONS
    return BLOCK_Q_OPTIONS, BLOCK_K_OPTIONS


def _width_class(x: int) -> Optional[int]:
    return next((c for c in HEAD_DIMS if x <= c), None)


def head_dim_class(head_dim: int, value_dim: int
                   ) -> Optional[Tuple[int, int]]:
    """The class pair a call at head dims ``(D, Dv)`` runs at, or ``None``
    outside ``1..MAX_HEAD_DIM``: each width rounded up to the least of
    :data:`HEAD_DIMS`; a pair that is not one of :data:`HEAD_DIM_PAIRS`
    takes the square class of its larger width. ``head_dim_class`` of
    ``csrc/flash_attention.cu`` states the same rule."""
    if head_dim < 1 or value_dim < 1:
        return None
    dc, dvc = _width_class(head_dim), _width_class(value_dim)
    if dc is None or dvc is None:
        return None
    if (dc, dvc) not in HEAD_DIM_PAIRS:
        dc = dvc = max(dc, dvc)
    return dc, dvc


def _class_dims(head_dim: int, value_dim: Optional[int]) -> Tuple[int, int]:
    """The class pair of ``(head_dim, value_dim)`` (``value_dim`` defaults
    to ``head_dim``), or the dims themselves outside the kernels' range."""
    dv = head_dim if value_dim is None else value_dim
    return head_dim_class(head_dim, dv) or (head_dim, dv)


def _bf16_smem(head_dim: int, block_q: int, block_k: int, stages: int,
               value_dim: Optional[int] = None) -> int:
    dv = head_dim if value_dim is None else value_dim
    return (2 * (head_dim * (block_q + stages * block_k)
                 + dv * stages * block_k)
            + 8 * (2 * stages + 1) + 1024)


def bf16_stages(head_dim: int, block_q: int, block_k: int,
                value_dim: Optional[int] = None) -> int:
    """Stages of the bf16 kernel's K/V ring at these tiles and the class of
    these head dims: three where they fit in a block's shared memory, else
    two."""
    dc, dvc = _class_dims(head_dim, value_dim)
    fits = _bf16_smem(dc, block_q, block_k, BF16_MAX_STAGES,
                      dvc) <= SMEM_LIMIT_BYTES
    return BF16_MAX_STAGES if fits else 2


def smem_bytes(itemsize: int, head_dim: int, block_q: int,
               block_k: int, value_dim: Optional[int] = None) -> int:
    """Shared memory of one thread block of the kernel, at the class
    ``(D, Dv)`` of these head dims (:func:`head_dim_class`; ``value_dim``
    defaults to ``head_dim``).

    f32 (``TilesF32`` of ``csrc/flash_attention_f32.cuh``): Q split into
    Q_big and Q_small (stored as the mma's A fragments), the K slot in rows of
    ``D + 16`` floats and the V slot in rows of ``Dv + 4`` (the pitches
    that keep the fragment loads free of bank conflicts); the merge of the
    kv splits reuses the same bytes. bf16 (``SmemSm90`` of
    ``csrc/flash_attention_sm90.cuh``): the Q tile, :func:`bf16_stages` K
    and V tiles, ``2 * stages + 1`` 8-byte mbarriers and 1024 bytes of slack
    that align the swizzled tiles: ``2 (D (bq + stages bk) + Dv stages bk)
    + 8 (2 stages + 1) + 1024``."""
    dc, dvc = _class_dims(head_dim, value_dim)
    if itemsize == 2:
        return _bf16_smem(dc, block_q, block_k,
                          bf16_stages(dc, block_q, block_k, dvc), dvc)
    return itemsize * (2 * block_q * dc + block_k * (dc + 16)
                       + block_k * (dvc + 4))


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


def flash_attention_cost(batch_heads: int, seq_q: int, seq_kv: int,
                         head_dim: int, value_dim: int, itemsize: int, *,
                         causal: bool, block_q: int, block_k: int
                         ) -> Tuple[float, float]:
    """``(flops, bytes)`` the kernel does over ``batch_heads`` (batch x q
    heads) at these tiles (:func:`flash_attention_work`): ``2 (D + Dv)``
    flops an evaluated score entry; q read and o written once, and each kv
    row a q tile visits read for it. The tuner's candidates and the cost
    counter's charge for a launch."""
    entries, kv_rows, _ = flash_attention_work(
        seq_q, seq_kv, causal=causal, block_q=block_q, block_k=block_k)
    flops = 2.0 * batch_heads * entries * (head_dim + value_dim)
    byts = float(itemsize * batch_heads * (seq_q * head_dim
                                           + seq_q * value_dim
                                           + kv_rows * (head_dim
                                                        + value_dim)))
    return flops, byts


def attention_entries(seq_q: int, seq_kv: int, causal: bool) -> int:
    """Score entries one (batch, head) of attention needs: every (q, kv)
    pair, or under the top-left causal mask the keys 0..qpos of each query
    row, sum of min(qpos + 1, Skv)."""
    if not causal:
        return seq_q * seq_kv
    if seq_q <= seq_kv:
        return seq_q * (seq_q + 1) // 2
    return seq_kv * (seq_kv + 1) // 2 + (seq_q - seq_kv) * seq_kv


def attention_need(B: int, Hq: int, Hkv: int, seq_q: int, seq_kv: int,
                   head_dim: int, value_dim: int, itemsize: int,
                   causal: bool) -> Tuple[float, float]:
    """``(flops, bytes)`` the attention function needs, whatever computes
    it: ``2 (D + Dv)`` flops an unmasked score entry
    (:func:`attention_entries`); q and k of head dim D, v and o of Dv,
    each read or written once. A kernel's roofline bound is priced on
    these."""
    flops = (2.0 * B * Hq * attention_entries(seq_q, seq_kv, causal)
             * (head_dim + value_dim))
    byts = itemsize * (B * seq_q * Hq * (head_dim + value_dim)
                       + B * seq_kv * Hkv * (head_dim + value_dim))
    return flops, byts


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
    clamped blocks ``(min(block_q, Sq), min(block_k, Skv))``. Any lengths
    are taken: a ragged last block runs masked."""
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
    return (min(_positive("block_q", block_q), Sq),
            min(_positive("block_k", block_k), k.shape[1]))


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
                          kv_valid_len: Optional[torch.Tensor] = None,
                          round_p: bool = False, return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch, on any device: q ``[B, Sq,
    Hq, D]``, k/v ``[B, Skv, Hkv, D/Dv]`` -> ``[B, Sq, Hq, Dv]`` in v's
    dtype, f32 products and accumulation, blocks of ``block_q`` x
    ``block_k`` (a ragged last block is fine).

    ``round_p=True`` rounds p to v's dtype as the operand of p.v, as the
    kernels and the reference kernel do (``p.astype(v.dtype)``); ``l``
    stays the sum of the f32 p. The model's plain route keeps p in f32, as
    the reference model's chunked path does.

    Beyond the kernel's case it takes ``q_offset`` (absolute position of
    ``q[0]``), a local ``window`` (keys ``kpos > qpos - window``) and
    ``kv_valid_len`` (keys ``kpos < kv_valid_len``): the model's plain
    attention route. The kv blocks wholly past a q block's last row are
    skipped when the offset is a known int >= 0 and there is no kv mask;
    then every row has met its own diagonal before them, so they would add
    ``exp(-1e30 - m) = 0`` and rescale by 1, and skipping them is exact.

    ``return_lse=True`` also returns each row's log-sum-exp of its scaled
    scores, ``m + log l`` as ``[B, Hkv, G, Sq]`` f32 (G = Hq // Hkv): what
    the attention's backward recomputes p from."""
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
    lse = (torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
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
            if round_p:
                p = p.to(v.dtype).float()
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k0 + cols])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 3, 1, 2, 4).reshape(
            B, rows, Hq, Dv)
        if return_lse:
            lse[..., q0:q0 + rows] = m + torch.log(torch.clamp(l, min=1e-30))
    if return_lse:
        return out.to(v.dtype), lse
    return out.to(v.dtype)


def _scale(scale: Optional[float], head_dim: int) -> float:
    return head_dim ** -0.5 if scale is None else float(scale)


def unsupported(itemsize: int, head_dim: int, value_dim: int, block_q: int,
                block_k: int) -> Optional[str]:
    """Why the kernel is not built for these head dims and tiles, or
    ``None`` when it is: the one statement of what the f32 kernel
    (``csrc/flash_attention_f32.cuh``, ``itemsize`` 4) and the bf16 kernel
    (``csrc/flash_attention_sm90.cuh``, ``itemsize`` 2) instantiate, read
    by the wrapper and by the tuning space's prune. Head dims
    ``1..MAX_HEAD_DIM`` run at their class (:func:`head_dim_class`), whose
    tiles and shared memory are checked. The f32 kernel's tiles are built
    wherever they fit, some spilling registers (its only tile at (256,
    256), 32 x 64, spills 168 bytes); the bf16 kernel's but
    :data:`BF16_SPILLING_TILES`."""
    cls = head_dim_class(head_dim, value_dim)
    if cls is None:
        return (f"head-dim-range (the kernels take head dims 1 <= D, Dv <= "
                f"{MAX_HEAD_DIM}; got D {head_dim}, Dv {value_dim}: wider "
                f"heads are ROADMAP queue B, still to port)")
    head_dim, value_dim = cls
    q_opts, k_opts = tile_options(itemsize)
    if block_q not in q_opts or block_k not in k_opts:
        return (f"not-instantiated (the {itemsize}-byte kernel is built for "
                f"block_q in {q_opts}, block_k in {k_opts}; got "
                f"({block_q}, {block_k}))")
    smem = smem_bytes(itemsize, head_dim, block_q, block_k, value_dim)
    if smem > SMEM_LIMIT_BYTES:
        return (f"smem-overflow (tiles ({block_q}, {block_k}) need {smem} B "
                f"of shared memory at {itemsize}-byte elements, head-dim "
                f"class ({head_dim}, {value_dim}); a block has "
                f"{SMEM_LIMIT_BYTES} B)")
    if itemsize == 2 and (head_dim, value_dim, block_q,
                          block_k) in BF16_SPILLING_TILES:
        return (f"spills (tiles ({block_q}, {block_k}) at head-dim class "
                f"({head_dim}, {value_dim}) spill registers and are not "
                f"built; see BF16_SPILLING_TILES)")
    return None


def tma_strides(t: torch.Tensor) -> Tuple[int, ...]:
    """``t``'s strides (elements) with those of dims of size 1 replaced by
    the stride the dim would have in a contiguous tensor: such a dim is only
    ever indexed at 0, and its stride may be anything, which a TMA tensor
    map would refuse."""
    out, step = [], 1
    for size, stride in reversed(list(zip(t.shape, t.stride()))):
        out.append(step if size == 1 else stride)
        step = size * (step if size == 1 else stride)
    return tuple(reversed(out))


def _refusal(q, k, v, block_q: int, block_k: int) -> Optional[str]:
    """Why the CUDA kernel does not take these ``[B, S, H, D]`` tensors and
    tiles, or ``None`` when it does."""
    if q.dtype not in _DTYPE_CODES:
        return (f"the kernel takes float32 or bfloat16, got {q.dtype}"
                + ("; float16 attention is ROADMAP queue B, still to port"
                   if q.dtype == torch.float16 else ""))
    why = unsupported(q.element_size(), q.shape[-1], v.shape[-1], block_q,
                      block_k)
    if why is None and not q.is_cuda:
        why = (f"the flash_attention kernel takes CUDA tensors (or CPU "
               f"tensors for the plain version); got device {q.device}")
    return why


def copy_rule_holds(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte copies (TMA for bf16, cp.async and
    16-byte loads for f32) can read ``t`` where it lies: a contiguous last
    dim, a 16-byte aligned base and strides that are multiples of 16
    bytes."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s * t.element_size() % 16
                        for s in tma_strides(t)[:-1]))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a zeroed buffer whose last dim is rounded up to 16
    bytes: the buffer keeps the copy rule. The kernel reads only the first
    ``t.shape[-1]`` columns of each row (its true width)."""
    per = 16 // t.element_size()
    width = -(-t.shape[-1] // per) * per
    buf = t.new_zeros((*t.shape[:-1], width))
    buf[..., :t.shape[-1]] = t
    return buf


def _launch(q, k, v, causal: bool, scale: float, block_q: int,
            block_k: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise).
    A tensor that breaks the copy rule (:func:`copy_rule_holds`) is copied
    first (:func:`_padded`, counted in :data:`PADDED_COPIES`); the kernel
    takes the true head dims and the copy's strides."""
    global LAUNCHES, PADDED_COPIES
    why = _refusal(q, k, v, block_q, block_k)
    if why is not None:
        raise ValueError(why)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    bufs = []
    for t in (q, k, v):
        if not copy_rule_holds(t):
            t = _padded(t)
            PADDED_COPIES += 1
        bufs.append(t)
    from repro_torch.kernels import build
    lib = build.load_library()
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    qb, kb, vb = bufs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_flash_attention(
            _DTYPE_CODES[q.dtype], qb.data_ptr(), kb.data_ptr(),
            vb.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, Dv,
            *tma_strides(qb)[:3], *tma_strides(kb)[:3], *tma_strides(vb)[:3],
            *out.stride()[:3], int(bool(causal)), scale, block_q, block_k,
            stream)
    build.check_launch(code, f"flash_attention(q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, {q.dtype}, "
                             f"blocks ({block_q}, {block_k}))")
    LAUNCHES += 1
    key = launch_key(D, Dv, causal, Sq, Skv)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    from repro_torch.core import hlo_cost
    hlo_cost.charge_kernel("flash_attention", lambda: flash_attention_cost(
        B * Hq, Sq, Skv, D, Dv, q.element_size(), causal=causal,
        block_q=min(block_q, Sq), block_k=min(block_k, Skv)))
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
                                     block_q=bq, block_k=bk, round_p=True)
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
    (GQA lives in :func:`flash_attention_bshd`). As in the reference,
    ``min(block, S)`` must divide the sequence (``ValueError``
    otherwise)."""
    q4, k4, v4 = _as_bshd(q, "q"), _as_bshd(k, "k"), _as_bshd(v, "v")
    bq, bk = _check_bshd(q4, k4, v4, block_q, block_k)
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq % bq or Skv % bk:
        raise ValueError(
            f"blocks do not tile the sequences: Sq {Sq} % block_q {bq} = "
            f"{Sq % bq}, Skv {Skv} % block_k {bk} = {Skv % bk}")
    out = flash_attention_bshd(q4, k4, v4, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    return out[:, :, 0]
