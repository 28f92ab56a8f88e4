"""Per-kernel configuration spaces — enumerate, prune, validate.

Each CUDA kernel of the package gets a :class:`KernelSpace` that (1)
enumerates its launch knobs, (2) prunes candidates that cannot run well on
the card *before* anything is timed — a thread block of 256 threads moving
128-bit vectors covers 8 rows of 128 floats per step, so row counts that are
not multiples of 8 leave threads idle; the grid must divide the rows; flash
attention's tiles must be instantiated and fit in shared memory — and (3)
validates every surviving candidate against the oracles in
:mod:`repro_torch.kernels.ref` before it is allowed into the measurement
harness.

Validation contract: the VAI and membw spaces draw small *integer-valued*
float32 inputs, so every product and partial sum is exactly representable
and the kernel's output must equal the oracle **bit-for-bit**
(``max_abs_err == 0.0``), whatever order it sums in. Flash attention's
blocked online softmax reassociates the reduction, so its gate is the
pinned tolerance ``2e-5`` on normal f32 inputs instead.

Each space also carries the *analytic* cost of a candidate —
:class:`Candidate` records the pass's flops, its modeled HBM traffic, the
fast-memory bytes one thread block holds and the grid size — and renders it
as a roofline :class:`~repro_torch.core.power_model.StepProfile` under a
:class:`PerfParams` efficiency model. :class:`PerfParams.ideal` makes the
rendering collapse to the bare roofline (bit-for-bit
``ChipModel.vai_profile`` for the VAI space), which is how
``repro_torch.core.vai.run_sweep`` sits on this layer without moving a
float.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import DEFAULT_DEVICE, as_device
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel, StepProfile

#: width of every row the kernels take (floats)
LANE = 128
#: rows of 128 floats that one 256-thread block covers per step with 128-bit
#: loads; block/chunk row counts must be multiples of it
BLOCK_STEP_ROWS = 8
#: most blocks one grid dimension takes
MAX_GRID = 2 ** 31 - 1

Config = Tuple[Tuple[str, int], ...]


@dataclass(frozen=True)
class PerfParams:
    """Config-dependent efficiency knobs of the simulated timer.

    ``launch_overhead_s`` is added to the compute roofline term once per
    grid step (small blocks pay more steps); ``pipeline_rows`` models the
    compute-unit ramp — a block of ``r`` rows runs at efficiency
    ``r / (r + pipeline_rows)``, so tiny tiles never reach peak.
    :meth:`ideal` zeroes both, collapsing :meth:`KernelSpace.profile` to
    the bare roofline.
    """

    launch_overhead_s: float = 2e-6
    pipeline_rows: int = 32

    @classmethod
    def ideal(cls) -> "PerfParams":
        return cls(launch_overhead_s=0.0, pipeline_rows=0)

    def efficiency(self, *block_rows: int) -> float:
        eff = 1.0
        for r in block_rows:
            if self.pipeline_rows:
                eff *= r / (r + self.pipeline_rows)
        return eff


@dataclass(frozen=True)
class Candidate:
    """One enumerated kernel configuration plus its analytic cost."""

    kernel: str
    config: Config                 # sorted (knob, value) pairs — hashable
    flops: float                   # useful flops of one pass
    hbm_bytes: float               # modeled HBM traffic of one pass
    vmem_bytes: int                # fast (shared) memory one block holds
    grid_steps: int

    def get(self, knob: str) -> int:
        for k, v in self.config:
            if k == knob:
                return v
        raise KeyError(f"{self.kernel} candidate has no knob {knob!r}; "
                       f"knobs: {[k for k, _ in self.config]}")

    @property
    def config_dict(self) -> Dict[str, int]:
        return dict(self.config)

    @property
    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.config)


class ValidationError(AssertionError):
    """A candidate's output diverged from the oracle."""


def _check_positive_int(name: str, value) -> int:
    try:
        value = operator.index(value)
    except TypeError:
        raise ValueError(f"{name} must be an int, got {value!r}") from None
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")
    return value


class KernelSpace:
    """Base class: enumerate -> prune -> validate for one kernel.

    Subclasses define ``kernel``, ``_raw_configs()`` (the unpruned knob
    lattice, in enumeration order), ``_prune(config) -> Optional[str]``
    (a rejection reason, or None to keep), ``_candidate(config)`` (attach
    the analytic cost), ``_run(candidate)`` / ``_reference(candidate)``
    (the kernel vs the oracle, on the space's device) and
    ``profile(candidate, model, perf)`` (the roofline rendering).

    ``vmem_limit_bytes`` is the fast-memory boundary of the traffic models
    (default: the chip's ``vmem_bytes``, which for a GPU is its L2).
    """

    kernel: str = ""
    #: bit-for-bit oracle parity (integer-valued inputs); False = the
    #: space's pinned ``tol`` applies instead
    exact: bool = True
    tol: float = 0.0

    def __init__(self, chip: ChipSpec = H100_SXM,
                 vmem_limit_bytes: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        self.chip = ChipModel(chip).spec
        self.vmem_limit_bytes = int(
            self.chip.vmem_bytes if vmem_limit_bytes is None
            else vmem_limit_bytes)
        self.device = as_device(device)
        self._kept: Optional[List[Candidate]] = None
        self._pruned: Optional[List[Tuple[Config, str]]] = None

    # ------------------------------------------------------------ enumerate
    def enumerate_all(self) -> Tuple[List[Candidate],
                                     List[Tuple[Config, str]]]:
        """(kept candidates, pruned ``(config, reason)`` pairs), cached."""
        if self._kept is None:
            kept, pruned = [], []
            for config in self._raw_configs():
                reason = self._prune(config)
                if reason is None:
                    kept.append(self._candidate(config))
                else:
                    pruned.append((config, reason))
            self._kept, self._pruned = kept, pruned
        return list(self._kept), list(self._pruned)

    def candidates(self) -> List[Candidate]:
        return self.enumerate_all()[0]

    # ------------------------------------------------------------- validate
    def validate(self, candidate: Candidate) -> float:
        """Run the candidate on the space's device against the oracle.

        Returns the max abs error (0.0 for the exact spaces); raises
        :class:`ValidationError` on divergence."""
        out = self._run(candidate)
        want = self._reference(candidate)
        if self.exact and torch.equal(out, want):
            return 0.0
        err = float((out.double() - want.double()).abs().max()) \
            if out.numel() else 0.0
        if self.exact:
            raise ValidationError(
                f"{self.kernel}[{candidate.label}] diverged bit-for-bit "
                f"from kernels.ref (max abs err {err:.3g})")
        if err > self.tol or not bool(torch.isfinite(out).all()):
            raise ValidationError(
                f"{self.kernel}[{candidate.label}] exceeded the oracle "
                f"tolerance {self.tol:g} (max abs err {err:.3g})")
        return err

    def validate_all(self) -> Dict[Config, float]:
        return {c.config: self.validate(c) for c in self.candidates()}

    def release(self) -> None:
        """Drop the cached inputs (gigabytes at the sizes the card runs)."""

    # ------------------------------------------------- subclass obligations
    def _raw_configs(self) -> Sequence[Config]:
        raise NotImplementedError

    def _prune(self, config: Config) -> Optional[str]:
        raise NotImplementedError

    def _candidate(self, config: Config) -> Candidate:
        raise NotImplementedError

    def _run(self, candidate: Candidate):
        raise NotImplementedError

    def _reference(self, candidate: Candidate):
        raise NotImplementedError

    def profile(self, candidate: Candidate, model: ChipModel,
                perf: PerfParams) -> StepProfile:
        raise NotImplementedError

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def __repr__(self) -> str:
        kept, pruned = self.enumerate_all()
        return (f"{type(self).__name__}(chip={self.chip.name!r}, "
                f"{len(kept)} candidates, {len(pruned)} pruned)")


# ---------------------------------------------------------------------------
# VAI — block_rows x loopsize over the [rows, 128] elementwise pass
# ---------------------------------------------------------------------------
class VaiSpace(KernelSpace):
    """:func:`repro_torch.kernels.vai.vai` — knobs ``block_rows`` (rows one
    thread block owns) and ``loopsize`` (the paper's arithmetic-intensity
    dial; ``AI = 2 * loopsize / 16`` flops/byte in f32).

    ``loopsizes`` is part of the lattice on purpose: the VAI benchmark's
    whole point is walking the roofline, so the joint tuner can ask where
    on the (AI, block, frequency) grid each objective's optimum sits.
    Duplicate loopsizes are preserved in enumeration order so callers
    sweeping a fixed intensity list (``repro_torch.core.vai.run_sweep``)
    can zip candidates back to their sweep points.

    The kernel keeps everything in registers, so no fast-memory footprint
    limits ``block_rows``; what prunes it is the thread-block step (8 rows)
    and grid divisibility.
    """

    kernel = "vai"
    exact = True

    def __init__(self, n_elems: int = 1 << 18,
                 loopsizes: Sequence[int] = (8,),
                 block_rows_options: Sequence[int] = (128, 256, 512, 1024),
                 chip: ChipSpec = H100_SXM,
                 vmem_limit_bytes: Optional[int] = None, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__(chip, vmem_limit_bytes, device)
        self.n_elems = _check_positive_int("n_elems", n_elems)
        self.rows = max(self.n_elems // LANE, LANE)
        self.loopsizes = tuple(int(x) for x in loopsizes)
        self.block_rows_options = tuple(int(b) for b in block_rows_options)
        self.seed = seed
        self._inputs = None

    def _raw_configs(self):
        return [(("block_rows", br), ("loopsize", L))
                for L in self.loopsizes for br in self.block_rows_options]

    def _prune(self, config: Config) -> Optional[str]:
        cfg = dict(config)
        br, L = cfg["block_rows"], cfg["loopsize"]
        if L < 0:
            return "negative-loopsize"
        if br <= 0 or br % BLOCK_STEP_ROWS:
            return (f"block-misaligned (block_rows % {BLOCK_STEP_ROWS} != 0: "
                    f"256 threads x float4 cover {BLOCK_STEP_ROWS} rows)")
        if self.rows % min(br, self.rows):
            return f"indivisible ({self.rows} rows % {br})"
        if self.rows // min(br, self.rows) > MAX_GRID:
            return f"grid-overflow ({self.rows // br} blocks > {MAX_GRID})"
        return None

    def _candidate(self, config: Config) -> Candidate:
        from repro_torch.kernels.vai import vai_flops_bytes
        cfg = dict(config)
        br = min(cfg["block_rows"], self.rows)
        flops, byts = vai_flops_bytes(self.n_elems, cfg["loopsize"])
        return Candidate(kernel=self.kernel, config=config,
                         flops=float(flops), hbm_bytes=float(byts),
                         vmem_bytes=0,            # registers only
                         grid_steps=self.rows // br)

    # integer-valued f32 inputs: every x*y + acc is exact, so the kernel
    # must match the oracle bit-for-bit at any loopsize <= ~2^19
    def _get_inputs(self):
        if self._inputs is None:
            g = self._generator(self.seed)
            shape = (self.rows, LANE)
            self._inputs = tuple(
                torch.randint(0, 5, shape, generator=g, device=self.device,
                              dtype=torch.float32)
                for _ in range(3))
        return self._inputs

    def release(self) -> None:
        self._inputs = None

    def _run(self, candidate: Candidate):
        from repro_torch.kernels import ops
        a, b, c = self._get_inputs()
        return ops.vai_op(a, b, c, loopsize=candidate.get("loopsize"),
                          block_rows=candidate.get("block_rows"))

    def _reference(self, candidate: Candidate):
        from repro_torch.kernels import ref
        a, b, c = self._get_inputs()
        return ref.vai_ref(a, b, c, candidate.get("loopsize"))

    def profile(self, candidate: Candidate, model: ChipModel,
                perf: PerfParams) -> StepProfile:
        # VAI is a vector workload: vector peak = peak / 8 (the same unit
        # ChipModel.vai_profile uses — PerfParams.ideal() reproduces it
        # bit-for-bit)
        vector_peak = model.spec.peak_flops / 8.0
        eff = perf.efficiency(min(candidate.get("block_rows"), self.rows))
        compute_s = (candidate.flops / vector_peak / eff
                     + candidate.grid_steps * perf.launch_overhead_s)
        return StepProfile(compute_s=compute_s,
                           memory_s=candidate.hbm_bytes / model.spec.hbm_bw)


# ---------------------------------------------------------------------------
# membw — n_chunks over the L2-vs-HBM re-read probe
# ---------------------------------------------------------------------------
class MembwSpace(KernelSpace):
    """:func:`repro_torch.kernels.membw.membw` — knob ``n_chunks`` (the
    working set is ``n_chunks * chunk_rows`` rows; iteration ``i`` re-reads
    chunk ``i % n_chunks``, so a working set under the fast-memory boundary
    is served from the L2 after the cold pass while a larger one re-streams
    every iteration from HBM — the paper's Fig. 6 boundary).

    A chunk is streamed through registers and never resident, so its size
    is not limited; what prunes ``n_chunks`` is divisibility and the
    thread-block step (8 rows)."""

    kernel = "membw"
    exact = True

    def __init__(self, total_rows: int = 1 << 14, n_iters: int = 64,
                 n_chunks_options: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 chip: ChipSpec = H100_SXM,
                 vmem_limit_bytes: Optional[int] = None, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__(chip, vmem_limit_bytes, device)
        self.total_rows = _check_positive_int("total_rows", total_rows)
        self.n_iters = _check_positive_int("n_iters", n_iters)
        self.n_chunks_options = tuple(int(n) for n in n_chunks_options)
        self.seed = seed
        self._x = None

    def _raw_configs(self):
        return [(("n_chunks", n),) for n in self.n_chunks_options]

    def _prune(self, config: Config) -> Optional[str]:
        n = dict(config)["n_chunks"]
        if n <= 0:
            return "non-positive n_chunks"
        if self.total_rows % n:
            return f"indivisible ({self.total_rows} rows % {n} chunks)"
        chunk_rows = self.total_rows // n
        if chunk_rows % BLOCK_STEP_ROWS:
            return (f"block-misaligned (chunk_rows % {BLOCK_STEP_ROWS} != 0: "
                    f"256 threads x float4 cover {BLOCK_STEP_ROWS} rows)")
        return None

    def _candidate(self, config: Config) -> Candidate:
        n = dict(config)["n_chunks"]
        chunk_rows = self.total_rows // n
        chunk_bytes = chunk_rows * LANE * 4
        working_set = n * chunk_bytes
        # cold pass reads the working set once; re-reads hit the L2 only if
        # the whole rotation fits under the boundary
        if working_set <= self.vmem_limit_bytes:
            traffic = float(working_set)
        else:
            traffic = float(chunk_bytes) * self.n_iters
        return Candidate(kernel=self.kernel, config=config,
                         flops=float(chunk_rows * LANE * self.n_iters),
                         hbm_bytes=traffic,
                         vmem_bytes=BLOCK_STEP_ROWS * LANE * 4,  # lane combine
                         grid_steps=self.n_iters)

    def _get_x(self):
        if self._x is None:
            self._x = torch.randint(
                0, 4, (self.total_rows, LANE),
                generator=self._generator(self.seed), device=self.device,
                dtype=torch.float32)
        return self._x

    def release(self) -> None:
        self._x = None

    def _run(self, candidate: Candidate):
        from repro_torch.kernels import ops
        return ops.membw_op(self._get_x(),
                            n_chunks=candidate.get("n_chunks"),
                            n_iters=self.n_iters)

    def _reference(self, candidate: Candidate):
        from repro_torch.kernels import ref
        return ref.membw_ref(self._get_x(), candidate.get("n_chunks"),
                             self.n_iters)

    def profile(self, candidate: Candidate, model: ChipModel,
                perf: PerfParams) -> StepProfile:
        vector_peak = model.spec.peak_flops / 8.0
        chunk_rows = self.total_rows // candidate.get("n_chunks")
        eff = perf.efficiency(chunk_rows)
        compute_s = (candidate.flops / vector_peak / eff
                     + candidate.grid_steps * perf.launch_overhead_s)
        return StepProfile(compute_s=compute_s,
                           memory_s=candidate.hbm_bytes / model.spec.hbm_bw)


# ---------------------------------------------------------------------------
# flash attention — block_q x block_k over the online-softmax kernel
# ---------------------------------------------------------------------------
class FlashAttentionSpace(KernelSpace):
    """:func:`repro_torch.kernels.flash_attention.flash_attention` — knobs
    ``block_q`` / ``block_k``, the kernel's tiles.

    The reference prunes blocks that are not multiples of the TPU's 128-wide
    matrix unit and blocks whose q/k/v/o blocks and scratch overflow VMEM.
    The card's rules replace both, read from
    ``flash_attention.unsupported``: any head dims ``D, Dv >= 1``, as the
    reference takes any (up to 256 the kernel runs at their head-dim class,
    ``flash_attention.head_dim_class``; wider on its chunked
    instantiations, ``flash_attention.wide_split``), a tile must be one the
    kernel is instantiated for (``BLOCK_Q_OPTIONS`` x ``BLOCK_K_OPTIONS``,
    or ``WIDE_TILES`` above 256: the default options are the kernel's
    ``flash_attention.tile_options`` at the head dims), its shared memory
    at the class (Q split into two TF32 parts and the K and V slots;
    ``flash_attention.smem_bytes``) must fit in the 227 KB a block can
    have; and ``min(block, S)`` must divide the sequence. So the space
    keeps candidates at every head dim the reference tunes at, 96 and
    those above 256 too.

    The analytic cost describes what the kernel does. Causal attention
    skips the kv tiles that lie wholly above a q tile's diagonal (exact:
    they contribute ``exp(-1e30 - m) = 0``), so flops count only the
    (q tile, kv tile) pairs the kernel visits, ``2 * (D + Dv)`` a score
    entry (above 256, ``2 * (D * n_slices + Dv)``: the chunked kernel
    computes S once for each slice of v, one slice up to Dv = 512), where
    the reference counts the full rectangle. Traffic: q and o
    move once, K and V once per visited pair, in the inputs' itemsize. Both
    count the true head dims, as the reference's do, not the class's: a
    class's padded columns show as a lower achieved share, not as work.
    ``vmem_bytes`` is the block's shared memory; ``grid_steps`` the visited
    tile pairs, the counterpart of the reference's grid steps.
    """

    kernel = "flash_attention"
    exact = False
    tol = 2e-5                     # f32 contract of tests/test_kernels.py

    def __init__(self, batch_heads: int = 4, seq_q: int = 1024,
                 seq_kv: Optional[int] = None, head_dim: int = 128,
                 value_dim: Optional[int] = None, causal: bool = True,
                 block_q_options: Optional[Sequence[int]] = None,
                 block_k_options: Optional[Sequence[int]] = None,
                 chip: ChipSpec = H100_SXM,
                 vmem_limit_bytes: Optional[int] = None, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__(chip, vmem_limit_bytes, device)
        self.batch_heads = _check_positive_int("batch_heads", batch_heads)
        self.seq_q = _check_positive_int("seq_q", seq_q)
        self.seq_kv = self.seq_q if seq_kv is None \
            else _check_positive_int("seq_kv", seq_kv)
        self.head_dim = _check_positive_int("head_dim", head_dim)
        self.value_dim = self.head_dim if value_dim is None \
            else _check_positive_int("value_dim", value_dim)
        self.causal = bool(causal)
        # the kernel's instantiated tiles at these head dims by default
        from repro_torch.kernels import flash_attention as fa
        q_opts, k_opts = fa.tile_options(4, self.head_dim, self.value_dim)
        self.block_q_options = tuple(int(b) for b in (
            q_opts if block_q_options is None else block_q_options))
        self.block_k_options = tuple(int(b) for b in (
            k_opts if block_k_options is None else block_k_options))
        self.seed = seed
        self.itemsize = 4                          # f32 inputs
        self._qkv = None

    def _raw_configs(self):
        return [(("block_k", bk), ("block_q", bq))
                for bq in self.block_q_options
                for bk in self.block_k_options]

    def _prune(self, config: Config) -> Optional[str]:
        from repro_torch.kernels import flash_attention as fa
        cfg = dict(config)
        bq, bk = cfg["block_q"], cfg["block_k"]
        why = fa.unsupported(self.itemsize, self.head_dim, self.value_dim,
                             bq, bk)
        if why is not None:
            return why
        if self.seq_q % min(bq, self.seq_q):
            return f"indivisible (seq_q {self.seq_q} % block_q {bq})"
        if self.seq_kv % min(bk, self.seq_kv):
            return f"indivisible (seq_kv {self.seq_kv} % block_k {bk})"
        return None

    def _candidate(self, config: Config) -> Candidate:
        from repro_torch.kernels import flash_attention as fa
        cfg = dict(config)
        bq, bk = cfg["block_q"], cfg["block_k"]
        bh, sq = self.batch_heads, self.seq_q
        d, dv, it = self.head_dim, self.value_dim, self.itemsize
        _, _, pairs = fa.flash_attention_work(
            sq, self.seq_kv, causal=self.causal, block_q=bq, block_k=bk)
        flops, hbm_bytes = fa.flash_attention_cost(
            bh, sq, self.seq_kv, d, dv, it, causal=self.causal, block_q=bq,
            block_k=bk)
        return Candidate(
            kernel=self.kernel, config=config,
            flops=flops, hbm_bytes=hbm_bytes,
            vmem_bytes=fa.smem_bytes(it, d, bq, bk, dv),
            grid_steps=bh * pairs)

    def _get_qkv(self):
        if self._qkv is None:
            g = self._generator(self.seed)
            self._qkv = tuple(
                torch.randn(shape, generator=g, device=self.device,
                            dtype=torch.float32)
                for shape in ((self.batch_heads, self.seq_q, self.head_dim),
                              (self.batch_heads, self.seq_kv, self.head_dim),
                              (self.batch_heads, self.seq_kv,
                               self.value_dim)))
        return self._qkv

    def release(self) -> None:
        self._qkv = None

    def _run(self, candidate: Candidate):
        from repro_torch.kernels.flash_attention import flash_attention
        q, k, v = self._get_qkv()
        return flash_attention(q, k, v, causal=self.causal,
                               block_q=candidate.get("block_q"),
                               block_k=candidate.get("block_k"))

    def _reference(self, candidate: Candidate):
        from repro_torch.kernels import ref
        q, k, v = self._get_qkv()
        return ref.attention_ref(q, k, v, causal=self.causal)

    def profile(self, candidate: Candidate, model: ChipModel,
                perf: PerfParams) -> StepProfile:
        cfg = candidate.config_dict
        eff = perf.efficiency(cfg["block_q"], cfg["block_k"])
        compute_s = (candidate.flops / model.spec.peak_flops / eff
                     + candidate.grid_steps * perf.launch_overhead_s)
        return StepProfile(compute_s=compute_s,
                           memory_s=candidate.hbm_bytes / model.spec.hbm_bw)
