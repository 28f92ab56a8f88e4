"""Out-of-core telemetry ingestion and counterfactual policy replay.

The paper's headline numbers come from three months of Frontier telemetry —
a trace that never fits in one in-memory array. This module is the
O(shard)-memory path through it, with the reference's names and contracts:

* :class:`SampleShard` — one columnar chunk of a telemetry stream: float64
  tensors on one device (power, duration, energy, optional recorded mode,
  clock and wall-clock stamps) and a numpy unicode ``job_id`` column (torch
  has no string tensor). Built from tensors, arrays, ``StepSample`` lists,
  JSONL sample logs (:func:`iter_jsonl`), the ``.npz`` spill files of
  :meth:`repro_torch.core.telemetry.TelemetryStore.spill_npz`
  (:func:`iter_npz`) or a :class:`~repro_torch.power.jobs.JobTable`
  (:func:`iter_jobs`);
* :class:`StreamingModal` — incremental fleet and per-job per-mode
  hour/energy accumulators, **bit-for-bit** equal to
  :func:`repro_torch.core.modal.decompose_batch` on the concatenated trace
  for any shard boundaries: samples buffer into the same aligned 128-sample
  segments, each segment goes through the same
  :func:`~repro_torch.core.modal._segment_sums`, and the segment sums fold
  left to right through :func:`~repro_torch.core.modal.fold_segments`.
  Every job of a shard is folded together: its job-contiguous runs are
  gathered into job-aligned segments in one indexing pass, so the launches
  a shard costs do not grow with the jobs in it;
* :class:`StreamingTelemetry` — :class:`StreamingModal` plus a streaming
  power histogram (``torch.histc`` per shard, integer counts);
  :meth:`StreamingTelemetry.fleet` hands the finished accumulators to the
  unchanged ``FleetAnalysis`` modal -> projection pipeline;
* :func:`replay` — re-run a recorded trace under any policy and any chip:
  per shard one ``infer_profiles`` and one ``decide_batch`` on the shard's
  device (or a :class:`repro_torch.parallel.ShardedExecutor`'s deduplicated
  and memoized pass, the same bits), yielding per-job and fleet
  energy/runtime deltas.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import asdict, dataclass
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import as_device, f64
from repro_torch.core.hardware import ChipSpec, MI250X_GCD, MODES
from repro_torch.core.modal import (BatchModalDecomposition,
                                    ModalDecomposition,
                                    STREAM_SEGMENT as SEG, _segment_sums,
                                    classify_power, fold_segments)
from repro_torch.core.power_model import ChipModel
from repro_torch.core.projection import (ProjectionRow, ResponseTables,
                                         project_from_decomposition)
from repro_torch.core.telemetry import StepSample, TelemetryStore, load_spill
from repro_torch.power.policies import PolicyLike, decide_batch, get_policy

_N_MODES = len(MODES)
_MODE_IDXS = tuple(m.idx for m in MODES)

ShardLike = Union["SampleShard", torch.Tensor, np.ndarray,
                  Sequence[StepSample]]


# ---------------------------------------------------------------------------
# Shards + stream sources
# ---------------------------------------------------------------------------
@dataclass
class SampleShard:
    """One chunk of a telemetry stream, columnar. ``power_w`` is the only
    physically required signal; ``duration_s``/``energy_j`` default to the
    sample interval and ``power * duration``. ``mode`` (recorded structural
    mode index, 1..4) and ``freq_mhz`` (recorded clock) are optional — when
    absent, consumers classify by power band / assume nominal clock. Every
    column but ``job_id`` is a tensor on the device of ``power_w``."""

    power_w: torch.Tensor                   # (n,) float64
    job_id: np.ndarray                      # (n,) unicode, host
    duration_s: torch.Tensor                # (n,) float64
    energy_j: torch.Tensor                  # (n,) float64
    mode: Optional[torch.Tensor] = None     # (n,) int64, 1..4
    freq_mhz: Optional[torch.Tensor] = None  # (n,) float64
    time_s: Optional[torch.Tensor] = None   # (n,) float64 wall-clock stamps

    def __len__(self) -> int:
        return int(self.power_w.numel())

    @property
    def device(self) -> torch.device:
        return self.power_w.device

    @classmethod
    def from_arrays(cls, power_w, job_id: Union[str, np.ndarray] = "job0",
                    duration_s=None, energy_j=None, mode=None,
                    freq_mhz=None,
                    sample_interval_s: float = 15.0,
                    time_s=None, device=None) -> "SampleShard":
        """A tensor ``power_w`` stays on its device (slices stay views);
        arrays go to ``device`` (default the card). The other columns
        follow ``power_w``."""
        p = f64(power_w, device).reshape(-1)
        dev = p.device
        n = p.numel()
        jid = np.asarray(job_id)
        if jid.ndim == 0:
            jid = np.broadcast_to(jid, (n,))
        if duration_s is None:
            dur = torch.full((n,), float(sample_interval_s),
                             dtype=torch.float64, device=dev)
        else:
            dur = f64(duration_s, dev)
            dur = torch.full((n,), float(dur), dtype=torch.float64,
                             device=dev) if dur.ndim == 0 else dur.reshape(-1)
        e = None if energy_j is None else f64(energy_j, dev).reshape(-1)
        md = None if mode is None else torch.as_tensor(
            np.asarray(mode) if not isinstance(mode, torch.Tensor) else mode,
            device=dev).to(torch.int64).reshape(-1)
        fq = None if freq_mhz is None else f64(freq_mhz, dev).reshape(-1)
        ts = None if time_s is None else f64(time_s, dev).reshape(-1)
        for name, arr in (("job_id", jid), ("duration_s", dur),
                          ("energy_j", e), ("mode", md),
                          ("freq_mhz", fq), ("time_s", ts)):
            if arr is not None and tuple(arr.shape) != (n,):
                raise ValueError(f"shard field {name} has shape "
                                 f"{tuple(arr.shape)}, expected ({n},)")
        return cls(p, jid, dur, e if e is not None else p * dur, md, fq,
                   ts)

    @classmethod
    def from_samples(cls, samples: Sequence[StepSample],
                     device=None) -> "SampleShard":
        return cls.from_arrays(
            [s.power_w for s in samples],
            job_id=np.array([s.job_id for s in samples], dtype=np.str_),
            duration_s=[s.duration_s for s in samples],
            energy_j=[s.energy_j for s in samples],
            mode=[s.mode for s in samples],
            freq_mhz=[s.freq_mhz for s in samples], device=device)

    @classmethod
    def coerce(cls, obj: ShardLike, sample_interval_s: float = 15.0,
               device=None) -> "SampleShard":
        if isinstance(obj, SampleShard):
            return obj
        if isinstance(obj, (list, tuple)) and obj \
                and isinstance(obj[0], StepSample):
            return cls.from_samples(obj, device=device)
        return cls.from_arrays(obj, sample_interval_s=sample_interval_s,
                               device=device)


def iter_array(power_w, chunk: int = 65536, job_id: str = "job0",
               sample_interval_s: float = 15.0,
               device=None) -> Iterator[SampleShard]:
    """A flat power tensor as a chunked stream: views on the tensor's own
    device, no copy (an array is copied to ``device`` once, default the
    card)."""
    p = f64(power_w, device).reshape(-1)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for start in range(0, p.numel(), chunk):
        yield SampleShard.from_arrays(p[start:start + chunk], job_id=job_id,
                                      sample_interval_s=sample_interval_s)


def write_jsonl(samples: Iterable[StepSample], path: str,
                append: bool = False) -> int:
    """Per-sample log: one ``StepSample`` JSON dict per line — the
    raw-sample counterpart of the window-level ``.npz`` spill. Overwrites
    ``path`` unless ``append=True`` (long-running drivers append batches)."""
    n = 0
    with open(path, "a" if append else "w") as f:
        for s in samples:
            f.write(json.dumps(asdict(s)) + "\n")
            n += 1
    return n


def iter_jsonl(path: str, chunk: int = 65536,
               device=None) -> Iterator[SampleShard]:
    """Stream a :func:`write_jsonl` sample log back as shards of ``chunk``
    samples on ``device`` (default the card) — only one chunk of parsed
    samples is alive at a time."""
    buf: List[StepSample] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            buf.append(StepSample(**json.loads(line)))
            if len(buf) >= chunk:
                yield SampleShard.from_samples(buf, device=device)
                buf = []
    if buf:
        yield SampleShard.from_samples(buf, device=device)


def _shard_from_windows(windows, device=None) -> SampleShard:
    """Window-to-sample mapping shared by every window-level source: each
    aggregated window contributes its mean power as one sample (the same
    mapping as ``store.powers()``), its true energy, and its summed
    duration (``energy / mean power``), computed on the host."""
    energy = np.array([w.energy_j for w in windows], dtype=np.float64)
    mean_p = np.array([w.mean_power_w for w in windows], dtype=np.float64)
    return SampleShard.from_arrays(
        mean_p,
        job_id=np.array([w.job_id for w in windows], dtype=np.str_),
        duration_s=energy / np.maximum(mean_p, 1e-9),
        energy_j=energy, device=device)


def iter_store(store: TelemetryStore,
               device=None) -> Iterator[SampleShard]:
    """A live :class:`TelemetryStore`'s aggregated windows as one shard on
    ``device`` (see :func:`_shard_from_windows` for the mapping)."""
    store.flush()
    ws = list(store.windows)
    if ws:
        yield _shard_from_windows(ws, device)


def iter_npz(paths: Union[str, Sequence[str]],
             device=None) -> Iterator[SampleShard]:
    """Stream :meth:`TelemetryStore.spill_npz` files, one shard per spill —
    the out-of-core path: a month-scale run spills periodically, and the
    analysis never holds more than one spill's windows in memory."""
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        windows, _window_s = load_spill(path)
        if windows:
            yield _shard_from_windows(windows, device)


def iter_jobs(table, samples_per_shard: int = 65536
              ) -> Iterator[SampleShard]:
    """A :class:`repro_torch.power.jobs.JobTable` as a job-ordered stream on
    the table's device; shards pack multiple jobs and split long jobs
    mid-trace at the reference's boundaries (every ``samples_per_shard``
    samples of the concatenated trace). Each shard carries per-sample
    ``time_s`` stamps (job arrival + sample offset), so the table's
    schedule round-trips through the stream —
    :meth:`repro_torch.power.broker.ClusterTrace.from_stream` rebuilds
    arrivals from them. (Also reachable as ``table.to_stream()``.)"""
    if samples_per_shard < 1:
        raise ValueError(
            f"samples_per_shard must be >= 1, got {samples_per_shard}")
    dt = float(table.sample_interval_s)
    flat = table.concat_powers()                     # row after row
    lengths = table.lengths
    # the same elementwise arrival + dt * offset the reference forms
    offset = torch.arange(int(lengths.max()), dtype=torch.float64,
                          device=flat.device)[None, :].expand(
        lengths.numel(), -1)[table.mask]
    stamps = torch.repeat_interleave(table.arrival_s, lengths) + dt * offset
    jids = np.repeat(np.array(table.job_ids),
                     lengths.cpu().numpy())
    for start in range(0, flat.numel(), samples_per_shard):
        stop = start + samples_per_shard
        yield SampleShard.from_arrays(
            flat[start:stop], job_id=jids[start:stop],
            sample_interval_s=dt, time_s=stamps[start:stop])


# ---------------------------------------------------------------------------
# Streaming modal accumulators
# ---------------------------------------------------------------------------
def _contrib(p: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """The ``p * (mode == idx)`` rows decompose_batch reduces, one per mode,
    plus the all-samples total row: ``(modes + 1, ...)``."""
    return torch.stack([p * (modes == idx) for idx in _MODE_IDXS] + [p])


class _ModalAcc:
    """Per-mode running reductions for a set of scopes ("slots"): the
    fleet (one slot) or every job of a stream.

    Mirrors :func:`repro_torch.core.modal.stream_sum` exactly: each slot's
    samples buffer into :data:`STREAM_SEGMENT`-aligned segments relative to
    the slot's own start, every completed segment goes through
    :func:`_segment_sums` on the same 128-vector the batch reduction sees,
    and a slot's segment sums fold strictly left to right into its host
    carry (:func:`fold_segments`). The open partial segment of every slot
    is a zero-padded row of a ``(slots, SEG)`` device buffer, so finalizing
    reduces the same padded tail segment the batch does. ``counts`` are
    exact integers.

    ``seg_fn`` replaces :func:`_segment_sums` of :meth:`fold` (the fleet's
    one-slot path) with a reducer of the same ``(modes + 1, segments)``
    layout and the same bits: :meth:`repro_torch.parallel.ShardedExecutor.
    segment_sums` plugs in here."""

    def __init__(self, seg_fn=None) -> None:
        self.carry = np.zeros((0, _N_MODES + 1), dtype=np.float64)
        self.counts = np.zeros((0, _N_MODES), dtype=np.int64)
        self.n = np.zeros(0, dtype=np.int64)
        self.buf_len = np.zeros(0, dtype=np.int64)
        self._buf_p: Optional[torch.Tensor] = None     # (capacity, SEG)
        self._buf_m: Optional[torch.Tensor] = None
        self._seg_fn = seg_fn

    @property
    def n_slots(self) -> int:
        return int(self.n.size)

    def _grow(self, n_slots: int, device) -> None:
        old = self.n_slots
        if n_slots <= old:
            return
        extra = n_slots - old
        self.carry = np.concatenate(
            [self.carry, np.zeros((extra, _N_MODES + 1))])
        self.counts = np.concatenate(
            [self.counts, np.zeros((extra, _N_MODES), dtype=np.int64)])
        self.n = np.concatenate([self.n, np.zeros(extra, dtype=np.int64)])
        self.buf_len = np.concatenate(
            [self.buf_len, np.zeros(extra, dtype=np.int64)])
        cap = 0 if self._buf_p is None else self._buf_p.shape[0]
        if n_slots > cap:
            new_cap = max(n_slots, 2 * cap, 1)
            bp = torch.zeros((new_cap, SEG), dtype=torch.float64,
                             device=device)
            bm = torch.zeros((new_cap, SEG), dtype=torch.int64, device=device)
            if cap:
                bp[:cap] = self._buf_p
                bm[:cap] = self._buf_m
            self._buf_p, self._buf_m = bp, bm

    def fold(self, p: torch.Tensor, modes: torch.Tensor) -> None:
        """Fold a shard into slot 0 (the one-scope fast path: no gather)."""
        if p.numel() == 0:
            return
        self._grow(1, p.device)
        modes = modes.to(torch.int64)
        self.counts[0] += torch.stack(
            [(modes == idx).sum() for idx in _MODE_IDXS]).cpu().numpy()
        self.n[0] += p.numel()
        bl = int(self.buf_len[0])
        if bl:
            p = torch.cat([self._buf_p[0, :bl], p])
            modes = torch.cat([self._buf_m[0, :bl], modes])
        k = (p.numel() // SEG) * SEG
        if k:
            if self._seg_fn is not None:
                seg = self._seg_fn(p[:k], modes[:k])
            else:
                seg = _segment_sums(_contrib(p[:k], modes[:k]).reshape(
                    _N_MODES + 1, -1, SEG))
            self.carry[0] = fold_segments(seg, self.carry[0])
        rest = p.numel() - k
        self._buf_p[0].zero_()
        self._buf_m[0].zero_()
        self._buf_p[0, :rest] = p[k:]
        self._buf_m[0, :rest] = modes[k:]
        self.buf_len[0] = rest

    def fold_slots(self, p: torch.Tensor, modes: torch.Tensor,
                   slot: np.ndarray, n_slots: int) -> None:
        """Fold a shard whose samples belong to several slots (``slot``:
        host int64 per sample). Every slot's pending samples — its buffered
        partial segment, then its samples of this shard in order — are laid
        out back to back; the complete segments of all slots are gathered
        into one ``(segments, SEG)`` matrix and the remainders into the
        slots' buffer rows, each by one indexing pass on the device."""
        if p.numel() == 0:
            return
        dev = p.device
        self._grow(n_slots, dev)
        modes = modes.to(torch.int64)
        n = p.numel()
        present, cnt = np.unique(slot, return_counts=True)
        order = np.argsort(slot, kind="stable")      # slot-major, in time
        bl = self.buf_len[present]
        pend = bl + cnt
        nseg = pend // SEG
        k_slots = present.size
        start = np.concatenate([[0], np.cumsum(pend)[:-1]])
        rep = np.repeat(np.arange(k_slots), pend)
        within = np.arange(int(pend.sum())) - start[rep]
        cap = self._buf_p.shape[0]
        src = np.empty(rep.size, dtype=np.int64)
        in_buf = within < bl[rep]
        src[in_buf] = present[rep[in_buf]] * SEG + within[in_buf]
        src[~in_buf] = cap * SEG + order
        zero = cap * SEG + n                         # index of a 0 entry
        is_seg = within < nseg[rep] * SEG
        seg_idx = src[is_seg].reshape(-1, SEG)
        rem_idx = np.full((k_slots, SEG), zero, dtype=np.int64)
        tail = ~is_seg
        rem_idx[rep[tail], within[tail] - nseg[rep[tail]] * SEG] = src[tail]

        src_p = torch.cat([self._buf_p.reshape(-1), p,
                           p.new_zeros(1)])
        src_m = torch.cat([self._buf_m.reshape(-1), modes,
                           modes.new_zeros(1)])
        # per-slot mode counts: one bincount over (slot, mode) keys
        key = torch.from_numpy(slot.astype(np.int64) * (_N_MODES + 1)).to(
            dev) + modes
        counts = torch.bincount(key, minlength=n_slots * (_N_MODES + 1))
        self.counts[:n_slots] += counts.reshape(
            n_slots, _N_MODES + 1)[:, 1:].cpu().numpy()
        self.n[present] += cnt
        if seg_idx.size:
            gi = torch.from_numpy(seg_idx).to(dev)
            seg = _segment_sums(_contrib(src_p[gi], src_m[gi]))
            host = seg.cpu().numpy()                 # (modes + 1, segments)
            ends = np.cumsum(nseg)
            for k in np.flatnonzero(nseg):
                s = present[k]
                self.carry[s] = fold_segments(
                    host[:, ends[k] - nseg[k]:ends[k]], self.carry[s])
        ri = torch.from_numpy(rem_idx).to(dev)
        rows = torch.from_numpy(present).to(dev)
        self._buf_p[rows] = src_p[ri]
        self._buf_m[rows] = src_m[ri]
        self.buf_len[present] = pend - nseg * SEG

    def totals(self) -> np.ndarray:
        """``(slots, modes + 1)`` running W-sums, open partial segments
        included (zero-padded to SEG, the same vector the batch's tail
        segment reduces). Non-destructive — analysis mid-stream keeps
        streaming."""
        if self.n_slots == 0:
            return self.carry
        s = self.n_slots
        tail = _segment_sums(_contrib(self._buf_p[:s], self._buf_m[:s]))
        return self.carry + tail.cpu().numpy().T


class StreamingModal:
    """Incremental :func:`repro_torch.core.modal.decompose_batch`: fold
    power samples chunk by chunk and finalize into the same
    :class:`ModalDecomposition` / :class:`BatchModalDecomposition` the
    one-shot pipeline produces — bit-for-bit, for any shard boundaries
    (including shards that split mid-window or mid-job; a job's samples
    may arrive in any number of separated runs). Accumulates on the
    shards' device; the per-job rows come back on it. With an ``executor``
    (:class:`repro_torch.parallel.ShardedExecutor`) the fleet scope's
    segment sums run on its devices, with the same bits; per-job scopes
    stay on the plain path."""

    def __init__(self, chip: ChipSpec = MI250X_GCD,
                 sample_interval_s: float = 15.0, track_jobs: bool = True,
                 executor=None):
        self.chip = chip if isinstance(chip, ChipSpec) \
            else ChipModel(chip).spec
        self.sample_interval_s = float(sample_interval_s)
        self.track_jobs = track_jobs      # False: fleet scope only
        self._fleet = _ModalAcc(
            seg_fn=executor.segment_sums if executor is not None else None)
        self._jobs = _ModalAcc()
        self._slot: Dict[str, int] = {}   # job id -> slot, first-seen order
        self.device: Optional[torch.device] = None

    # ------------------------------------------------------------- folding
    def fold(self, power_w, job_id: np.ndarray, modes=None) -> None:
        """Fold one chunk. ``modes`` lets a caller that already holds this
        chip's power-band classification of ``power_w`` pass it in instead
        of classifying twice — it must equal ``classify_power(power_w,
        self.chip)``; pass ``None`` to classify here."""
        p = f64(power_w, self.device).reshape(-1)
        if p.numel() == 0:
            return
        self.device = p.device
        if modes is None:
            modes = classify_power(p, self.chip)
        self._fleet.fold(p, modes)
        if not self.track_jobs:
            return
        jids = np.asarray(job_id)
        if jids.ndim == 0 or jids.strides == (0,):
            # one id broadcast over the shard: no string sort needed
            slot = self._slot.setdefault(str(jids.reshape(-1)[0]),
                                         len(self._slot))
            slots = np.full(p.numel(), slot, dtype=np.int64)
        else:
            uniq, first, inv = np.unique(jids, return_index=True,
                                         return_inverse=True)
            slot_of = np.empty(uniq.size, dtype=np.int64)
            for k in np.argsort(first):              # first-seen order
                slot_of[k] = self._slot.setdefault(str(uniq[k]),
                                                   len(self._slot))
            slots = slot_of[inv.reshape(-1)]
        self._jobs.fold_slots(p, modes, slots, len(self._slot))

    # ------------------------------------------------------------ finalize
    @property
    def n_samples(self) -> int:
        return int(self._fleet.n.sum())

    def job_ids(self) -> List[str]:
        return list(self._slot)

    def _finalize(self, acc: _ModalAcc
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        # exactly decompose_batch's finalization arithmetic, in its order
        to_mwh = self.sample_interval_s / 3600.0 / 1e6
        n = np.maximum(acc.n, 1)
        hours = 100.0 * acc.counts.astype(np.float64) / n[:, None]
        sums = acc.totals()
        return hours, sums[:, :_N_MODES] * to_mwh, sums[:, _N_MODES] * to_mwh

    def decomposition(self) -> ModalDecomposition:
        """Fleet-level result == ``decompose(concatenated_powers)``."""
        if self._fleet.n_slots == 0:
            hours = energy = np.zeros(_N_MODES)
            total = 0.0
        else:
            h, e, t = self._finalize(self._fleet)
            hours, energy, total = h[0], e[0], float(t[0])
        return ModalDecomposition(
            hours_pct={m.idx: float(hours[i]) for i, m in enumerate(MODES)},
            energy_mwh={m.idx: float(energy[i])
                        for i, m in enumerate(MODES)},
            total_energy_mwh=total,
            sample_interval_s=self.sample_interval_s)

    def per_job(self) -> BatchModalDecomposition:
        """Per-job result == ``decompose_batch`` over the job-grouped
        ``(jobs, samples)`` matrix (rows in first-seen job order, matching
        ``TelemetryStore.powers_by_job`` / ``JobTable.from_store``), as
        tensors on the stream's device."""
        if not self._slot:
            raise ValueError("no samples ingested yet")
        hours, energy, total = self._finalize(self._jobs)
        dev = self.device
        return BatchModalDecomposition(
            hours_pct=torch.from_numpy(hours).to(dev),
            energy_mwh=torch.from_numpy(np.ascontiguousarray(energy)).to(dev),
            total_energy_mwh=torch.from_numpy(
                np.ascontiguousarray(total)).to(dev),
            sample_interval_s=self.sample_interval_s,
            n_samples=torch.from_numpy(self._jobs.n.copy()).to(dev))


class StreamingTelemetry:
    """Chunked telemetry ingestion with O(shard) memory:
    :class:`StreamingModal` accumulators plus a streaming fleet power
    histogram, fed by ``ingest(shard)`` / ``extend(stream)``.

    The histogram's range is fixed at construction (``max_w`` defaults to
    1.25x the chip's TDP; overflow clips into the top bin, matching
    :func:`repro_torch.core.modal.power_histogram`), because a streaming
    pass cannot know the global maximum up front. Each shard is binned by
    the same ``torch.histc`` call as ``power_histogram`` and the integer
    counts accumulate exactly, so the finalized density equals the one-shot
    histogram of the concatenated trace bit-for-bit. ``device`` places
    array shards (tensor shards stay where they lie).
    """

    def __init__(self, chip: ChipSpec = MI250X_GCD,
                 sample_interval_s: float = 15.0, bins: int = 120,
                 max_w: Optional[float] = None, track_jobs: bool = True,
                 executor=None, device=None):
        self.modal = StreamingModal(chip, sample_interval_s,
                                    track_jobs=track_jobs,
                                    executor=executor)
        self.chip = self.modal.chip
        self.sample_interval_s = self.modal.sample_interval_s
        self.bins = int(bins)
        self.max_w = float(max_w) if max_w is not None \
            else float(self.chip.tdp_w) * 1.25
        self._device = device
        self._hist: Optional[torch.Tensor] = None     # int64 counts

    @property
    def edges(self) -> torch.Tensor:
        """The ``bins + 1`` bin edges over ``[0, max_w]``, as
        ``power_histogram`` forms them (on the host before any sample)."""
        dev = self.modal.device or torch.device("cpu")
        return torch.linspace(0.0, self.max_w, self.bins + 1,
                              dtype=torch.float64, device=dev)

    # ------------------------------------------------------------ ingestion
    def ingest(self, shard: ShardLike) -> "StreamingTelemetry":
        sh = SampleShard.coerce(shard, self.sample_interval_s, self._device)
        if len(sh) == 0:
            return self
        self.modal.fold(sh.power_w, sh.job_id)
        counts = torch.histc(torch.clamp(sh.power_w, max=self.max_w),
                             bins=self.bins, min=0.0, max=self.max_w)
        counts = counts.to(torch.int64)
        self._hist = counts if self._hist is None else self._hist + counts
        return self

    def extend(self, stream: Iterable[ShardLike]) -> "StreamingTelemetry":
        for shard in stream:
            self.ingest(shard)
        return self

    # ------------------------------------------------------------- analysis
    @property
    def n_samples(self) -> int:
        return self.modal.n_samples

    def job_ids(self) -> List[str]:
        return self.modal.job_ids()

    def decomposition(self) -> ModalDecomposition:
        return self.modal.decomposition()

    def per_job(self) -> BatchModalDecomposition:
        return self.modal.per_job()

    def hist_counts(self) -> torch.Tensor:
        """The integer bin counts so far (``(bins,)`` int64)."""
        if self._hist is None:
            return torch.zeros(self.bins, dtype=torch.int64)
        return self._hist

    def histogram(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bin centers, density) == ``power_histogram(concat, bins,
        max_w)``; empty before any sample arrives."""
        if self.n_samples == 0:
            empty = torch.empty(0, dtype=torch.float64)
            return empty, empty.clone()
        edges = self.edges
        counts = self._hist.to(torch.float64)
        hist = counts / counts.sum() / (edges[1:] - edges[:-1])
        return 0.5 * (edges[:-1] + edges[1:]), hist

    def fleet(self):
        """Hand the finished accumulators to the unchanged modal ->
        projection pipeline: a :class:`repro_torch.power.fleet.
        FleetAnalysis` whose ``project`` / ``project_jobs`` /
        ``job_report`` behave as if the concatenated trace had been
        materialized."""
        from repro_torch.power.fleet import FleetAnalysis
        dev = self.modal.device or as_device(self._device)
        fa = FleetAnalysis(torch.empty(0, dtype=torch.float64, device=dev),
                           chip=self.chip,
                           sample_interval_s=self.sample_interval_s)
        fa.attach_stream(self)
        return fa


# ---------------------------------------------------------------------------
# Counterfactual replay
# ---------------------------------------------------------------------------
@dataclass
class ReplayJobRow:
    """One job's recorded-vs-replayed energy/runtime.

    ``energy_base_j`` is the model's nominal-frequency energy of the same
    inferred steps — the counterfactual "leave the clocks alone" run.
    Savings compare against *it* (the session's ``savings_pct`` semantics),
    so reconstruction bias on samples the power model cannot represent
    exactly (e.g. low-power latency-mode readings) cancels out instead of
    polluting the policy delta; ``energy_rec_j`` keeps the recorded truth.
    """
    job_id: str
    n_samples: int
    energy_rec_j: float
    energy_base_j: float
    energy_new_j: float
    time_rec_s: float
    time_new_s: float

    @property
    def savings_pct(self) -> float:
        return 100.0 * (1.0 - self.energy_new_j
                        / max(self.energy_base_j, 1e-12))

    @property
    def dt_pct(self) -> float:
        return 100.0 * (self.time_new_s / max(self.time_rec_s, 1e-12)
                        - 1.0)


@dataclass
class ReplayReport:
    """Fleet + per-job deltas of one counterfactual replay.

    Savings compare the replayed energy against ``energy_base_j``, the
    model's nominal-frequency run of the same inferred steps (see
    :class:`ReplayJobRow` for why, and ``model_bias_pct`` for how far that
    baseline sits from the recorded energy). ``recorded`` is the power-band
    modal split of the trace as measured (classified against the
    *recording* chip's envelope); ``replayed`` is the structural modal
    split of the counterfactual run with its actual model energies.
    ``projection`` (when response ``tables`` were passed) is the
    complementary estimate: the recorded energy split pushed through the
    target chip's Table III-style cap response columns. ``device`` is
    where the replay ran and where :meth:`project` evaluates.
    """
    policy: str
    chip: str
    record_chip: str
    n_samples: int
    energy_rec_j: float
    energy_base_j: float
    energy_new_j: float
    time_rec_s: float
    time_new_s: float
    jobs: List[ReplayJobRow]
    recorded: ModalDecomposition
    replayed: ModalDecomposition
    projection: Optional[List[ProjectionRow]] = None
    # the evaluation chip's full spec (``chip`` is just its name): what
    # tables="auto" in :meth:`project` resolves against
    chip_spec: Optional[ChipSpec] = None
    device: Optional[str] = None

    @property
    def savings_pct(self) -> float:
        if self.energy_base_j <= 0.0:            # empty stream: no deltas
            return 0.0
        return 100.0 * (1.0 - self.energy_new_j / self.energy_base_j)

    @property
    def dt_pct(self) -> float:
        if self.time_rec_s <= 0.0:
            return 0.0
        return 100.0 * (self.time_new_s / self.time_rec_s - 1.0)

    @property
    def model_bias_pct(self) -> float:
        """How far the model's nominal baseline sits from the recorded
        energy — the honest error bar of a cross-envelope replay (0 for a
        trace the power model represents exactly)."""
        if self.energy_rec_j <= 0.0:
            return 0.0
        return 100.0 * (self.energy_base_j / self.energy_rec_j - 1.0)

    def by_job(self) -> Dict[str, ReplayJobRow]:
        return {r.job_id: r for r in self.jobs}

    def project(self, caps: Optional[Sequence[float]] = None,
                kind: str = "freq", tables=None,
                objective: str = "energy") -> List[ProjectionRow]:
        """Cap-schedule projection of the *recorded* trace (another
        scenario axis on the same replayed stream — no re-ingestion).
        ``tables`` accepts any :data:`repro_torch.power.scenarios.
        TablesLike`; this is what a Study replay cell with a ``cap``
        attaches. ``objective`` annotates each row with its
        metric-equivalent savings % (``objective_pct``)."""
        from repro_torch.power.jobs import default_caps
        from repro_torch.power.scenarios import resolve_tables
        tables = resolve_tables(tables, kind=kind, chip=self.chip_spec,
                                device=self.device)
        caps = list(caps) if caps is not None else list(
            default_caps(kind, tables))
        return project_from_decomposition(
            self.recorded, caps, kind, tables=tables, objective=objective,
            device=as_device(self.device))

    def __str__(self) -> str:
        lines = [
            f"replay[{self.policy} @ {self.chip}] of {self.n_samples} "
            f"samples recorded on {self.record_chip} "
            f"(model bias {self.model_bias_pct:+.2f}%):",
            f"  fleet: {self.energy_base_j / 3.6e6:9.3f} kWh -> "
            f"{self.energy_new_j / 3.6e6:9.3f} kWh "
            f"({self.savings_pct:+.2f}% saved, dT {self.dt_pct:+.2f}%)",
        ]
        for r in self.jobs[:8]:
            lines.append(
                f"  {r.job_id:14s} {r.energy_base_j / 3.6e6:9.3f} -> "
                f"{r.energy_new_j / 3.6e6:9.3f} kWh "
                f"({r.savings_pct:+.2f}%, dT {r.dt_pct:+.2f}%)")
        if len(self.jobs) > 8:
            lines.append(f"  ... {len(self.jobs) - 8} more jobs")
        return "\n".join(lines)


#: rows a run is cut into before it is summed: no device thread of a
#: segmented sum walks more rows than this, however long the run
_PIECE = 4096


def _run_sums(cols: torch.Tensor, lengths: np.ndarray) -> np.ndarray:
    """Column sums of consecutive row runs of ``cols`` (run lengths on the
    host), in one fixed order on every device: the runs are cut at the
    shard's :data:`_PIECE`-row boundaries, one ``segment_reduce`` sums the
    pieces and a second sums each run's pieces. A segmented sum walks each
    segment in sequence, so a whole run of a million rows in one segment
    would serialise on the device; cut, no walk is longer than
    :data:`_PIECE` rows, and the launches do not grow with the runs."""
    n = cols.shape[0]
    ends = np.cumsum(lengths)
    starts = ends - lengths
    cuts = np.union1d(np.concatenate([starts, [n]]),
                      np.arange(0, n, _PIECE))
    run_of_piece = np.searchsorted(starts, cuts[:-1], side="right") - 1
    dev = cols.device
    pieces = torch.segment_reduce(
        cols, "sum", lengths=torch.from_numpy(np.diff(cuts)).to(dev),
        axis=0)
    per_run = np.bincount(run_of_piece, minlength=lengths.size)
    return torch.segment_reduce(
        pieces, "sum", lengths=torch.from_numpy(per_run).to(dev),
        axis=0).cpu().numpy()


def _job_sums(jids: np.ndarray, cols: torch.Tensor
              ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Per-job column sums of one shard: ``(job ids in first-seen order,
    (jobs, cols) sums, samples per job)``. Job-contiguous shards (every
    stream source emits them) reduce per run; a job that re-appears
    mid-shard is grouped by a stable sort first. Either way
    :func:`_run_sums` over the ``(n, cols)`` matrix."""
    if jids.strides == (0,):                 # one id broadcast: one run
        return [str(jids[0])], _run_sums(cols, np.array([jids.size])), \
            np.array([jids.size])
    starts = np.flatnonzero(np.concatenate(([True], jids[1:] != jids[:-1])))
    run_ids = [str(j) for j in jids[starts]]
    if len(set(run_ids)) == starts.size:
        lengths = np.diff(np.append(starts, jids.size))
        data = cols
    else:
        uniq, first, inv = np.unique(jids, return_index=True,
                                     return_inverse=True)
        rank = np.empty(uniq.size, dtype=np.int64)
        rank[np.argsort(first)] = np.arange(uniq.size)
        key = rank[inv.reshape(-1)]
        order = np.argsort(key, kind="stable")
        lengths = np.bincount(key, minlength=uniq.size)
        run_ids = [str(uniq[k]) for k in np.argsort(first)]
        data = cols[torch.from_numpy(order).to(cols.device)]
    return run_ids, _run_sums(data, lengths), lengths


def replay(stream: Iterable[ShardLike], policy: PolicyLike,
           chip=MI250X_GCD, *, record_chip=None,
           tables: Optional[ResponseTables] = None,
           caps: Optional[Sequence[float]] = None, kind: str = "freq",
           sample_interval_s: float = 15.0, executor=None,
           objective: Optional[str] = None, **policy_knobs
           ) -> ReplayReport:
    """Re-run a recorded telemetry stream under ``policy`` on ``chip`` —
    the single-cell view of a replay :class:`repro_torch.power.Scenario`.

    Per chunk (never per sample), on the chunk's device: classify/accept
    the recorded modes, invert the recording chip's power model into
    roofline profiles (:meth:`TransferSurface.infer_profiles`), and
    evaluate the policy with ONE batched ``decide_batch`` call; per-job and
    fleet recorded-vs-replayed energy/runtime accumulate on the host with
    O(chunk) memory (one copy of the chunk's sums a chunk). ``record_chip``
    defaults to ``chip`` (same-chip what-if); pass the chip the trace was
    measured on for cross-chip replays. The sums are the device's, in
    another order than numpy's: energies and times agree with the reference
    to rtol 1e-12, job rows and counts exactly.

    ``objective``: swap the swept metric of a name-resolved policy —
    shorthand for the ``objective=`` policy knob; policy *objects* are
    never mutated (their own ``objective`` wins, and a conflicting request
    raises).

    ``tables`` / ``caps`` / ``kind`` (deprecated): attach the response-
    table projection of the recorded trace to the report. Call
    :meth:`ReplayReport.project` — or give the Scenario a ``cap`` — for
    the same rows without re-ingesting.

    ``executor``: a :class:`repro_torch.parallel.ShardedExecutor` runs each
    shard's infer + decide pass (deduplicated, memoized across shards,
    split over its devices) and the recorded fold's segment sums. The
    results come back to the shard's device before the sums, so the report
    is the plain path's, bit for bit, when the executor's device is the
    shards'. Policies the executor does not support
    (:meth:`~repro_torch.parallel.ShardedExecutor.supports`) take the plain
    path.
    """
    model = ChipModel(chip)
    rec_model = ChipModel(record_chip) if record_chip is not None else model
    if objective is not None:
        from repro_torch.power.objectives import check_objective
        objective = check_objective(objective)
        if policy is None or isinstance(policy, str):
            policy_knobs.setdefault("objective", objective)
        elif getattr(policy, "objective", objective) != objective:
            raise ValueError(
                f"policy object {getattr(policy, 'name', policy)!r} has "
                f"objective={policy.objective!r}; pass objective= only "
                f"with name-resolved policies or matching objects")
    pol = get_policy(policy, **policy_knobs)
    exec_decides = executor is not None and executor.supports(pol)
    rec_acc = StreamingModal(rec_model.spec, sample_interval_s,
                             track_jobs=False, executor=executor)

    e_rec = e_base = e_new = t_rec = t_new = 0.0
    n = 0
    mode_e = np.zeros(_N_MODES)
    mode_t = np.zeros(_N_MODES)
    per_job: Dict[str, np.ndarray] = {}
    job_n: Dict[str, int] = {}
    device = None

    for shard in stream:
        sh = SampleShard.coerce(shard, sample_interval_s)
        if len(sh) == 0:
            continue
        dev = sh.device
        device = str(dev)
        f = 1.0 if sh.freq_mhz is None else torch.clamp(
            sh.freq_mhz / rec_model.spec.f_nominal_mhz,
            rec_model.f_min_frac, 1.0)
        if exec_decides:
            # mode=None lets the executor classify its unique values; the
            # modes come back for the recorded fold, classified once
            *dec, cmodes = executor.decide_shard(
                pol, model, rec_model, sh.power_w, sh.mode, sh.duration_s,
                f, modes_from_power=sh.mode is None, return_modes=True)
            be, bb, bt, bm = (x.to(dev) for x in dec)
            rec_acc.fold(sh.power_w, sh.job_id,
                         modes=cmodes.to(dev) if sh.mode is None else None)
        else:
            classified = classify_power(sh.power_w, rec_model.spec)
            rec_acc.fold(sh.power_w, sh.job_id, modes=classified)
            modes = sh.mode if sh.mode is not None else classified
            profiles = rec_model.surface(dev).infer_profiles(
                sh.power_w, freq_frac=f, duration_s=sh.duration_s,
                mode_idx=modes)
            bd = decide_batch(pol, profiles, model, device=dev)
            be, bb, bt, bm = (bd.energy_j, bd.baseline_energy_j, bd.time_s,
                              bd.mode_idx)
        onehot = torch.stack([bm == idx for idx in _MODE_IDXS]
                             ).to(torch.float64)
        cols = torch.stack([sh.energy_j, bb, be, sh.duration_s, bt], dim=1)
        # every fleet-level sum of the shard in one copy to the host
        tot = torch.cat([cols.sum(dim=0), onehot @ be, onehot @ bt]
                        ).cpu().numpy()
        e_rec += float(tot[0])
        e_base += float(tot[1])
        e_new += float(tot[2])
        t_rec += float(tot[3])
        t_new += float(tot[4])
        n += len(sh)
        mode_e += tot[5:5 + _N_MODES]
        mode_t += tot[5 + _N_MODES:]
        ids, sums, lengths = _job_sums(sh.job_id, cols)
        for jid, row, k in zip(ids, sums, lengths):
            acc = per_job.setdefault(jid, np.zeros(5))
            acc += row
            job_n[jid] = job_n.get(jid, 0) + int(k)

    replayed = ModalDecomposition(
        hours_pct={m.idx: float(100.0 * mode_t[i] / max(t_new, 1e-12))
                   for i, m in enumerate(MODES)},
        energy_mwh={m.idx: float(mode_e[i] / 3.6e9)
                    for i, m in enumerate(MODES)},
        total_energy_mwh=e_new / 3.6e9,
        sample_interval_s=sample_interval_s)
    report = ReplayReport(
        policy=pol.name, chip=model.spec.name, chip_spec=model.spec,
        record_chip=rec_model.spec.name, n_samples=n,
        energy_rec_j=e_rec, energy_base_j=e_base, energy_new_j=e_new,
        time_rec_s=t_rec, time_new_s=t_new,
        jobs=[ReplayJobRow(jid, job_n[jid], *map(float, row))
              for jid, row in per_job.items()],
        recorded=rec_acc.decomposition(), replayed=replayed, device=device)
    if tables is not None or caps is not None:
        warnings.warn(
            "repro_torch.power.stream.replay's tables=/caps=/kind= "
            "projection attachment is deprecated; call "
            "ReplayReport.project(caps, kind, tables) on the result, or "
            "give the repro_torch.power.Scenario replay cell a cap",
            DeprecationWarning, stacklevel=2)
        report.projection = report.project(caps, kind, tables)
    return report
