"""Telemetry subsystem — the framework's analogue of Frontier's out-of-band
power channel (paper §III-A).

Per-step samples are aggregated into fixed windows (the paper's 2 s -> 15 s
pre-aggregation) so memory stays bounded at fleet scale; a job log carries
the scheduler metadata (job id, science domain, node count) that the paper
joins against for domain-level analysis. A copy of the reference's store,
log and ``.npz`` spill format (host Python and numpy, like the reference):
a spill written by either package loads in the other.
"""
from __future__ import annotations

import collections
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class StepSample:
    step: int
    t: float                 # seconds (monotonic within a job)
    duration_s: float
    power_w: float
    energy_j: float
    mode: int                # paper mode index 1..4
    freq_mhz: int
    job_id: str = "job0"


@dataclass
class WindowAggregate:
    t_start: float
    t_end: float
    mean_power_w: float
    energy_j: float
    samples: int
    mode_hist: Dict[int, int] = field(default_factory=dict)
    job_id: str = "job0"


@dataclass
class JobRecord:
    """Scheduler-log metadata (paper Table II (b))."""
    job_id: str
    project_id: str          # prefix = science domain
    num_nodes: int
    begin_time: float
    end_time: float = 0.0

    @property
    def science_domain(self) -> str:
        return self.project_id.split("_")[0]

    def size_class(self) -> str:
        from repro_torch.core.hardware import JOB_SIZE_CLASSES
        for name, (lo, hi, _) in JOB_SIZE_CLASSES.items():
            if lo <= self.num_nodes <= hi:
                return name
        return "E"


class TelemetryStore:
    """Bounded-memory store: raw samples of the current window + rolling
    aggregated windows."""

    def __init__(self, window_s: float = 15.0, max_windows: int = 100_000):
        self.window_s = window_s
        self._pending: List[StepSample] = []
        self.windows: Deque[WindowAggregate] = collections.deque(
            maxlen=max_windows)
        self._window_start: Optional[float] = None

    def record(self, s: StepSample) -> None:
        if self._window_start is None:
            self._window_start = s.t
        # close the window on time, and on job change so every aggregate
        # carries exactly one job id
        if self._pending and (s.t - self._window_start >= self.window_s
                              or s.job_id != self._pending[-1].job_id):
            self.flush()
            self._window_start = s.t
        self._pending.append(s)

    def flush(self) -> None:
        # always clear the window clock, so the next record() opens a fresh
        # window instead of measuring against a flushed one's start
        self._window_start = None
        if not self._pending:
            return
        ps = self._pending
        hist: Dict[int, int] = {}
        for s in ps:
            hist[s.mode] = hist.get(s.mode, 0) + 1
        dur = sum(s.duration_s for s in ps)
        energy = sum(s.energy_j for s in ps)
        self.windows.append(WindowAggregate(
            t_start=ps[0].t, t_end=ps[-1].t + ps[-1].duration_s,
            mean_power_w=energy / max(dur, 1e-9),
            energy_j=energy, samples=len(ps), mode_hist=hist,
            job_id=ps[0].job_id))
        self._pending = []

    # ---------------------------------------------------------- analysis
    def powers(self) -> np.ndarray:
        self.flush()
        return np.array([w.mean_power_w for w in self.windows])

    def job_ids(self) -> List[str]:
        """Distinct job ids, in first-seen order."""
        self.flush()
        seen: Dict[str, None] = {}
        for w in self.windows:
            seen.setdefault(w.job_id)
        return list(seen)

    def powers_by_job(self) -> Dict[str, np.ndarray]:
        """Windowed mean powers per job id, first-seen order."""
        self.flush()
        out: Dict[str, List[float]] = {}
        for w in self.windows:
            out.setdefault(w.job_id, []).append(w.mean_power_w)
        return {j: np.array(p) for j, p in out.items()}

    def total_energy_j(self) -> float:
        self.flush()
        return float(sum(w.energy_j for w in self.windows))

    def mode_hours_pct(self) -> Dict[int, float]:
        self.flush()
        tot: Dict[int, int] = {}
        for w in self.windows:
            for m, c in w.mode_hist.items():
                tot[m] = tot.get(m, 0) + c
        n = max(sum(tot.values()), 1)
        return {m: 100.0 * c / n for m, c in sorted(tot.items())}

    # ------------------------------------------------------- persistence
    def to_json(self) -> str:
        self.flush()
        return json.dumps([asdict(w) for w in self.windows])

    @classmethod
    def from_json(cls, text: str, window_s: float = 15.0) -> "TelemetryStore":
        st = cls(window_s=window_s)
        for d in json.loads(text):
            d["mode_hist"] = {int(k): v for k, v in d["mode_hist"].items()}
            st.windows.append(WindowAggregate(**d))
        return st

    def spill_npz(self, path: str) -> int:
        """Flush, write every aggregated window to a compressed ``.npz``
        spill file, and drop the windows from memory — the out-of-core
        hand-off consumed by :func:`repro_torch.power.stream.iter_npz`.
        Month-scale runs spill periodically instead of letting the bounded
        deque silently evict old windows. Returns the number of windows
        written.

        Spill format (``schema`` 1), columnar over ``W`` windows:

        * ``schema`` (int), ``window_s`` (float) — format tag + the store's
          aggregation window;
        * ``t_start``, ``t_end``, ``mean_power_w``, ``energy_j`` —
          ``(W,)`` float64;
        * ``samples`` — ``(W,)`` int64 raw-sample counts;
        * ``job_id`` — ``(W,)`` unicode;
        * ``mode_window`` / ``mode_idx`` / ``mode_count`` — the sparse
          mode histograms as aligned int64 triples (window row, paper mode
          index 1..4, sample count).
        """
        self.flush()
        ws = list(self.windows)
        trip = [(i, m, c) for i, w in enumerate(ws)
                for m, c in sorted(w.mode_hist.items())]
        tw, tm, tc = (np.array([t[k] for t in trip], dtype=np.int64)
                      for k in range(3)) if trip else \
            (np.empty(0, np.int64),) * 3
        np.savez_compressed(
            path, schema=np.int64(1), window_s=np.float64(self.window_s),
            t_start=np.array([w.t_start for w in ws], dtype=np.float64),
            t_end=np.array([w.t_end for w in ws], dtype=np.float64),
            mean_power_w=np.array([w.mean_power_w for w in ws],
                                  dtype=np.float64),
            energy_j=np.array([w.energy_j for w in ws], dtype=np.float64),
            samples=np.array([w.samples for w in ws], dtype=np.int64),
            job_id=np.array([w.job_id for w in ws], dtype=np.str_),
            mode_window=tw, mode_idx=tm, mode_count=tc)
        self.windows.clear()
        return len(ws)

    @classmethod
    def from_npz(cls, path: str, window_s: Optional[float] = None
                 ) -> "TelemetryStore":
        """Rehydrate a store from one :meth:`spill_npz` file."""
        windows, spilled_window_s = load_spill(path)
        st = cls(window_s=window_s if window_s is not None
                 else spilled_window_s)
        st.windows.extend(windows)
        return st


def load_spill(path: str) -> Tuple[List[WindowAggregate], float]:
    """Read one :meth:`TelemetryStore.spill_npz` file back into
    ``(windows, window_s)`` — the low-level reader behind
    :meth:`TelemetryStore.from_npz` and
    ``repro_torch.power.stream.iter_npz``."""
    with np.load(path) as z:
        schema = int(z["schema"])
        if schema != 1:
            raise ValueError(f"unknown telemetry spill schema {schema} "
                             f"in {path!r} (supported: 1)")
        # materialize each column ONCE: every NpzFile[key] access
        # decompresses the whole member again, so indexing z[...] inside
        # the window loop would be O(windows^2)
        t_start, t_end = z["t_start"], z["t_end"]
        mean_p, energy = z["mean_power_w"], z["energy_j"]
        samples, job_id = z["samples"], z["job_id"]
        hists: List[Dict[int, int]] = [dict() for _ in range(
            t_start.shape[0])]
        for w, m, c in zip(z["mode_window"], z["mode_idx"],
                           z["mode_count"]):
            hists[int(w)][int(m)] = int(c)
        windows = [WindowAggregate(
            t_start=float(t_start[i]), t_end=float(t_end[i]),
            mean_power_w=float(mean_p[i]), energy_j=float(energy[i]),
            samples=int(samples[i]), mode_hist=hists[i],
            job_id=str(job_id[i]))
            for i in range(t_start.shape[0])]
        return windows, float(z["window_s"])


class JobLog:
    def __init__(self) -> None:
        self.jobs: Dict[str, JobRecord] = {}

    def start(self, job: JobRecord) -> None:
        self.jobs[job.job_id] = job

    def end(self, job_id: str, t: Optional[float] = None) -> None:
        if job_id in self.jobs:
            self.jobs[job_id].end_time = t if t is not None else time.time()

    def by_domain(self) -> Dict[str, List[JobRecord]]:
        out: Dict[str, List[JobRecord]] = {}
        for j in self.jobs.values():
            out.setdefault(j.science_domain, []).append(j)
        return out
