"""Telemetry subsystem — the framework's analogue of Frontier's out-of-band
power channel (paper §III-A).

Per-step samples are aggregated into fixed windows (the paper's 2 s -> 15 s
pre-aggregation) so memory stays bounded at fleet scale; a job log carries
the scheduler metadata (job id, science domain, node count) that the paper
joins against for domain-level analysis. A copy of the reference's store and
log (host Python and numpy, like the reference); the spill to ``.npz`` files
arrives with ``power.stream`` (ROADMAP queue A item 2).
"""
from __future__ import annotations

import collections
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Deque, Dict, List, Optional

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
