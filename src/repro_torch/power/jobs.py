"""Job-level fleet simulation and projection (paper §V at job granularity).

The paper's headline numbers are *per job*: 8.5% savings for
resource-constrained (compute-intensive) jobs, dT=0 for memory-intensive
ones, 1438 MWh fleet-wide. This module supplies the job-granular layer the
flat fleet pipeline lacks:

* :class:`JobTrace` / :class:`JobTable` — per-job power traces held as one
  right-padded ``(jobs, samples)`` float64 tensor plus a validity mask on
  ``device``, built from a synthetic multi-job workload (job mixes sampled
  from the model configs in :mod:`repro_torch.configs`, power rendered
  through the chip's :class:`~repro_torch.power.surface.TransferSurface`)
  or ingested from a job-tagged :class:`TelemetryStore`;
* :func:`classify_jobs` — per-job class assignment (latency-bound /
  memory-intensive / compute-intensive, Table IV semantics) from the batched
  modal decomposition;
* :func:`class_cap_report` — the per-class cap schedule: latency-bound jobs
  stay uncapped (the paper finds no opportunity there), memory-intensive
  jobs take the savings-maximizing cap among those that keep dT=0 (no
  performance compromise), compute-intensive jobs take the unconstrained
  savings-maximizing cap; aggregated into a :class:`FleetJobsReport`.

The analysis itself is :func:`repro_torch.core.modal.decompose_batch` +
:func:`repro_torch.core.projection.project_batch` — tensor programs over the
whole job population on the table's device, exposed through
``FleetAnalysis.from_jobs(...)``.

The synthetic generator draws on the host from ``np.random.default_rng``,
one job at a time, in the reference's order. The paper's headline leg
(``validate_main``) pins a bootstrap interval around 8.5 % on one such
sample; drawing from another generator would hold a different sample to
that pin, and about one seed in twelve misses it with no fault in the code.
Keeping numpy's draw sequence makes the whole leg comparable number for
number. The padded matrix is built once on the host and copied to the
device in one transfer.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device
from repro_torch.core.hardware import ChipSpec, JOB_SIZE_CLASSES, MI250X_GCD
from repro_torch.core.modal import BatchModalDecomposition, decompose_batch
from repro_torch.core.power_model import StepProfile
from repro_torch.core.projection import (BatchProjection,
                                         DT_WEIGHT_PER_CI_HOUR,
                                         ResponseTables, project_batch)
from repro_torch.core.telemetry import JobRecord, TelemetryStore

# Job classes, keyed by the Table IV mode whose energy dominates the job.
LATENCY_BOUND = "latency-bound"
MEMORY_INTENSIVE = "memory-intensive"
COMPUTE_INTENSIVE = "compute-intensive"
JOB_CLASSES: Tuple[str, ...] = (LATENCY_BOUND, MEMORY_INTENSIVE,
                                COMPUTE_INTENSIVE)
# mode idx 1..4 -> class index into JOB_CLASSES (boost counts as C.I.)
_MODE_TO_CLASS = (0, 0, 1, 2, 2)

# Synthetic workload calibration: class mix follows the fleet's Table IV
# hours split (boost hours fold into C.I. jobs); per-class main-phase power
# targets sit on the paper's Fig. 8/9 histogram peaks.
CLASS_MIX: Dict[str, float] = {LATENCY_BOUND: 0.30, MEMORY_INTENSIVE: 0.50,
                               COMPUTE_INTENSIVE: 0.20}
#: the class mix of validate_main's bootstrap leg: the fleet's Table IV
#: energy split
HEADLINE_CLASS_MIX: Dict[str, float] = {
    LATENCY_BOUND: 0.36, MEMORY_INTENSIVE: 0.43, COMPUTE_INTENSIVE: 0.21}
_MAIN_POWER_W = {LATENCY_BOUND: (128.0, 24.0), MEMORY_INTENSIVE: (305.0, 48.0),
                 COMPUTE_INTENSIVE: (545.0, 36.0)}
_SETUP_POWER_W = (112.0, 10.0)          # startup / teardown / io phases
_SAMPLE_NOISE_W = 9.0                   # per-sample measurement jitter
# size-class sampling weights (small jobs dominate Frontier's job count)
_SIZE_CLASS_P = {"A": 0.02, "B": 0.05, "C": 0.18, "D": 0.20, "E": 0.55}


def _host(powers) -> np.ndarray:
    """One trace's samples as a float64 numpy array (a tensor is copied
    off its device)."""
    if isinstance(powers, torch.Tensor):
        return powers.detach().to("cpu", torch.float64).numpy()
    return np.asarray(powers, dtype=np.float64)


@dataclass
class JobTrace:
    """One job's power trace plus the scheduler metadata the paper joins
    against (arch/nodes/arrival come from the synthetic sampler or the
    ingested job log). ``powers`` is a numpy array or a tensor."""
    job_id: str
    powers: object                       # (n_samples,) mean W per interval
    sample_interval_s: float = 15.0
    arch: str = ""                       # model config the job ran (if known)
    num_nodes: int = 1
    begin_time: float = 0.0
    intent_class: str = ""               # generator's intended class ("" = ?)

    @property
    def n_samples(self) -> int:
        if isinstance(self.powers, torch.Tensor):
            return int(self.powers.numel())
        return int(np.size(self.powers))

    @property
    def duration_s(self) -> float:
        return float(self.n_samples) * self.sample_interval_s

    @property
    def arrival_s(self) -> float:
        """Submission time (s since trace start) — scheduler-facing alias
        of ``begin_time``."""
        return float(self.begin_time)

    @property
    def walltime_s(self) -> float:
        """Requested/observed walltime (s) — the nominal (uncapped) run
        length; equals ``duration_s`` for recorded traces."""
        return self.duration_s

    @property
    def energy_mwh(self) -> float:
        return float(np.sum(_host(self.powers))) * self.sample_interval_s \
            / 3600.0 / 1e6

    def record(self) -> JobRecord:
        dom = self.arch.split("-")[0] if self.arch else "unknown"
        return JobRecord(job_id=self.job_id,
                         project_id=f"{dom}_{self.arch or 'job'}",
                         num_nodes=self.num_nodes,
                         begin_time=self.begin_time,
                         end_time=self.begin_time + self.duration_s)


class JobTable:
    """Columnar view of many job traces: one right-padded ``(jobs, samples)``
    float64 tensor + bool validity mask on ``device``, the unit the tensor
    analysis core consumes. Rows keep trace order; ``job_ids`` maps rows
    back to jobs. ``lengths``, ``arrival_s``, ``walltime_s`` and ``nodes``
    are ``(jobs,)`` tensors on the same device."""

    def __init__(self, traces: Sequence[JobTrace],
                 chip: ChipSpec = MI250X_GCD,
                 sample_interval_s: Optional[float] = None,
                 device=DEFAULT_DEVICE):
        if not traces:
            raise ValueError("JobTable needs at least one trace")
        self.traces: List[JobTrace] = list(traces)
        self.chip = chip
        self.device = as_device(device)
        self.sample_interval_s = (sample_interval_s if sample_interval_s
                                  is not None
                                  else self.traces[0].sample_interval_s)
        bad = {t.sample_interval_s for t in self.traces
               if t.sample_interval_s != self.sample_interval_s}
        if bad:
            raise ValueError(
                f"trace sample intervals {sorted(bad)} differ from the "
                f"table's {self.sample_interval_s}s; resample first — a "
                f"shared interval is what makes (jobs, samples) one matrix")
        rows = [_host(t.powers).reshape(-1) for t in self.traces]
        lens = np.array([r.size for r in rows], dtype=np.int64)
        host = np.zeros((len(rows), int(lens.max())), dtype=np.float64)
        for j, r in enumerate(rows):
            host[j, :r.size] = r
        dev = self.device
        self.powers = torch.from_numpy(host).to(dev)
        self.lengths = torch.from_numpy(lens).to(dev)
        self.mask = torch.arange(host.shape[1], device=dev)[None, :] \
            < self.lengths[:, None]
        # scheduler-facing columns
        self.arrival_s = torch.tensor([t.arrival_s for t in self.traces],
                                      dtype=torch.float64, device=dev)
        self.walltime_s = self.lengths.to(torch.float64) \
            * self.sample_interval_s
        self.nodes = torch.tensor([max(int(t.num_nodes), 1)
                                   for t in self.traces],
                                  dtype=torch.int64, device=dev)

    def __len__(self) -> int:
        return len(self.traces)

    @property
    def job_ids(self) -> List[str]:
        return [t.job_id for t in self.traces]

    def concat_powers(self) -> torch.Tensor:
        """All valid samples as one flat fleet tensor (padding excluded),
        row after row."""
        return self.powers[self.mask]

    def records(self) -> List[JobRecord]:
        return [t.record() for t in self.traces]

    def decompose(self) -> BatchModalDecomposition:
        return decompose_batch(self.powers, self.sample_interval_s,
                               self.chip, mask=self.mask)

    def to_stream(self, samples_per_shard: int = 65536):
        """This table as a job-ordered telemetry stream on its device — the
        hand-off to the out-of-core pipeline
        (:func:`repro_torch.power.stream.iter_jobs`)."""
        from repro_torch.power.stream import iter_jobs
        return iter_jobs(self, samples_per_shard)

    # ----------------------------------------------------------- ingestion
    @classmethod
    def from_store(cls, store: TelemetryStore,
                   chip: ChipSpec = MI250X_GCD,
                   sample_interval_s: Optional[float] = None,
                   device=DEFAULT_DEVICE) -> "JobTable":
        """Per-job slices of a job-tagged telemetry store (window job ids
        are kept exact because the store flushes on job change)."""
        interval = sample_interval_s if sample_interval_s is not None \
            else store.window_s
        traces = [JobTrace(job_id=jid, powers=p, sample_interval_s=interval)
                  for jid, p in store.powers_by_job().items()]
        return cls(traces, chip=chip, sample_interval_s=interval,
                   device=device)

    # ----------------------------------------------------------- synthesis
    @classmethod
    def synthetic(cls, n_jobs: int, seed: int = 0,
                  chip: ChipSpec = MI250X_GCD,
                  sample_interval_s: float = 15.0,
                  class_mix: Optional[Dict[str, float]] = None,
                  mean_samples: int = 120, max_samples: int = 360,
                  arrival_gap_s: float = 300.0,
                  walltime_sigma: float = 0.6,
                  device=DEFAULT_DEVICE) -> "JobTable":
        """Synthetic multi-job workload (see :func:`synth_job_traces`),
        drawn on the host and placed on ``device``."""
        return cls(synth_job_traces(
            n_jobs, seed=seed, chip=chip,
            sample_interval_s=sample_interval_s, class_mix=class_mix,
            mean_samples=mean_samples, max_samples=max_samples,
            arrival_gap_s=arrival_gap_s, walltime_sigma=walltime_sigma),
            chip=chip, sample_interval_s=sample_interval_s, device=device)


# ---------------------------------------------------------------------------
# Synthetic workload generator
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _class_profiles(chip: ChipSpec) -> Dict[str, List[Tuple[str,
                                                            StepProfile]]]:
    """Roofline position of each model config's main phase, per job class:
    compute-intensive jobs run training steps, memory-intensive jobs run
    batched decode (weights + KV traffic per token), latency-bound jobs are
    collective/input-starved. Cached per chip — config shape tables only."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES_BY_NAME
    train, decode = SHAPES_BY_NAME["train_4k"], SHAPES_BY_NAME["decode_32k"]
    out: Dict[str, List[Tuple[str, StepProfile]]] = {c: [] for c in
                                                     JOB_CLASSES}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        n_active = float(cfg.param_count(active_only=True))
        n_layers = float(cfg.n_layers)

        tokens = float(train.seq_len * train.global_batch)
        train_flops = 6.0 * n_active * tokens
        # pipelined tile prefetch keeps HBM busy during the compute phase;
        # the per-code overlap efficiency is fixed per arch in [0.35, 0.85]
        overlap = 0.35 + 0.5 * (zlib.crc32(arch.encode()) % 1000) / 999.0
        compute_s = train_flops / chip.peak_flops
        out[COMPUTE_INTENSIVE].append((arch, StepProfile(
            compute_s=compute_s, memory_s=overlap * compute_s)))

        # decode: whole model read per token + per-sequence state/KV reads
        kv_row = max(cfg.n_kv_heads * cfg.resolved_head_dim,
                     cfg.ssm_state * max(cfg.ssm_n_groups, 1), 1.0)
        seq = 1.0 if cfg.family in ("ssm",) else float(decode.seq_len)
        dec_bytes = (2.0 * n_active
                     + 2.0 * n_layers * kv_row * seq * 2.0
                     * decode.global_batch)
        dec_flops = 2.0 * n_active * decode.global_batch
        dec = StepProfile(compute_s=dec_flops / chip.peak_flops,
                          memory_s=dec_bytes / chip.hbm_bw)
        out[MEMORY_INTENSIVE].append((arch, dec))

        # latency/io-bound: the same decode step, stalled on collectives
        out[LATENCY_BOUND].append((arch, StepProfile(
            compute_s=dec.compute_s, memory_s=dec.memory_s,
            collective_s=4.0 * dec.total_s)))
    return out


@lru_cache(maxsize=None)
def _class_power_ceilings(chip: ChipSpec) -> Dict[Tuple[str, str], float]:
    """Nominal-frequency model power of every (class, arch) main-phase
    profile — one batched :class:`~repro_torch.power.surface.TransferSurface`
    pass on the host, where the generator that reads it runs."""
    # function-level import: power.surface is a sibling submodule, importing
    # it at module scope would cycle through the package __init__
    from repro_torch.power.surface import ProfileArray, TransferSurface
    keys, profs = [], []
    for job_class, pairs in _class_profiles(chip).items():
        for arch, prof in pairs:
            keys.append((job_class, arch))
            profs.append(prof)
    powers = TransferSurface(chip, device="cpu").power_w(
        ProfileArray.from_profiles(profs, device="cpu"), 1.0)
    return {k: p for k, p in zip(keys, powers.tolist())}


def _render_phase(rng: np.random.Generator, spec: ChipSpec,
                  p_model: float, n: int, target_w: float) -> np.ndarray:
    """``n`` power samples of one phase: ``p_model`` (the chip model's
    roofline power for the phase's profile) is the ceiling; a duty-cycle
    blend toward idle hits the observed band target, and per-sample jitter
    stands in for the 15 s aggregation of a noisy signal."""
    duty = np.clip((target_w - spec.idle_w)
                   / max(p_model - spec.idle_w, 1e-9), 0.02, 1.0)
    base = spec.idle_w + duty * (p_model - spec.idle_w)
    x = base + rng.normal(0.0, _SAMPLE_NOISE_W, size=n)
    return np.clip(x, spec.idle_w * 0.98, spec.tdp_w * 1.1)


def synth_job_traces(n_jobs: int, seed: int = 0,
                     chip: ChipSpec = MI250X_GCD,
                     sample_interval_s: float = 15.0,
                     class_mix: Optional[Dict[str, float]] = None,
                     mean_samples: int = 120, max_samples: int = 360,
                     arrival_gap_s: float = 300.0,
                     walltime_sigma: float = 0.6) -> List[JobTrace]:
    """``n_jobs`` synthetic job traces: each job samples a model config from
    :mod:`repro_torch.configs`, a node count from the paper's job-size
    classes and a duration/arrival time, then renders its power trace
    through the chip model (the config's roofline position bounds the
    achievable power; duty cycle fills the gap down to the fleet's observed
    per-mode power bands). Arrivals are Poisson (``arrival_gap_s`` mean
    inter-arrival), walltimes lognormal with shape ``walltime_sigma``
    (clipped to ``max_samples``). Drawn on the host, job by job, from
    ``np.random.default_rng(seed)`` (see the module docstring)."""
    rng = np.random.default_rng(seed)
    mix = class_mix or CLASS_MIX
    classes = list(mix)
    p_cls = np.array([mix[c] for c in classes], dtype=np.float64)
    p_cls /= p_cls.sum()
    profiles = _class_profiles(chip)
    ceilings = _class_power_ceilings(chip)
    size_names = list(_SIZE_CLASS_P)
    p_size = np.array([_SIZE_CLASS_P[s] for s in size_names])
    p_size = p_size / p_size.sum()

    traces: List[JobTrace] = []
    t_arrival = 0.0
    for j in range(n_jobs):
        job_class = classes[rng.choice(len(classes), p=p_cls)]
        arch, _profile = profiles[job_class][
            rng.integers(len(profiles[job_class]))]
        size = size_names[rng.choice(len(size_names), p=p_size)]
        lo, hi, _ = JOB_SIZE_CLASSES[size]
        nodes = int(rng.integers(lo, hi + 1))
        n = int(np.clip(rng.lognormal(np.log(mean_samples), walltime_sigma),
                        6, max_samples))
        # phase split: startup/teardown/io bookends around the main phase
        n_setup = max(1, int(n * rng.uniform(0.08, 0.22)))
        n_main = max(1, n - n_setup)
        mu, sd = _MAIN_POWER_W[job_class]
        target = rng.normal(mu, sd)
        main = _render_phase(rng, chip, ceilings[(job_class, arch)],
                             n_main, target)
        setup = np.clip(rng.normal(*_SETUP_POWER_W, size=n_setup),
                        chip.idle_w * 0.98, 199.0)
        # periodic checkpoint/io dips inside the main phase
        if n_main >= 40:
            stride = int(rng.integers(30, 80))
            main[::stride] = np.clip(
                rng.normal(150.0, 15.0, size=main[::stride].shape),
                chip.idle_w, 199.0)
        powers = np.concatenate([setup[: n_setup // 2 + 1], main,
                                 setup[n_setup // 2 + 1:]])
        t_arrival += rng.exponential(arrival_gap_s)
        traces.append(JobTrace(
            job_id=f"job{j:05d}", powers=powers,
            sample_interval_s=sample_interval_s, arch=arch,
            num_nodes=nodes, begin_time=t_arrival,
            intent_class=job_class))
    return traces


# ---------------------------------------------------------------------------
# Job-class assignment + per-class cap schedule (Table IV semantics)
# ---------------------------------------------------------------------------
def classify_jobs(decomp: BatchModalDecomposition) -> torch.Tensor:
    """Class index (int32) into :data:`JOB_CLASSES` per job, from the mode
    holding the most of the job's energy (boost-mode energy counts as C.I.
    — those jobs are the paper's resource-constrained population)."""
    dom = decomp.dominant_mode()
    table = torch.tensor(_MODE_TO_CLASS, dtype=torch.int32, device=dom.device)
    return table[dom.long()]


def job_dt_weights(decomp: BatchModalDecomposition) -> torch.Tensor:
    """Per-job dT weight: the fleet-decoded per-C.I.-hour slope scaled by
    each job's own share of hours in the compute-intensive mode (boost hours
    included — they are clock-capped exactly like mode 3)."""
    ci_hours = decomp.hours_frac(3) + decomp.hours_frac(4)
    return DT_WEIGHT_PER_CI_HOUR * ci_hours


@dataclass
class ClassReport:
    """One job class's slice of the fleet and its chosen cap."""
    job_class: str
    n_jobs: int
    energy_mwh: float
    cap: Optional[float]                 # None = left uncapped
    savings_mwh: float
    savings_pct: float                   # of this class's energy
    dt_pct: float
    meets_dt0: bool
    best_cap_savings_pct: float          # unconstrained argmax over the grid

    def to_dict(self) -> Dict:
        return dict(job_class=self.job_class, n_jobs=self.n_jobs,
                    energy_mwh=self.energy_mwh, cap=self.cap,
                    savings_mwh=self.savings_mwh,
                    savings_pct=self.savings_pct, dt_pct=self.dt_pct,
                    meets_dt0=self.meets_dt0,
                    best_cap_savings_pct=self.best_cap_savings_pct)


@dataclass
class FleetJobsReport:
    """Aggregate savings report of the per-class cap schedule."""
    kind: str
    caps: Tuple[float, ...]
    classes: List[ClassReport]
    total_energy_mwh: float
    total_savings_mwh: float
    savings_pct: float                   # of total fleet energy
    dt0_savings_mwh: float               # savings from dT=0 classes only
    objective: str = "energy"            # metric that drove cap selection

    def by_class(self) -> Dict[str, ClassReport]:
        return {c.job_class: c for c in self.classes}

    def to_dict(self) -> Dict:
        return dict(kind=self.kind, caps=list(self.caps),
                    classes=[c.to_dict() for c in self.classes],
                    total_energy_mwh=self.total_energy_mwh,
                    total_savings_mwh=self.total_savings_mwh,
                    savings_pct=self.savings_pct,
                    dt0_savings_mwh=self.dt0_savings_mwh,
                    objective=self.objective)

    def __str__(self) -> str:
        lines = [f"class               jobs   E_MWh     cap  sav_MWh  sav%"
                 f"    dT%  dT=0"]
        for c in self.classes:
            cap = "-" if c.cap is None else f"{c.cap:.0f}"
            lines.append(
                f"{c.job_class:18s} {c.n_jobs:5d} {c.energy_mwh:7.2f} "
                f"{cap:>7s} {c.savings_mwh:8.3f} {c.savings_pct:5.2f} "
                f"{c.dt_pct:6.2f}  {'yes' if c.meets_dt0 else 'no'}")
        lines.append(f"fleet: {self.total_savings_mwh:.3f} MWh "
                     f"({self.savings_pct:.2f}%) saved; "
                     f"{self.dt0_savings_mwh:.3f} MWh at dT=0")
        return "\n".join(lines)


DEFAULT_FREQ_CAPS: Tuple[float, ...] = (1500.0, 1300.0, 1100.0, 900.0, 700.0)
DEFAULT_POWER_CAPS: Tuple[float, ...] = (500.0, 400.0, 300.0, 200.0)
# "dT=0" tolerance: the paper counts work with runtime <= 100.5% of the
# uncapped run as unaffected (RUNTIME_UNAFFECTED_PCT), i.e. up to 0.5%
# projected slowdown still qualifies as no performance compromise.
DT0_TOL_PCT = 0.5


def default_caps(kind: str = "freq",
                 tables: Optional[ResponseTables] = None
                 ) -> Tuple[float, ...]:
    """The cap grid to sweep: with model-derived ``tables`` the grid is the
    tables' own keys below the uncapped baseline (they may describe a chip
    with a very different envelope); otherwise the paper's MI250X grids."""
    if tables is not None:
        keys = set(tables.vai) | set(tables.mb)
        top = max(keys)
        caps = tuple(sorted((float(k) for k in keys if k < top),
                            reverse=True))
        if not caps:
            raise ValueError(
                f"response tables ({tables.source!r}) carry no cap keys "
                f"below the uncapped baseline {top}; pass caps= explicitly")
        return caps
    return DEFAULT_FREQ_CAPS if kind == "freq" else DEFAULT_POWER_CAPS


def class_cap_report(decomp: BatchModalDecomposition,
                     caps: Optional[Sequence[float]] = None,
                     kind: str = "freq",
                     dt0_tol_pct: float = DT0_TOL_PCT,
                     tables=None,
                     objective: str = "energy") -> FleetJobsReport:
    """Assign each job class its cap and aggregate the projected savings.

    Policy (paper §V-C): latency-bound jobs are never capped (no savings
    opportunity in mode 1); memory-intensive jobs take the best cap among
    those with projected ``dT <= dt0_tol_pct`` (the paper's "no
    performance compromise" criterion); compute-intensive jobs take the
    unconstrained best cap, accepting the projected slowdown. "Best" is
    the cap maximizing ``objective``'s metric-equivalent savings
    (:meth:`~repro_torch.power.objectives.Objective.cap_score`); the
    default ``objective="energy"`` scores raw savings %.

    The class aggregates and the ``(classes, caps)`` projection are one
    tensor pass on the decomposition's device; the per-class pick runs on
    one host copy of that small grid, with numpy's first-maximum rule.

    ``tables`` (any :data:`repro_torch.power.scenarios.TablesLike`) swaps
    the response surface (cross-chip what-if).
    """
    from repro_torch.power.objectives import get_objective
    from repro_torch.power.scenarios import resolve_tables
    obj = get_objective(objective)
    dev = decomp.total_energy_mwh.device
    tables = resolve_tables(tables, kind=kind, device=dev)
    if caps is None:
        caps = default_caps(kind, tables)
    caps = tuple(float(c) for c in caps)
    cls_idx = classify_jobs(decomp)
    e_tot = decomp.total_energy_mwh
    w_dt = job_dt_weights(decomp)
    # (classes, jobs) membership; the class dT weight is the
    # sample-count-weighted mean so long jobs count by their hours
    member = (cls_idx[None, :].long()
              == torch.arange(len(JOB_CLASSES), device=dev)[:, None]
              ).to(torch.float64)
    wt = torch.clamp(decomp.n_samples, min=1).to(torch.float64)
    cls_energy = member @ e_tot
    w_num, w_den = member @ (w_dt * wt), member @ wt
    w_cls = torch.where(w_den > 0, w_num / torch.clamp(w_den, min=1.0),
                        torch.zeros_like(w_den))
    proj = project_batch(
        caps, kind, e_ci_mwh=member @ decomp.energy_mwh[:, 2],
        e_mi_mwh=member @ decomp.energy_mwh[:, 1],
        e_total_mwh=torch.clamp(cls_energy, min=1e-12),
        dt_weight=w_cls, tables=tables)
    val = obj.cap_score(proj.savings_pct, proj.dt_pct,
                        dt_tol_pct=dt0_tol_pct)
    # one host copy of the small grid for the picks
    grid = torch.stack([proj.savings_pct, proj.dt_pct, val]).cpu().numpy()
    n_by_cls = member.sum(dim=1).cpu().tolist()
    energy_by_cls = cls_energy.cpu().tolist()
    fleet_total = float(e_tot.sum())

    reports: List[ClassReport] = []
    total_savings = dt0_savings = 0.0
    for ci, name in enumerate(JOB_CLASSES):
        n_jobs = int(n_by_cls[ci])
        cls_e = float(energy_by_cls[ci])
        if n_jobs == 0:
            reports.append(ClassReport(name, 0, 0.0, None, 0.0, 0.0, 0.0,
                                       True, 0.0))
            continue
        sav, dt, v = grid[0, ci], grid[1, ci], grid[2, ci]
        best_pct = float(sav[int(np.argmax(sav))])
        if name == LATENCY_BOUND:
            cap, s_pct, d_pct = None, 0.0, 0.0
        elif name == MEMORY_INTENSIVE:
            ok = dt <= dt0_tol_pct
            if ok.any():
                pick = int(np.argmax(np.where(ok, v, -np.inf)))
                cap, s_pct, d_pct = caps[pick], float(sav[pick]), \
                    float(dt[pick])
            else:
                cap, s_pct, d_pct = None, 0.0, 0.0
        else:                                   # compute-intensive
            if np.max(v) > -np.inf:
                pick = int(np.argmax(v))
                cap, s_pct, d_pct = caps[pick], float(sav[pick]), \
                    float(dt[pick])
            else:                               # no cap meets the bound
                cap, s_pct, d_pct = None, 0.0, 0.0
        s_mwh = s_pct / 100.0 * cls_e
        meets = d_pct <= dt0_tol_pct
        if meets:
            dt0_savings += s_mwh
        total_savings += s_mwh
        reports.append(ClassReport(name, n_jobs, cls_e, cap, s_mwh,
                                   s_pct, d_pct, meets, best_pct))
    return FleetJobsReport(
        kind=kind, caps=caps, classes=reports,
        total_energy_mwh=fleet_total, total_savings_mwh=total_savings,
        savings_pct=100.0 * total_savings / max(fleet_total, 1e-12),
        dt0_savings_mwh=dt0_savings, objective=obj.name)


def project_jobs(decomp: BatchModalDecomposition,
                 caps: Sequence[float], kind: str = "freq",
                 tables=None) -> BatchProjection:
    """Per-job savings projection over the whole population with per-job dT
    weights — one tensor pass on the decomposition's device, no loop over
    jobs. ``tables`` accepts any
    :data:`repro_torch.power.scenarios.TablesLike`."""
    from repro_torch.power.scenarios import resolve_tables
    tables = resolve_tables(tables, kind=kind,
                            device=decomp.total_energy_mwh.device)
    return project_batch(caps, kind,
                         e_ci_mwh=decomp.energy_mwh[:, 2],
                         e_mi_mwh=decomp.energy_mwh[:, 1],
                         e_total_mwh=decomp.total_energy_mwh,
                         dt_weight=job_dt_weights(decomp), tables=tables)
