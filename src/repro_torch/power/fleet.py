"""FleetAnalysis — the telemetry -> modal -> projection pipeline, chained.

The paper's fleet methodology is three steps run in sequence: collect power
samples (§III), decompose them into modes (§V-A/B, Table IV), project the
savings of a cap schedule (§V-C, Tables V/VI). ``FleetAnalysis`` is that
wiring as one chainable object:

    rows = FleetAnalysis.from_store(ts).decompose().project([900])

Construct from a live :class:`TelemetryStore`, a raw power-sample tensor or
array, the paper-calibrated synthetic fleet, an out-of-core telemetry
stream via :meth:`from_stream` (month-scale traces, O(shard) memory — see
:mod:`repro_torch.power.stream`), or — for the paper's job-granular
claims — a :class:`repro_torch.power.jobs.JobTable` via
:meth:`from_jobs`, which unlocks the per-job surface (``per_job()`` /
``project_jobs()`` / ``job_report()``). Both paths run on the same batched
tensor core (:func:`repro_torch.core.modal.decompose_batch`,
:func:`repro_torch.core.projection.project_batch`) on the samples' device;
the flat tensor here is its single-job special case.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import DEFAULT_DEVICE, f64
from repro_torch.core.hardware import ChipSpec, MI250X_GCD
from repro_torch.core.modal import (BatchModalDecomposition,
                                    ModalDecomposition, decompose,
                                    detect_peaks, power_histogram,
                                    synth_fleet_powers)
from repro_torch.core.projection import (BatchProjection, ProjectionRow,
                                         domain_targeted_project,
                                         project_from_decomposition)
from repro_torch.core.telemetry import TelemetryStore
from repro_torch.power import jobs as jobs_mod


class FleetAnalysis:
    """Chained fleet-power analysis over one tensor of power samples (plus
    the per-job view when built ``from_jobs``). ``powers`` stays on its
    device when it is a tensor; other data goes to ``device`` (default the
    card)."""

    def __init__(self, powers, chip: ChipSpec = MI250X_GCD,
                 sample_interval_s: float = 15.0,
                 jobs: Optional["jobs_mod.JobTable"] = None, device=None):
        self.powers = f64(powers, device).reshape(-1)
        self.device = self.powers.device
        self.chip = chip
        self.sample_interval_s = sample_interval_s
        self.decomposition: Optional[ModalDecomposition] = None
        self.jobs = jobs
        self._job_decomposition: Optional[BatchModalDecomposition] = None
        # set by attach_stream: analyses built out-of-core never hold the
        # raw sample tensor; the streaming accumulators stand in for it
        self._stream = None

    # --------------------------------------------------------- constructors
    @classmethod
    def from_store(cls, store: TelemetryStore,
                   chip: ChipSpec = MI250X_GCD,
                   sample_interval_s: Optional[float] = None,
                   device=DEFAULT_DEVICE) -> "FleetAnalysis":
        """Analyze the windowed mean powers of a live telemetry store; the
        sample interval defaults to the store's aggregation window. When the
        store carries more than one job id the per-job surface comes along
        (``from_jobs(JobTable.from_store(...))`` shorthand)."""
        interval = sample_interval_s if sample_interval_s is not None \
            else store.window_s
        jt = None
        if len(store.job_ids()) > 1:
            jt = jobs_mod.JobTable.from_store(store, chip=chip,
                                              sample_interval_s=interval,
                                              device=device)
        return cls(store.powers(), chip=chip, sample_interval_s=interval,
                   jobs=jt, device=device)

    @classmethod
    def from_powers(cls, powers, chip: ChipSpec = MI250X_GCD,
                    sample_interval_s: float = 15.0,
                    device=None) -> "FleetAnalysis":
        return cls(powers, chip=chip, sample_interval_s=sample_interval_s,
                   device=device)

    @classmethod
    def from_jobs(cls, jobs: "jobs_mod.JobTable") -> "FleetAnalysis":
        """Job-granular fleet: the flat pipeline runs over the concatenated
        valid samples (so aggregate numbers match the flat path), and the
        ``(jobs, samples)`` matrix feeds the per-job analysis."""
        return cls(jobs.concat_powers(), chip=jobs.chip,
                   sample_interval_s=jobs.sample_interval_s, jobs=jobs)

    @classmethod
    def from_stream(cls, stream, chip: ChipSpec = MI250X_GCD,
                    sample_interval_s: float = 15.0, bins: int = 120,
                    max_w: Optional[float] = None,
                    track_jobs: bool = True,
                    executor=None, device=None) -> "FleetAnalysis":
        """Out-of-core constructor: fold an iterator of sample shards (see
        :mod:`repro_torch.power.stream` — tensor chunks, JSONL sample logs,
        ``TelemetryStore.spill_npz`` files, ``JobTable.to_stream()``)
        through the incremental accumulators with O(shard) memory, on the
        shards' device (``device`` places array shards). The result's
        ``decompose``/``project``/``project_jobs``/``job_report`` are
        bit-for-bit what the materialized concatenated trace would give;
        only the raw ``powers`` tensor is absent, so the histogram is the
        streaming one (bins fixed at ingest). ``track_jobs=False`` skips
        the per-job accumulators for flat fleet-only analyses.
        ``executor`` (a :class:`repro_torch.parallel.ShardedExecutor`) runs
        the fleet scope's segment sums on its devices, with the same
        bits."""
        from repro_torch.power.stream import StreamingTelemetry
        return StreamingTelemetry(
            chip=chip, sample_interval_s=sample_interval_s, bins=bins,
            max_w=max_w, track_jobs=track_jobs, executor=executor,
            device=device).extend(stream).fleet()

    def attach_stream(self, stream) -> "FleetAnalysis":
        """Back this analysis with finished streaming accumulators (a
        :class:`repro_torch.power.stream.StreamingTelemetry`) instead of a
        raw sample tensor — used by ``StreamingTelemetry.fleet()``. The
        per-job view comes along only for multi-job streams, matching
        :meth:`from_store`."""
        self._stream = stream
        self.decomposition = stream.decomposition()
        if len(stream.job_ids()) > 1:
            self._job_decomposition = stream.per_job()
        return self

    @classmethod
    def synthetic(cls, n_samples: int, seed: int = 0,
                  hours_pct: Optional[Dict[int, float]] = None,
                  chip: ChipSpec = MI250X_GCD,
                  sample_interval_s: float = 15.0,
                  device=DEFAULT_DEVICE) -> "FleetAnalysis":
        """The paper-calibrated synthetic fleet (Table IV GPU-hours split),
        drawn on ``device`` by :func:`repro_torch.core.modal.
        synth_fleet_powers` — the stand-in for the non-public Frontier
        dataset."""
        return cls(synth_fleet_powers(n_samples, seed=seed,
                                      hours_pct=hours_pct, chip=chip,
                                      device=device),
                   chip=chip, sample_interval_s=sample_interval_s)

    @classmethod
    def synthetic_jobs(cls, n_jobs: int, seed: int = 0,
                       chip: ChipSpec = MI250X_GCD,
                       sample_interval_s: float = 15.0,
                       device=DEFAULT_DEVICE, **kw) -> "FleetAnalysis":
        """Job-granular synthetic fleet: ``n_jobs`` jobs sampled from the
        model-config registry and rendered through the chip model."""
        return cls.from_jobs(jobs_mod.JobTable.synthetic(
            n_jobs, seed=seed, chip=chip,
            sample_interval_s=sample_interval_s, device=device, **kw))

    # ---------------------------------------------------------------- modal
    def decompose(self) -> "FleetAnalysis":
        """Modal decomposition (Table IV); chainable — the result is kept on
        ``self.decomposition``."""
        if self._stream is not None:
            self.decomposition = self._stream.decomposition()
            return self
        self.decomposition = decompose(self.powers, self.sample_interval_s,
                                       self.chip)
        return self

    def histogram(self, bins: Optional[int] = None,
                  max_w: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fleet power histogram (paper Fig. 8): (bin centers, density).
        ``bins`` defaults to 120 — or, on a streamed analysis, to the bin
        layout fixed at ingest (explicitly asking for a different one
        raises: the raw samples are gone)."""
        if self._stream is not None:
            if (bins is not None and bins != self._stream.bins) or (
                    max_w is not None and max_w != self._stream.max_w):
                raise ValueError(
                    f"streamed analysis: histogram bins/max_w are fixed at "
                    f"ingest (bins={self._stream.bins}, "
                    f"max_w={self._stream.max_w}); re-ingest via "
                    f"FleetAnalysis.from_stream(..., bins=, max_w=)")
            return self._stream.histogram()
        return power_histogram(self.powers, bins=bins if bins is not None
                               else 120, max_w=max_w)

    def peaks(self, bins: Optional[int] = None, smooth: int = 3,
              min_rel_height: float = 0.08) -> List[float]:
        """Prevalent zones of operation (paper Figs. 8/9): the local maxima
        of the smoothed power histogram, in watts."""
        centers, hist = self.histogram(bins=bins)
        return detect_peaks(centers, hist, smooth=smooth,
                            min_rel_height=min_rel_height)

    # ----------------------------------------------------------- projection
    def _decomposition(self) -> ModalDecomposition:
        if self.decomposition is None:
            self.decompose()
        return self.decomposition

    def _tables(self, tables, kind: str):
        from repro_torch.power.scenarios import resolve_tables
        return resolve_tables(tables, kind=kind, chip=self.chip,
                              device=self.device)

    def project(self, caps: List[float], kind: str = "freq",
                tables: "TablesLike" = None,
                objective: str = "energy") -> List[ProjectionRow]:
        """Project fleet savings for a cap schedule (Tables V/VI engine)
        from this fleet's own modal energy split — the single-cell view of
        a projection :class:`repro_torch.power.Scenario`. ``kind`` is
        ``"freq"`` (MHz caps) or ``"power"`` (watt caps); ``tables`` is any
        :data:`~repro_torch.power.scenarios.TablesLike`; ``objective``
        annotates each row with its metric-equivalent savings %."""
        return project_from_decomposition(
            self._decomposition(), caps, kind,
            tables=self._tables(tables, kind), objective=objective,
            device=self.device)

    def project_domains(self,
                        domain_energies: Mapping[str, Tuple[float, float]],
                        caps: List[float], kind: str = "freq",
                        tables: "TablesLike" = None
                        ) -> Dict[str, List[ProjectionRow]]:
        """Deprecated spelling of the Table VI analogue (cap only selected
        science domains / job-size classes): each domain is a
        :meth:`repro_torch.power.Workload.from_energies` workload now, so
        the sweep is one :class:`repro_torch.power.Study` over those
        workloads. ``domain_energies``: name -> (E_CI, E_MI) MWh."""
        warnings.warn(
            "repro_torch.power.FleetAnalysis.project_domains is deprecated; "
            "run a Study over Workload.from_energies(ci, mi, total) "
            "workloads (repro_torch.power.scenarios) instead",
            DeprecationWarning, stacklevel=2)
        e_total = self._decomposition().total_energy_mwh
        return domain_targeted_project(
            domain_energies, caps, kind, e_total_mwh=e_total,
            tables=self._tables(tables, kind), device=self.device)

    # ---------------------------------------------------------- job surface
    def _require_jobs(self) -> "jobs_mod.JobTable":
        if self.jobs is None:
            raise ValueError(
                "no per-job view: construct via FleetAnalysis.from_jobs / "
                "synthetic_jobs / from_stream, or a multi-job telemetry "
                "store")
        return self.jobs

    def per_job(self) -> BatchModalDecomposition:
        """Batched per-job modal decomposition — one tensor pass over the
        whole ``(jobs, samples)`` matrix, cached."""
        if self._job_decomposition is None:
            self._job_decomposition = self._require_jobs().decompose()
        return self._job_decomposition

    def job_classes(self) -> torch.Tensor:
        """Per-job class index into
        :data:`repro_torch.power.jobs.JOB_CLASSES`."""
        return jobs_mod.classify_jobs(self.per_job())

    def project_jobs(self, caps: Sequence[float], kind: str = "freq",
                     tables: "TablesLike" = None) -> BatchProjection:
        """Per-job cap projection with per-job dT weights; all tensors are
        ``(jobs, caps)``. ``tables`` accepts any
        :data:`~repro_torch.power.scenarios.TablesLike`."""
        return jobs_mod.project_jobs(self.per_job(), caps, kind,
                                     tables=self._tables(tables, kind))

    def job_report(self, caps: Optional[Sequence[float]] = None,
                   kind: str = "freq", tables: "TablesLike" = None,
                   objective: str = "energy"
                   ) -> "jobs_mod.FleetJobsReport":
        """Per-class cap schedule + aggregate savings (the paper's §V job-
        granular result: C.I. jobs capped for maximum savings, M.I. jobs
        capped at dT=0, latency-bound jobs left alone) — the single-cell
        view of a schedule :class:`repro_torch.power.Scenario`.
        ``objective`` makes the per-class "best cap" selection
        metric-driven."""
        return jobs_mod.class_cap_report(
            self.per_job(), caps, kind, tables=self._tables(tables, kind),
            objective=objective)

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        d = self._decomposition()
        out = {
            "chip": self.chip.name,
            "samples": (self._stream.n_samples if self._stream is not None
                        else int(self.powers.numel())),
            "hours_pct": d.hours_pct,
            "energy_pct": d.energy_pct(),
            "total_energy_mwh": d.total_energy_mwh,
            "peaks_w": self.peaks(),
        }
        if self.jobs is not None or self._job_decomposition is not None:
            counts = torch.bincount(self.job_classes().long(),
                                    minlength=len(jobs_mod.JOB_CLASSES))
            out["n_jobs"] = (len(self.jobs) if self.jobs is not None
                             else self._job_decomposition.n_jobs)
            out["job_classes"] = dict(zip(jobs_mod.JOB_CLASSES,
                                          counts.tolist()))
        return out
