"""Declarative what-if studies — one grid API over every projection.

The paper's contribution is a *methodology*: sweep cap schedules, response
surfaces and job classes over months of telemetry to find the best-case
envelope (8.5% / 1438 MWh). This module is the one grid API over it:

* :class:`Workload` — a named workload source (a power tensor, a live
  :class:`TelemetryStore`, a :class:`JobTable`, a re-iterable telemetry
  stream, the paper-calibrated synthetic fleet, or bare modal energies)
  with one cached analysis per study, however many cells share it;
* :class:`Scenario` — ONE cell of a what-if grid: workload x chip x policy
  x cap (+ ``kind`` and a response-:data:`TablesLike` spec). The cell shape
  follows from (policy, cap):

  ===========  ==========  ==============================================
  policy       cap         evaluates as
  ===========  ==========  ==============================================
  ``None``     a number    cap projection — ``FleetAnalysis.project``
  ``None``     a sequence  per-class cap schedule — ``job_report``
               / ``None``
  a policy     anything    counterfactual replay — ``stream.replay`` (a
                           cap additionally attaches the response-table
                           projection rows of the recorded trace)
  ===========  ==========  ==============================================

* broker cells (``Study(brokers=[...], budgets_mw=[...])``) — the online
  counterpart: each cell is one :func:`~repro_torch.power.broker.
  simulate_cluster` run of the workload's cached
  :class:`~repro_torch.power.broker.ClusterTrace` under a budgeted broker,
  reported with throughput next to savings;
* :class:`Study` — axes (lists per dimension) expanded into the cartesian
  grid and executed **batched**: one modal decomposition per workload, one
  ``project`` pass per (workload, tables, kind) over the union of the
  group's caps, one ``class_cap_report`` per schedule group, one chunked
  ``replay`` per (workload, policy, chip);
* :class:`StudyResult` — the grid as columnar arrays (``savings_pct``,
  ``dt_pct``, ``savings_mwh``…) with ``compare()`` / ``best("dT<=0.5")`` /
  ``pivot()`` / ``pareto()`` / ``to_markdown()`` / ``confidence()`` and
  per-cell detail objects (:class:`ProjectionRow` /
  :class:`FleetJobsReport` / ``ReplayReport`` / ``BrokerReport``);
* :func:`resolve_tables` — the response-table resolver every entry point
  shares: ``None``/``"measured"`` -> the paper's measured MI250X columns, a
  chip (spec/name/model) -> cached model-derived
  :func:`~repro_torch.power.surface.response_table`,
  ``"calibrated:<kernel>"`` -> the tuner's tables, ``"auto"`` -> measured
  on the paper's chip, model-derived elsewhere.

The analysis runs on the workload's device. What a cell reports (savings,
dT, the chosen caps) comes back to the host as python floats; the
bootstrap of :meth:`StudyResult.confidence` draws its job-count vectors on
the host from ``np.random.default_rng(seed)`` — the reference's draws, so
an interval is comparable number for number — and resamples on the
contributions' device.

Typical grid::

    from repro_torch.power import Study, Workload

    study = Study(
        workloads=[Workload.synthetic_jobs(4000, seed=0)],
        chips=["mi250x-gcd", "h100-sxm"],
        caps=[900.0, (1500, 1300, 1100, 900, 700)],
    )
    res = study.run()
    print(res.filter(cell="project").to_markdown(rows="cap", cols="chip"))
    best = res.best("dT<=0.5")
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from functools import lru_cache
from statistics import NormalDist
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core import hardware as hw
from repro_torch.core.hardware import ChipSpec, MI250X_GCD
from repro_torch.core.modal import synth_fleet_powers
from repro_torch.core.power_model import ChipModel
from repro_torch.core.projection import (ProjectionRow, ResponseTables,
                                         check_tables_kind, project)
from repro_torch.core.telemetry import TelemetryStore
from repro_torch.power.jobs import FleetJobsReport, JobTable
from repro_torch.power.objectives import check_objective, get_objective
from repro_torch.power.policies import PolicyLike, PowerPolicy, get_policy

# ---------------------------------------------------------------------------
# The response-table resolver
# ---------------------------------------------------------------------------
#: What every ``tables=`` parameter accepts: ``None`` / ``"measured"`` (the
#: paper's measured MI250X columns), an explicit :class:`ResponseTables`, a
#: chip (name / spec / model) for a model-derived table,
#: ``"calibrated:<kernel>"`` (tuner-derived tables from
#: :func:`repro_torch.tuning.calibrated_tables`), or ``"auto"`` (measured on
#: the paper's chip, model elsewhere).
TablesLike = Union[None, str, ResponseTables, ChipSpec, ChipModel]

_MEASURED_NAMES = ("measured", "mi250x-table-iii", "paper")


@lru_cache(maxsize=None)
def _model_tables(chip: ChipSpec, kind: str, device: str) -> ResponseTables:
    # keyed on the (frozen, hashable) spec itself so unregistered chip
    # variants cache and group exactly like the registry chips
    from repro_torch.power.surface import response_table
    return response_table(chip, kind=kind, device=device)


def resolve_tables(tables: TablesLike = "auto", *, kind: str = "freq",
                   chip: Union[None, str, ChipSpec, ChipModel] = None,
                   device=None) -> Optional[ResponseTables]:
    """Resolve a :data:`TablesLike` spec into what the projection engine
    eats (``None`` = the built-in measured MI250X columns for ``kind``).

    * ``None`` / ``"measured"`` -> ``None`` (measured MI250X);
    * a :class:`ResponseTables` -> itself (after a kind check);
    * a chip name / :class:`ChipSpec` / :class:`ChipModel` -> the cached
      model-derived :func:`~repro_torch.power.surface.response_table` of
      that chip, computed on ``device`` (default the card);
    * ``"calibrated:<kernel>"`` -> tuner-derived tables for a kernel of this
      package (``vai`` / ``membw`` / ``flash_attention``): a registered
      calibration for (kernel, kind, ``chip``) if one exists, else the
      kernel's default config space measured on the simulated backend on
      ``device``;
    * ``"auto"`` -> measured when the evaluation ``chip`` is the paper's
      MI250X GCD (or unspecified), model-derived for any other chip.
    """
    if tables is None or (isinstance(tables, str)
                          and tables in _MEASURED_NAMES):
        return None
    if isinstance(tables, ResponseTables):
        check_tables_kind(tables, kind)
        return tables
    dev = str(as_device(device))
    if isinstance(tables, str) and tables.startswith("calibrated:"):
        from repro_torch.tuning.calibrate import calibrated_tables
        kernel = tables.split(":", 1)[1]
        return calibrated_tables(kernel, kind=kind, chip=chip, device=dev)
    if isinstance(tables, str) and tables == "auto":
        if chip is None:
            return None
        spec = ChipModel(chip).spec
        if spec == MI250X_GCD:       # the full spec, not the name: a
            return None              # modified variant is another chip
        return _model_tables(spec, kind, dev)
    if isinstance(tables, (str, ChipSpec, ChipModel)):
        return _model_tables(ChipModel(tables).spec, kind, dev)
    raise TypeError(
        f"cannot resolve response tables from {tables!r}; pass None, "
        f"'measured', 'auto', a ResponseTables, or a chip (name/spec/model)")


def _tables_source(tables: Optional[ResponseTables]) -> str:
    return "mi250x-table-iii" if tables is None else tables.source


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------
class Workload:
    """A named workload source: the thing a study's cells share.

    One instance = one frozen snapshot of the workload: however many cells
    (or successive studies) reference it, its modal decomposition (and
    per-job view) is computed once and cached for the object's lifetime,
    and :meth:`stream` re-yields the identical shard sequence for every
    replay cell, so a chunked replay of the same (policy, chip) is shared
    too. To re-analyze a live source that has since grown (e.g. a recording
    :class:`TelemetryStore`), construct a fresh Workload. The analysis runs
    on ``device``: a power tensor's or job table's own, else the one asked
    for (default the card; a stream's shards stay on their own device).
    """

    def __init__(self, name: str, chip: Union[str, ChipSpec, ChipModel],
                 sample_interval_s: float = 15.0, *,
                 powers=None,
                 store: Optional[TelemetryStore] = None,
                 jobs: Optional[JobTable] = None,
                 stream_factory: Optional[Callable[[], Iterable]] = None,
                 energies: Optional[Tuple[float, float, float]] = None,
                 device=None):
        sources = [s is not None for s in (powers, store, jobs,
                                           stream_factory, energies)]
        if sum(sources) != 1:
            raise ValueError("exactly one workload source required")
        self.name = name
        self.chip: ChipSpec = ChipModel(chip).spec
        self.sample_interval_s = float(sample_interval_s)
        if powers is not None:
            powers = f64(powers, device)
            device = powers.device
        elif jobs is not None:
            device = jobs.device
        self.device = as_device(device)
        self._powers = powers
        self._store = store
        self._jobs = jobs
        self._stream_factory = stream_factory
        self._energies_src = energies
        self._fleet = None
        self._cluster: Dict[int, Any] = {}

    def __repr__(self) -> str:
        return f"Workload({self.name!r}, chip={self.chip.name!r})"

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_powers(cls, powers, chip=MI250X_GCD,
                    sample_interval_s: float = 15.0,
                    name: str = "powers", device=None) -> "Workload":
        """A flat power-sample tensor or array (W per interval)."""
        return cls(name, chip, sample_interval_s, powers=powers,
                   device=device)

    @classmethod
    def from_store(cls, store: TelemetryStore, chip=MI250X_GCD,
                   name: str = "store", device=DEFAULT_DEVICE) -> "Workload":
        """A :class:`TelemetryStore` (windowed mean powers; the per-job
        view comes along for multi-job stores). The store's aggregated
        windows are snapshotted here (flush + copy), so recording into the
        live store afterwards never leaks into this workload."""
        store.flush()
        snap = TelemetryStore(window_s=store.window_s)
        snap.windows.extend(store.windows)
        return cls(name, chip, store.window_s, store=snap, device=device)

    @classmethod
    def from_jobs(cls, jobs: JobTable, name: str = "jobs") -> "Workload":
        """A :class:`JobTable` — unlocks per-class schedule cells."""
        return cls(name, jobs.chip, jobs.sample_interval_s, jobs=jobs)

    @classmethod
    def from_serving(cls, served, name: str = "serving") -> "Workload":
        """A served trace — a :class:`repro_torch.serving.ServeReport` (or
        any engine/report exposing ``.session``) or the
        :class:`~repro_torch.power.EnergySession` itself. Snapshots the
        session's telemetry against the session's own chip envelope, on the
        session's device."""
        session = getattr(served, "session", served)
        if session is None or not hasattr(session, "telemetry"):
            raise ValueError(
                "from_serving needs a served trace whose engine recorded "
                "into an EnergySession (pass session=EnergySession(...) "
                "to the engine), or the session itself")
        return cls.from_store(session.telemetry, chip=session.chip.spec,
                              name=name, device=session.device)

    @classmethod
    def from_stream(cls, stream_factory, chip=MI250X_GCD,
                    sample_interval_s: float = 15.0,
                    name: str = "stream", device=None) -> "Workload":
        """An out-of-core telemetry stream. ``stream_factory`` must be
        re-iterable — a zero-arg callable returning a fresh shard iterator,
        or a ``.npz`` spill path / list of paths
        (:meth:`TelemetryStore.spill_npz` files, read onto ``device``) —
        because projection cells fold it once and every (policy, chip)
        replay group re-reads it."""
        if isinstance(stream_factory, (str, list, tuple)):
            paths = stream_factory
            from repro_torch.power.stream import iter_npz
            dev = as_device(device)
            stream_factory = lambda: iter_npz(paths, device=dev)  # noqa: E731
        elif not callable(stream_factory):
            raise TypeError(
                "stream_factory must be a zero-arg callable returning a "
                "fresh shard iterator, or .npz spill path(s); a bare "
                "iterator would be exhausted by the first cell")
        return cls(name, chip, sample_interval_s,
                   stream_factory=stream_factory, device=device)

    @classmethod
    def synthetic(cls, n_samples: int, seed: int = 0,
                  hours_pct: Optional[Dict[int, float]] = None,
                  chip=MI250X_GCD, sample_interval_s: float = 15.0,
                  name: Optional[str] = None,
                  device=DEFAULT_DEVICE) -> "Workload":
        """The paper-calibrated synthetic fleet (Table IV hours split),
        drawn on ``device``."""
        spec = ChipModel(chip).spec
        return cls.from_powers(
            synth_fleet_powers(n_samples, seed=seed, hours_pct=hours_pct,
                               chip=spec, device=device),
            chip=spec, sample_interval_s=sample_interval_s,
            name=name or f"synthetic[{n_samples}]")

    @classmethod
    def synthetic_jobs(cls, n_jobs: int, seed: int = 0, chip=MI250X_GCD,
                       sample_interval_s: float = 15.0,
                       name: Optional[str] = None, device=DEFAULT_DEVICE,
                       **kw) -> "Workload":
        """The synthetic multi-job fleet (model-config job mixes rendered
        through the chip model) on ``device`` — schedule cells work."""
        return cls.from_jobs(
            JobTable.synthetic(n_jobs, seed=seed, chip=ChipModel(chip).spec,
                               sample_interval_s=sample_interval_s,
                               device=device, **kw),
            name=name or f"jobs[{n_jobs}]")

    @classmethod
    def from_energies(cls, e_ci_mwh: float, e_mi_mwh: float,
                      e_total_mwh: float, name: str = "energies",
                      device=DEFAULT_DEVICE) -> "Workload":
        """Bare modal energies (MWh in the C.I. / M.I. modes + total) — the
        workload behind Table V/VI-style projections with no sample trace,
        e.g. one science domain's energy split."""
        return cls(name, MI250X_GCD,
                   energies=(float(e_ci_mwh), float(e_mi_mwh),
                             float(e_total_mwh)), device=device)

    @classmethod
    def paper_fleet(cls, device=DEFAULT_DEVICE) -> "Workload":
        """The paper's published fleet constants (Table IV energy split) —
        ``Scenario(paper_fleet(), cap=900)`` reproduces Table V rows."""
        return cls.from_energies(hw.FLEET_ENERGY_CI_MWH,
                                 hw.FLEET_ENERGY_MI_MWH,
                                 hw.TOTAL_FLEET_ENERGY_MWH,
                                 name="paper-fleet", device=device)

    # -------------------------------------------------------------- analysis
    def fleet(self):
        """This workload's :class:`~repro_torch.power.fleet.FleetAnalysis`,
        built and decomposed once (cached)."""
        if self._fleet is None:
            from repro_torch.power.fleet import FleetAnalysis
            if self._powers is not None:
                fa = FleetAnalysis.from_powers(
                    self._powers, chip=self.chip,
                    sample_interval_s=self.sample_interval_s)
            elif self._store is not None:
                fa = FleetAnalysis.from_store(
                    self._store, chip=self.chip,
                    sample_interval_s=self.sample_interval_s,
                    device=self.device)
            elif self._jobs is not None:
                fa = FleetAnalysis.from_jobs(self._jobs)
            elif self._stream_factory is not None:
                fa = FleetAnalysis.from_stream(
                    self._stream_factory(), chip=self.chip,
                    sample_interval_s=self.sample_interval_s,
                    device=self.device)
            else:
                raise ValueError(
                    f"workload {self.name!r} carries modal energies only — "
                    f"no sample-level analysis (projection cells work, "
                    f"schedule/replay cells need samples)")
            self._fleet = fa
        return self._fleet

    def energies_mwh(self) -> Tuple[float, float, float]:
        """(E_CI, E_MI, E_total) in MWh — the projection engine's input,
        from the cached decomposition (or directly for energy workloads)."""
        if self._energies_src is not None:
            return self._energies_src
        d = self.fleet()._decomposition()
        return (d.energy_mwh.get(3, 0.0), d.energy_mwh.get(2, 0.0),
                d.total_energy_mwh)

    def stream(self) -> Iterator:
        """A fresh shard iterator over this workload (same boundaries every
        call, so shared replays are reproducible), on the workload's
        device."""
        from repro_torch.power.stream import iter_array, iter_store
        if self._powers is not None:
            return iter_array(self._powers,
                              sample_interval_s=self.sample_interval_s)
        if self._store is not None:
            return iter_store(self._store, device=self.device)
        if self._jobs is not None:
            return self._jobs.to_stream()
        if self._stream_factory is not None:
            return iter(self._stream_factory())
        raise ValueError(
            f"workload {self.name!r} carries modal energies only — replay "
            f"cells need a sample stream")

    def cluster_trace(self, chunk_samples: int = 60):
        """This workload's :class:`~repro_torch.power.broker.ClusterTrace`
        (cached per ``chunk_samples``) — what broker cells simulate.
        Job-table workloads chunk-fold the table on its device; stream
        workloads fold the shard stream (arrivals from ``time_s`` stamps).
        Flat power tensors / stores / bare energies carry no job
        structure."""
        ct = self._cluster.get(chunk_samples)
        if ct is None:
            from repro_torch.power.broker import ClusterTrace
            if self._jobs is not None:
                ct = ClusterTrace.from_jobs(self._jobs,
                                            chunk_samples=chunk_samples)
            elif self._stream_factory is not None:
                ct = ClusterTrace.from_stream(
                    self._stream_factory(), chip=self.chip,
                    sample_interval_s=self.sample_interval_s,
                    chunk_samples=chunk_samples, device=self.device)
            else:
                raise ValueError(
                    f"workload {self.name!r} has no per-job structure — "
                    f"broker cells need a JobTable or stream workload")
            self._cluster[chunk_samples] = ct
        return ct


# ---------------------------------------------------------------------------
# Scenario — one cell
# ---------------------------------------------------------------------------
CapLike = Union[None, float, int, Sequence[float]]

PROJECT, SCHEDULE, REPLAY, BROKER = "project", "schedule", "replay", "broker"


def _is_number(x) -> bool:
    """One cap value (vs a schedule sequence): python or numpy scalar."""
    return isinstance(x, (int, float, np.number))


def _policy_label(policy: Optional[PowerPolicy]) -> str:
    if policy is None:
        return "-"
    bits = [policy.name]
    if dataclasses.is_dataclass(policy):
        for f in dataclasses.fields(policy):
            v = getattr(policy, f.name)
            if f.name != "name" and v != f.default and v is not None:
                bits.append(f"{f.name}={v:g}" if isinstance(v, float)
                            else f"{f.name}={v}")
    return " ".join(bits)


def cap_label(cap: CapLike) -> str:
    """Stable string key for a cap axis value (pivot/markdown columns).
    Schedule labels list every cap so two distinct schedules never
    collapse into one filter/pivot key."""
    if cap is None:
        return "-"
    if _is_number(cap):
        return f"{cap:g}"
    return "sched(" + ",".join(f"{float(c):g}" for c in cap) + ")"


@dataclass
class Scenario:
    """One cell of a what-if grid. ``chip=None`` evaluates on the
    workload's own (recording) chip; ``tables="auto"`` resolves through
    :func:`resolve_tables` against the evaluation chip, on the workload's
    device. See the module docstring for how (policy, cap) selects the
    cell shape."""

    workload: Workload
    chip: Union[None, str, ChipSpec, ChipModel] = None
    policy: PolicyLike = None
    cap: CapLike = None
    kind: str = "freq"
    tables: TablesLike = "auto"
    label: str = ""
    broker: Any = None                   # a broker spec -> a "broker" cell
    budget_mw: Optional[float] = None    # facility budget (None = unbounded)
    n_nodes: int = 10_000                # broker cells: the node pool
    #: the cell's optimization metric (a :data:`repro_torch.power.
    #: objectives` registry name) — re-parameterizes name-resolved policies
    #: and drives the cap selection of schedule cells; every cell reports
    #: its metric-equivalent savings as ``objective_pct``
    objective: str = "energy"

    def resolved_chip(self) -> ChipSpec:
        return self.workload.chip if self.chip is None \
            else ChipModel(self.chip).spec

    def resolved_policy(self) -> Optional[PowerPolicy]:
        if self.policy is None:
            return None
        if isinstance(self.policy, tuple):
            name, knobs = self.policy
            knobs = dict(knobs)
            p = get_policy(name, **knobs)
            from_spec, pinned = True, "objective" in knobs
        else:
            p = get_policy(self.policy)
            from_spec, pinned = isinstance(self.policy, str), False
        # the metrics axis re-parameterizes policies the Study resolved
        # itself; a policy OBJECT is the caller's — never mutated
        if (self.objective != "energy" and from_spec and not pinned
                and dataclasses.is_dataclass(p)
                and getattr(p, "objective", None) == "energy"):
            p = dataclasses.replace(p, objective=self.objective)
        return p

    def resolved_tables(self) -> Optional[ResponseTables]:
        return resolve_tables(self.tables, kind=self.kind,
                              chip=self.resolved_chip(),
                              device=self.workload.device)

    def caps_list(self) -> Optional[List[float]]:
        if self.cap is None:
            return None
        if _is_number(self.cap):
            return [float(self.cap)]
        return [float(c) for c in self.cap]

    def resolved_broker(self):
        from repro_torch.power.broker import get_broker
        if isinstance(self.broker, tuple) and len(self.broker) == 2 \
                and isinstance(self.broker[0], str) \
                and isinstance(self.broker[1], dict):
            name, knobs = self.broker
            knobs = dict(knobs)
            if self.objective != "energy":
                knobs.setdefault("objective", self.objective)
            return get_broker(name, **knobs)
        if isinstance(self.broker, str) and self.objective != "energy":
            try:
                return get_broker(self.broker, objective=self.objective)
            except TypeError:
                pass     # broker takes no objective knob (e.g. uniform)
        return get_broker(self.broker)

    @property
    def cell(self) -> str:
        """``"project"`` / ``"schedule"`` / ``"replay"`` / ``"broker"``."""
        if self.broker is not None or self.budget_mw is not None:
            return BROKER
        if self.policy is not None:
            return REPLAY
        if _is_number(self.cap):
            return PROJECT
        return SCHEDULE

    def run(self) -> "StudyResult":
        """Evaluate this single cell (a one-cell :class:`Study`)."""
        return Study(scenarios=[self]).run()


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------
@dataclass
class CellResult:
    """One evaluated grid cell: index columns + headline metrics + the
    full detail object of the underlying engine.

    ``savings_pct`` / ``dt_pct`` / ``savings_mwh`` are the cell's headline:
    the projection row for project cells; the schedule aggregate for
    schedule cells (``dt_pct`` there is the energy-weighted mean of the
    per-class projected dT); the replayed-vs-nominal-baseline delta for
    replay cells. ``savings_dt0_pct`` is NaN for replay cells and
    ``model_bias_pct`` NaN for non-replay cells.
    """

    workload: str
    chip: str
    policy: str
    cap: CapLike
    kind: str
    tables: str
    cell: str
    savings_pct: float
    dt_pct: float
    savings_mwh: float
    total_energy_mwh: float
    savings_dt0_pct: float
    model_bias_pct: float
    detail: Any
    projection: Optional[List[ProjectionRow]] = None
    label: str = ""
    budget_mw: float = float("nan")             # broker cells only
    throughput_jobs_per_h: float = float("nan")  # broker cells only
    #: the cell's optimization metric and its metric-equivalent savings %
    #: (equal to ``savings_pct`` for the default ``"energy"``)
    metric: str = "energy"
    objective_pct: float = float("nan")
    #: back-reference to the evaluated scenario — what ``confidence()``
    #: resamples (per-job structure lives on the workload)
    scenario: Any = None

    def to_dict(self) -> Dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name not in ("detail", "projection", "scenario")}
        d["cap"] = cap_label(self.cap)
        return d


_METRICS = ("savings_pct", "dt_pct", "savings_mwh", "total_energy_mwh",
            "savings_dt0_pct", "model_bias_pct", "budget_mw",
            "throughput_jobs_per_h", "objective_pct")
_INDEX = ("workload", "chip", "policy", "kind", "tables", "cell", "label",
          "metric")
_ALIASES = {
    "dt": "dt_pct", "dT": "dt_pct", "slowdown": "dt_pct",
    "savings": "savings_pct", "sav": "savings_pct",
    "sav0": "savings_dt0_pct", "savings_dt0": "savings_dt0_pct",
    "dt0": "savings_dt0_pct",
    "bias": "model_bias_pct", "model_bias": "model_bias_pct",
    "mwh": "savings_mwh", "saved_mwh": "savings_mwh",
    "energy": "total_energy_mwh",
    "budget": "budget_mw", "throughput": "throughput_jobs_per_h",
    "jobs_per_h": "throughput_jobs_per_h",
    "objective": "objective_pct", "obj": "objective_pct",
}
_CONSTRAINT_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(<=|>=|==|!=|<|>)\s*"
    r"([-+]?[0-9.]+(?:[eE][-+]?[0-9]+)?)\s*$")
_OPS = {"<=": np.less_equal, ">=": np.greater_equal, "<": np.less,
        ">": np.greater, "==": np.equal, "!=": np.not_equal}


def _metric_name(name: str) -> str:
    resolved = _ALIASES.get(name, name)
    if resolved not in _METRICS:
        raise KeyError(f"unknown metric {name!r}; known: {_METRICS} "
                       f"(+ aliases {sorted(_ALIASES)})")
    return resolved


@dataclass(frozen=True)
class ConfidenceInterval:
    """One cell's resampled interval for one statistic. ``n`` is the number
    of jobs resampled — 0 means the cell carries no per-job structure (the
    interval is then ``(nan, nan)`` around the point value). Supports
    ``8.5 in ci`` containment tests."""

    stat: str
    value: float
    lo: float
    hi: float
    method: str
    n: int

    def __contains__(self, x) -> bool:
        return bool(self.lo <= float(x) <= self.hi)

    def __str__(self) -> str:
        return (f"{self.stat}={self.value:.3f} "
                f"[{self.lo:.3f}, {self.hi:.3f}] "
                f"({self.method}, n={self.n})")


def _job_contributions(cell: CellResult, stat: str
                       ) -> Optional[Tuple[torch.Tensor,
                                           Optional[torch.Tensor], float]]:
    """Per-job contribution tensors ``(num, den, scale)`` such that the
    cell's ``stat`` equals ``scale * num.sum() / den.sum()`` (``den=None``
    means a plain total: ``scale * num.sum()``). Resampling jobs therefore
    reduces to resampling these sums — exact because the projection engine
    is linear in per-job modal energies (``project_batch``). Returns None
    when the cell has no per-job structure or the stat is not job-borne
    (cap schedules stay FIXED at the full-population choice: the interval
    is conditional on the schedule, not on re-picking caps per resample).
    The tensors lie on the workload's device."""
    s = cell.scenario
    if s is None:
        return None
    if cell.cell == REPLAY:
        rows = getattr(cell.detail, "jobs", None)
        if not rows:
            return None
        dev = s.workload.device
        base = f64([r.energy_base_j for r in rows], dev)
        sav = f64([r.savings_pct for r in rows], dev)
        if stat == "savings_pct":
            return base * sav / 100.0, base, 100.0
        if stat == "savings_mwh":
            return base * sav / 100.0 / 3.6e9, None, 1.0
        if stat == "dt_pct":
            t = f64([r.time_rec_s for r in rows], dev)
            dt = f64([r.dt_pct for r in rows], dev)
            return t * dt / 100.0, t, 100.0
        return None
    if cell.cell not in (PROJECT, SCHEDULE) or stat not in (
            "savings_pct", "savings_mwh", "savings_dt0_pct"):
        return None
    try:
        fleet = s.workload.fleet()
        decomp = fleet.per_job()
    except ValueError:
        return None                      # no per-job view on this workload
    e_tot = decomp.total_energy_mwh
    tables = s.resolved_tables()
    if cell.cell == PROJECT:
        bp = fleet.project_jobs([float(s.cap)], s.kind, tables=tables)
        sav = bp.total_mwh[:, 0]
        sav0 = bp.savings_dt0_pct[:, 0] / 100.0 \
            * torch.clamp(e_tot, min=1e-12)
    else:                                # SCHEDULE: per-class caps
        rep: FleetJobsReport = cell.detail
        cls_idx = fleet.job_classes()
        caps_used = sorted({c.cap for c in rep.classes if c.cap is not None})
        sav = torch.zeros_like(e_tot)
        sav0 = torch.zeros_like(e_tot)
        if caps_used:
            bp = fleet.project_jobs(caps_used, rep.kind, tables=tables)
            col = {c: k for k, c in enumerate(caps_used)}
            for i, cr in enumerate(rep.classes):
                if cr.cap is None:
                    continue
                members = cls_idx == i
                sav = torch.where(members, bp.total_mwh[:, col[cr.cap]], sav)
                if cr.meets_dt0:
                    sav0 = torch.where(members, sav, sav0)
    if stat == "savings_pct":
        return sav, e_tot, 100.0
    if stat == "savings_mwh":
        return sav, None, 1.0
    return sav0, e_tot, 100.0


class StudyResult:
    """The evaluated grid, columnar. Iterate for :class:`CellResult` rows;
    ``res.savings_pct`` etc. are aligned float arrays (host numpy)."""

    def __init__(self, cells: Sequence[CellResult]):
        self.cells: List[CellResult] = list(cells)

    # ------------------------------------------------------------- container
    def __len__(self) -> int:
        return len(self.cells)

    def __iter__(self) -> Iterator[CellResult]:
        return iter(self.cells)

    def __getitem__(self, i: int) -> CellResult:
        return self.cells[i]

    # --------------------------------------------------------------- columns
    def column(self, name: str) -> Union[np.ndarray, List[str]]:
        """A metric as a float array, or an index column (``workload`` /
        ``chip`` / ``policy`` / ``cap`` / ``kind`` / ``tables`` / ``cell``)
        as a list of label strings."""
        if name == "cap":
            return [cap_label(c.cap) for c in self.cells]
        if name in _INDEX:
            return [getattr(c, name) for c in self.cells]
        m = _metric_name(name)
        return np.array([getattr(c, m) for c in self.cells],
                        dtype=np.float64)

    def __getattr__(self, name: str):
        if name in _METRICS:
            return self.column(name)
        raise AttributeError(name)

    def to_dicts(self) -> List[Dict]:
        return [c.to_dict() for c in self.cells]

    # ------------------------------------------------------------- selection
    def filter(self, **eq) -> "StudyResult":
        """Subset by equality on index columns, e.g.
        ``res.filter(chip="h100-sxm", cell="project")``. ``cap=`` matches
        against :func:`cap_label` strings (or raw cap values);
        ``policy=`` matches the full knob-bearing label OR the bare policy
        name."""
        keep = self.cells
        for name, want in eq.items():
            if name == "cap":
                want_l = want if isinstance(want, str) else cap_label(want)
                keep = [c for c in keep if cap_label(c.cap) == want_l]
            elif name == "policy":
                keep = [c for c in keep
                        if c.policy == want
                        or c.policy.split(" ")[0] == want]
            elif name in _INDEX:
                keep = [c for c in keep if getattr(c, name) == want]
            else:
                raise KeyError(f"filter() takes index columns {_INDEX} + "
                               f"'cap', got {name!r}")
        return StudyResult(keep)

    def _mask(self, constraint: Union[None, str, Sequence[str]]
              ) -> np.ndarray:
        if constraint is None:
            return np.ones(len(self.cells), dtype=bool)
        specs = [constraint] if isinstance(constraint, str) else constraint
        mask = np.ones(len(self.cells), dtype=bool)
        for spec in specs:
            m = _CONSTRAINT_RE.match(spec)
            if not m:
                raise ValueError(
                    f"cannot parse constraint {spec!r}; expected "
                    f"'<metric> <op> <number>' like 'dT<=0.5'")
            col = self.column(_metric_name(m.group(1)))
            with np.errstate(invalid="ignore"):
                # isfinite keeps the "NaN never satisfies" promise for the
                # ops NaN would otherwise pass (!=)
                mask &= _OPS[m.group(2)](col, float(m.group(3))) \
                    & np.isfinite(col)
        return mask

    def where(self, constraint: Union[str, Sequence[str]]) -> "StudyResult":
        """Subset by metric constraints, e.g. ``res.where("dT<=0.5")``.
        NaN metrics never satisfy a constraint."""
        mask = self._mask(constraint)
        return StudyResult([c for c, ok in zip(self.cells, mask) if ok])

    def best(self, constraint: Union[None, str, Sequence[str]] = None,
             by: str = "savings_pct") -> CellResult:
        """The cell maximizing ``by`` among those meeting ``constraint``
        (e.g. ``best("dT<=0.5")`` — the paper's no-performance-compromise
        winner)."""
        mask = self._mask(constraint)
        col = self.column(_metric_name(by))
        score = np.where(mask & np.isfinite(col), col, -np.inf)
        if not len(score) or not np.isfinite(score).any():
            raise ValueError(
                f"no cell satisfies {constraint!r} with finite {by}")
        return self.cells[int(np.argmax(score))]

    def compare(self, by: str = "savings_pct",
                constraint: Union[None, str, Sequence[str]] = None,
                ascending: bool = False) -> "StudyResult":
        """The grid ranked by a metric (optionally pre-filtered) — NaNs
        last. ``res.compare().to_markdown()`` is the league table."""
        sub = self.where(constraint) if constraint is not None else self
        col = sub.column(_metric_name(by))
        key = np.where(np.isfinite(col), col, -np.inf if not ascending
                       else np.inf)
        order = np.argsort(key, kind="stable")
        if not ascending:
            order = order[::-1]
        return StudyResult([sub.cells[int(i)] for i in order])

    def pareto(self, x: str = "throughput_jobs_per_h",
               y: str = "savings_pct",
               include_offline: bool = False) -> "StudyResult":
        """The non-dominated frontier maximizing both metrics, sorted by
        falling ``x``. A cell is dropped when another cell is >= on both
        metrics and strictly better on one; NaN cells never make the front.
        Offline cells are excluded unless ``include_offline``."""
        xs = self.column(_metric_name(x))
        ys = self.column(_metric_name(y))
        ok = np.isfinite(xs) & np.isfinite(ys)
        if not include_offline:
            ok &= np.array([not getattr(c.detail, "offline", False)
                            for c in self.cells], dtype=bool)
        keep = []
        for i in range(len(self.cells)):
            if not ok[i]:
                continue
            dominated = np.any(
                ok & (xs >= xs[i]) & (ys >= ys[i])
                & ((xs > xs[i]) | (ys > ys[i])))
            if not dominated:
                keep.append(i)
        keep.sort(key=lambda i: (-xs[i], -ys[i]))
        return StudyResult([self.cells[i] for i in keep])

    # ------------------------------------------------------------ resampling
    def confidence(self, stat: str = "savings_pct", *, n_boot: int = 1000,
                   method: str = "bootstrap", alpha: float = 0.05,
                   seed: int = 0) -> List[ConfidenceInterval]:
        """Per-cell error bars for ``stat``, resampled over *jobs* — one
        :class:`ConfidenceInterval` per cell, aligned with ``self.cells``.

        Because the projection engine is linear in per-job modal energies,
        a resample's statistic is exactly the ratio of resampled per-job
        sums (:func:`_job_contributions`), so the bootstrap never re-runs
        the engine: ``method="bootstrap"`` draws ``n_boot`` multinomial
        job-count vectors on the host (``np.random.default_rng(seed)``, one
        draw per cell in cell order), copies them once to the
        contributions' device as float64, forms the resampled sums as
        ``counts @ num`` there and reports the percentile interval at level
        ``1 - alpha`` (``torch.quantile``, linear interpolation);
        ``method="jackknife"`` reports the leave-one-out
        normal-approximation interval, on the device. Cap schedules stay
        fixed at the full-population choice (the interval is conditional on
        the schedule). Cells without per-job structure (flat power
        tensors, bare energies, a stat the cell doesn't resample) come back
        with ``n=0`` and a ``(nan, nan)`` interval around the point value.
        """
        name = _metric_name(stat)
        if method not in ("bootstrap", "jackknife"):
            raise ValueError(f"method must be 'bootstrap' or 'jackknife', "
                             f"got {method!r}")
        rng = np.random.default_rng(seed)
        z = NormalDist().inv_cdf(1.0 - alpha / 2.0)
        out: List[ConfidenceInterval] = []
        for c in self.cells:
            contrib = _job_contributions(c, name)
            if contrib is None or not len(contrib[0]):
                out.append(ConfidenceInterval(
                    name, float(getattr(c, name)), float("nan"),
                    float("nan"), method, 0))
                continue
            num, den, scale = contrib
            n = len(num)
            tot_n = float(num.sum())
            den_sum = None if den is None else float(den.sum())
            value = scale * tot_n if den is None else scale * tot_n / den_sum
            if method == "bootstrap":
                counts = torch.from_numpy(rng.multinomial(
                    n, np.full(n, 1.0 / n), size=n_boot
                ).astype(np.float64)).to(num.device)
                stats = scale * (counts @ num)
                if den is not None:
                    stats = stats / (counts @ den)
                q = torch.tensor([alpha / 2.0, 1.0 - alpha / 2.0],
                                 dtype=torch.float64, device=num.device)
                lo, hi = torch.quantile(stats, q).tolist()
            else:
                theta = scale * (tot_n - num)         # leave-one-out stats
                if den is not None:
                    theta = theta / (den_sum - den)
                se = float(torch.sqrt(
                    (n - 1) / n * torch.sum((theta - theta.mean()) ** 2)))
                lo, hi = value - z * se, value + z * se
            out.append(ConfidenceInterval(name, value, float(lo), float(hi),
                                          method, n))
        return out

    # ----------------------------------------------------------- pivot views
    def pivot(self, rows: str = "cap", cols: str = "chip",
              value: str = "savings_pct"
              ) -> Tuple[List[str], List[str], np.ndarray]:
        """The grid as (row labels, col labels, value matrix); cells the
        grid lacks are NaN. Raises when a (row, col) pair is ambiguous —
        ``filter()`` the other axes down first."""
        rlab = self.column(rows) if rows in _INDEX or rows == "cap" \
            else [f"{v:g}" for v in self.column(rows)]
        clab = self.column(cols) if cols in _INDEX or cols == "cap" \
            else [f"{v:g}" for v in self.column(cols)]
        vals = self.column(_metric_name(value))
        rkeys = list(dict.fromkeys(rlab))
        ckeys = list(dict.fromkeys(clab))
        mat = np.full((len(rkeys), len(ckeys)), np.nan)
        seen = set()
        for r, c, v in zip(rlab, clab, vals):
            ij = (rkeys.index(r), ckeys.index(c))
            if ij in seen:
                raise ValueError(
                    f"pivot({rows!r}, {cols!r}) is ambiguous: more than one "
                    f"cell at ({r}, {c}); filter() the other axes first")
            seen.add(ij)
            mat[ij] = v
        return rkeys, ckeys, mat

    def to_markdown(self, rows: Optional[str] = None,
                    cols: Optional[str] = None,
                    value: str = "savings_pct") -> str:
        """GitHub-flavored markdown: a pivot table when ``rows``/``cols``
        are given, otherwise the flat per-cell table."""
        if rows is not None or cols is not None:
            rkeys, ckeys, mat = self.pivot(rows or "cap", cols or "chip",
                                           value)
            head = [f"{rows or 'cap'} \\ {cols or 'chip'}", *ckeys]
            lines = ["| " + " | ".join(head) + " |",
                     "|" + "|".join("---" for _ in head) + "|"]
            for i, r in enumerate(rkeys):
                cells = ["-" if not np.isfinite(v) else f"{v:.2f}"
                         for v in mat[i]]
                lines.append("| " + " | ".join([r, *cells]) + " |")
            return "\n".join(lines)
        head = ["workload", "chip", "policy", "cap", "cell", "savings%",
                "dT%", "saved MWh"]
        lines = ["| " + " | ".join(head) + " |",
                 "|" + "|".join("---" for _ in head) + "|"]
        for c in self.cells:
            lines.append(
                "| " + " | ".join([
                    c.workload, c.chip, c.policy, cap_label(c.cap), c.cell,
                    f"{c.savings_pct:.2f}", f"{c.dt_pct:.2f}",
                    f"{c.savings_mwh:.3f}"]) + " |")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.to_markdown()


# ---------------------------------------------------------------------------
# Study — axes -> grid -> batched execution
# ---------------------------------------------------------------------------
def _aslist(name: str, x) -> list:
    if x is None:
        return [None]
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        if not len(x):
            raise ValueError(
                f"Study {name} axis is empty — a filtered-away axis would "
                f"silently evaluate as [{name}=None]; pass at least one "
                f"value (or omit the axis)")
        return list(x)
    return [x]


def _is_policy_spec(x) -> bool:
    """True for the (name, knobs) tuple spelling of one policy — a tuple
    axis value, not a tuple-as-axis."""
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            and isinstance(x[1], dict))


def _policy_key(policy) -> Any:
    """Grouping key for a resolved policy: value-based for the hashable
    built-ins (two cells naming "energy-aware" share one replay pass),
    identity for unhashable third-party policies."""
    try:
        hash(policy)
    except TypeError:
        return id(policy)
    return policy


class Study:
    """A declarative what-if grid: axes (LISTS per dimension) expanded into
    the cartesian product workload x chip x policy x cap, executed batched
    (see the module docstring). ``caps`` axis values are single caps
    (projection cells), cap TUPLES or ``None`` (per-class schedule cells),
    composing with the ``policies`` axis into replay cells.

    Where a tuple already means something on its own it is ONE axis value,
    not an axis: ``caps=(1300, 900)`` is a single schedule cell
    (``caps=[1300, 900]`` is two projection cells) and
    ``policies=("power-cap", {"cap_w": 400})`` is one policy spec. An
    explicitly empty axis raises rather than silently evaluating a
    ``None`` cell.

    ``metrics`` is the objective axis: each value names a
    :data:`repro_torch.power.objectives` registry entry. Cells drive
    schedule cells' per-class cap choice through its ``cap_score`` and
    report the metric-equivalent savings as the ``objective_pct`` column;
    projection passes are shared across metrics.

    ``brokers`` / ``budgets_mw`` are the online axes: each combination is
    one event-driven :func:`~repro_torch.power.broker.simulate_cluster` run
    of the workload's :meth:`~Workload.cluster_trace` (built once per
    workload) on an ``n_nodes`` pool; a ``caps`` number/tuple then sets
    the cap *menu* instead of spawning projection cells. Broker cells
    evaluate on the workload's own chip and are a different cell shape
    from replays, so ``brokers`` and ``policies`` axes are mutually
    exclusive (a policy can still be an axis *value* of ``brokers`` — it
    rides along as a :class:`~repro_torch.power.broker.PolicyBroker`).

    ``executor`` / ``devices`` are execution knobs, not grid axes: replay
    cells run their per-shard infer / decide pass through a
    :class:`repro_torch.parallel.ShardedExecutor` (the plain path's bits on
    the executor's device); ``devices=N`` is shorthand for
    ``ShardedExecutor(devices=N)``.

    Pass ``scenarios=[Scenario(...), ...]`` instead of axes for a
    non-cartesian grid.
    """

    def __init__(self, workloads=None, chips=None, policies=None, caps=None,
                 kind: str = "freq", tables: TablesLike = "auto",
                 brokers=None, budgets_mw=None, n_nodes: int = 10_000,
                 scenarios: Optional[Sequence[Scenario]] = None,
                 executor=None, devices=None, metrics=None):
        if executor is None and devices is not None:
            from repro_torch.parallel.executor import ShardedExecutor
            executor = ShardedExecutor(devices=devices)
        self._executor = executor
        if scenarios is not None:
            if workloads is not None or chips is not None \
                    or policies is not None or caps is not None \
                    or brokers is not None or budgets_mw is not None \
                    or metrics is not None \
                    or kind != "freq" or tables != "auto":
                raise ValueError(
                    "pass either axes or scenarios=, not both — with "
                    "scenarios= each Scenario carries its own kind/tables/"
                    "objective")
            self._scenarios = list(scenarios)
            return
        if workloads is None:
            raise ValueError("Study needs at least a workloads axis")
        if kind not in ("freq", "power"):
            raise ValueError(f"kind must be 'freq' or 'power', got {kind!r}")
        if brokers is not None or budgets_mw is not None:
            if policies is not None:
                raise ValueError(
                    "brokers and policies are different cell shapes — run "
                    "two studies, or pass a policy as a brokers= value "
                    "(it becomes a PolicyBroker)")
            if chips is not None:
                raise ValueError(
                    "broker cells evaluate on the workload's own chip "
                    "(the trace was recorded there); drop the chips axis")
        # axes are LISTS; a tuple is a single axis VALUE wherever a tuple
        # already means something on its own — a cap schedule, a
        # (name, knobs) policy spec
        if isinstance(caps, np.ndarray):       # an array is a cap sweep,
            caps = caps.tolist()               # i.e. an axis of numbers
        caps_axis = [caps] if _is_number(caps) or isinstance(caps, tuple) \
            else _aslist("caps", caps)
        pol_axis = [policies] if _is_policy_spec(policies) \
            else _aslist("policies", policies)
        brk_axis = [brokers] if _is_policy_spec(brokers) \
            else _aslist("brokers", brokers)
        if isinstance(budgets_mw, np.ndarray):
            budgets_mw = budgets_mw.tolist()
        bud_axis = _aslist("budgets_mw", budgets_mw)
        # the metrics axis: each value is an objectives-registry name; the
        # default (no axis) is the energy objective
        met_axis = ["energy" if m is None else check_objective(m)
                    for m in _aslist("metrics", metrics)]
        self._scenarios = [
            Scenario(workload=w, chip=ch, policy=p, cap=c, kind=kind,
                     tables=tables, broker=b, budget_mw=bud,
                     n_nodes=n_nodes, objective=m)
            for w in _aslist("workloads", workloads)
            for ch in _aslist("chips", chips)
            for p in pol_axis
            for c in caps_axis
            for b in brk_axis
            for bud in bud_axis
            for m in met_axis]

    def scenarios(self) -> List[Scenario]:
        return list(self._scenarios)

    def __len__(self) -> int:
        return len(self._scenarios)

    # -------------------------------------------------------------- execution
    def run(self) -> StudyResult:
        """Execute the grid batched and return the columnar result.

        Grouping: one cached analysis per workload; one ``project`` pass
        per (workload, tables, kind) group over the union of its caps; one
        ``class_cap_report`` per (workload, tables, kind, objective,
        schedule); one chunked ``replay`` per (workload, policy, chip),
        shared across caps — cells only *read* their slice of the shared
        pass, which is why every cell stays equal to its standalone call.
        """
        cells = self._scenarios
        resolved = [(s, s.resolved_chip(), s.resolved_policy(),
                     s.resolved_tables()) for s in cells]

        def _obj_pct(objective: str, sav: float, dt: float) -> float:
            """The cell's metric-equivalent savings % (cap_score)."""
            return float(get_objective(objective).cap_score(sav, dt))

        # ---- one batched projection pass per (workload, tables, kind)
        proj_groups: Dict[tuple, dict] = {}
        for s, chip, policy, tables in resolved:
            if s.cell != PROJECT:
                continue
            key = (id(s.workload), id(tables), s.kind)
            g = proj_groups.setdefault(
                key, {"workload": s.workload, "tables": tables,
                      "kind": s.kind, "caps": []})
            for c in s.caps_list():
                if c not in g["caps"]:
                    g["caps"].append(c)
        proj_rows: Dict[tuple, Dict[float, ProjectionRow]] = {}
        for key, g in proj_groups.items():
            e_ci, e_mi, e_tot = g["workload"].energies_mwh()
            rows = project(g["caps"], g["kind"], e_ci_mwh=e_ci,
                           e_mi_mwh=e_mi, e_total_mwh=e_tot,
                           tables=g["tables"], device=g["workload"].device)
            proj_rows[key] = {cap: row for cap, row in zip(g["caps"], rows)}

        # ---- one chunked replay per (workload, policy, chip)
        replay_reports: Dict[tuple, Any] = {}
        for s, chip, policy, tables in resolved:
            if s.cell != REPLAY:
                continue
            # the frozen spec itself (not its name) keys the group: two
            # same-named chip variants are two different replays
            key = (id(s.workload), _policy_key(policy), chip)
            if key not in replay_reports:
                from repro_torch.power.stream import replay
                replay_reports[key] = replay(
                    s.workload.stream(), policy, chip=chip,
                    record_chip=s.workload.chip,
                    sample_interval_s=s.workload.sample_interval_s,
                    executor=self._executor)

        out: List[CellResult] = []
        # schedule cells memoize too: cells differing only in axes the
        # report doesn't depend on (e.g. chip under explicit tables) share
        # one class_cap_report pass
        schedule_reports: Dict[tuple, FleetJobsReport] = {}
        for s, chip, policy, tables in resolved:
            base = dict(workload=s.workload.name, chip=chip.name,
                        policy=_policy_label(policy), cap=s.cap,
                        kind=s.kind, tables=_tables_source(tables),
                        label=s.label, metric=s.objective, scenario=s)
            if s.cell == BROKER:
                from repro_torch.power.broker import simulate_cluster
                rep = simulate_cluster(
                    s.workload.cluster_trace(), s.resolved_broker(),
                    s.budget_mw, n_nodes=s.n_nodes, kind=s.kind,
                    caps=s.caps_list(), tables=tables)
                base["policy"] = rep.broker      # the broker names the row
                out.append(CellResult(
                    cell=BROKER, savings_pct=rep.savings_pct,
                    dt_pct=rep.dt_pct, savings_mwh=rep.savings_mwh,
                    total_energy_mwh=rep.baseline_mwh,
                    savings_dt0_pct=float("nan"),
                    model_bias_pct=float("nan"),
                    budget_mw=rep.budget_mw,
                    throughput_jobs_per_h=rep.throughput_jobs_per_h,
                    objective_pct=_obj_pct(s.objective, rep.savings_pct,
                                           rep.dt_pct),
                    detail=rep, **base))
            elif s.cell == PROJECT:
                row = proj_rows[(id(s.workload), id(tables), s.kind)][
                    float(s.cap)]
                if s.objective != row.objective:
                    # annotate a per-cell copy: the projection pass is
                    # shared across the metrics axis
                    row = dataclasses.replace(
                        row, objective=s.objective,
                        objective_pct=_obj_pct(s.objective, row.savings_pct,
                                               row.dt_pct))
                _, _, e_tot = s.workload.energies_mwh()
                out.append(CellResult(
                    cell=PROJECT, savings_pct=row.savings_pct,
                    dt_pct=row.dt_pct, savings_mwh=row.total_mwh,
                    total_energy_mwh=e_tot,
                    savings_dt0_pct=row.savings_dt0_pct,
                    model_bias_pct=float("nan"),
                    objective_pct=row.objective_pct, detail=row, **base))
            elif s.cell == SCHEDULE:
                skey = (id(s.workload), id(tables), s.kind, s.objective,
                        None if s.cap is None else tuple(s.caps_list()))
                if skey not in schedule_reports:
                    schedule_reports[skey] = s.workload.fleet().job_report(
                        s.caps_list(), s.kind, tables=tables,
                        objective=s.objective)
                rep: FleetJobsReport = schedule_reports[skey]
                e_tot = rep.total_energy_mwh
                w_dt = sum(c.dt_pct * c.energy_mwh for c in rep.classes)
                dt_pct = w_dt / max(e_tot, 1e-12)
                out.append(CellResult(
                    cell=SCHEDULE, savings_pct=rep.savings_pct,
                    dt_pct=dt_pct,
                    savings_mwh=rep.total_savings_mwh,
                    total_energy_mwh=e_tot,
                    savings_dt0_pct=100.0 * rep.dt0_savings_mwh
                    / max(e_tot, 1e-12),
                    model_bias_pct=float("nan"),
                    objective_pct=_obj_pct(s.objective, rep.savings_pct,
                                           dt_pct),
                    detail=rep, **base))
            else:
                rep = replay_reports[(id(s.workload), _policy_key(policy),
                                      chip)]
                projection = None
                if s.cap is not None:
                    projection = rep.project(s.caps_list(), s.kind,
                                             tables=tables,
                                             objective=s.objective)
                out.append(CellResult(
                    cell=REPLAY, savings_pct=rep.savings_pct,
                    dt_pct=rep.dt_pct,
                    savings_mwh=(rep.energy_base_j - rep.energy_new_j)
                    / 3.6e9,
                    total_energy_mwh=rep.energy_base_j / 3.6e9,
                    savings_dt0_pct=float("nan"),
                    model_bias_pct=rep.model_bias_pct,
                    objective_pct=_obj_pct(s.objective, rep.savings_pct,
                                           rep.dt_pct),
                    detail=rep, projection=projection, **base))
        return StudyResult(out)
