"""Fleet-scale energy-savings projection (paper §V-C, Tables V & VI).

The decoded formula: for cap ``c`` and mode ``m``,

    savings_m(c) [MWh] = E_m * (1 - energy_used_pct(c, m) / 100)

with the C.I. mode driven by the VAI response column and the M.I. mode by
the MB (memory-bandwidth) column of Table III. Two further decoded
aggregation rules (each over-determined by the published cells):

* ``dT`` (runtime increase) = DT_WEIGHT_CI * (runtime_pct_CI - 100);
  fitting all 9 published dT cells gives DT_WEIGHT_CI = 0.1355 +- 0.002.
* ``savings @ dT=0`` = savings of the modes whose runtime is unaffected
  (runtime_pct <= 100.5 — in practice the M.I. mode), matching all
  published sav0 cells to <=0.3 %.

Modes 1 (latency-bound) and 4 (boost) are never projected — the paper finds
no savings opportunity in mode 1 and has no benchmark coverage above TDP.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch import DEFAULT_DEVICE, device_of, f64
from repro_torch.core import hardware as hw

DT_WEIGHT_CI = 0.1355
RUNTIME_UNAFFECTED_PCT = 100.5
# The fleet-decoded dT weight corresponds to the fleet's C.I. hours share
# (Table IV: 19.5%); dividing it out gives the per-unit-of-C.I.-hours weight
# used to project per-job runtime increase from each job's own mode mix.
DT_WEIGHT_PER_CI_HOUR = DT_WEIGHT_CI / (hw.MODES[2].gpu_hours_pct / 100.0)

ResponseColumn = Mapping[int, Tuple[float, float, float]]


@dataclass(frozen=True)
class ResponseTables:
    """A pair of Table III-style response columns driving one projection:
    the ``vai`` (compute-family) column projects the C.I. mode, the ``mb``
    (memory-family) column the M.I. mode. Each maps ``cap -> (power %,
    runtime %, energy %)`` relative to the uncapped run.

    The built-in instances carry the paper's measured MI250X columns
    (:func:`builtin_tables`); :func:`repro_torch.power.surface.
    response_table` synthesizes model-derived tables for any registered
    chip, enabling cross-chip projections."""

    vai: ResponseColumn
    mb: ResponseColumn
    kind: str = "freq"                   # "freq" (MHz caps) or "power" (W)
    source: str = "mi250x-table-iii"


def check_tables_kind(tables: ResponseTables, kind: str) -> ResponseTables:
    """Response tables are keyed in one cap unit and must match the
    projection's ``kind``."""
    if tables.kind != kind:
        raise ValueError(
            f"response tables are {tables.kind!r}-keyed but the projection "
            f"was asked for kind={kind!r}")
    return tables


def builtin_tables(kind: str = "freq") -> ResponseTables:
    """The paper's measured MI250X Table III columns for ``kind``."""
    if kind == "freq":
        return ResponseTables(hw.FREQ_RESPONSE_VAI, hw.FREQ_RESPONSE_MB,
                              kind="freq")
    if kind == "power":
        return ResponseTables(hw.POWER_RESPONSE_VAI, hw.POWER_RESPONSE_MB,
                              kind="power")
    raise ValueError(f"kind must be 'freq' or 'power', got {kind!r}")


@dataclass
class ProjectionRow:
    cap: float
    ci_mwh: float
    mi_mwh: float
    total_mwh: float
    savings_pct: float
    dt_pct: float
    savings_dt0_pct: float
    # metric-equivalent savings % under the selected objective (equal to
    # savings_pct for objective="energy"); NaN when no objective was
    # evaluated for this row
    objective: str = "energy"
    objective_pct: float = float("nan")

    def to_dict(self) -> Dict:
        return dict(cap=self.cap, ci_mwh=self.ci_mwh, mi_mwh=self.mi_mwh,
                    total_mwh=self.total_mwh, savings_pct=self.savings_pct,
                    dt_pct=self.dt_pct,
                    savings_dt0_pct=self.savings_dt0_pct,
                    objective=self.objective,
                    objective_pct=self.objective_pct)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """Piecewise-linear interpolation of ``fp`` over the increasing knots
    ``xp`` at ``x``, clamped to the end values: on knot interval ``j``,
    ``slope_j * (x - xp[j]) + fp[j]`` with the slope rounded first, and
    exactly ``fp[j]`` on a knot."""
    n = xp.shape[0]
    if n == 1:
        return fp[0].expand(x.shape).clone()
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    y = slope * (x - xp[j]) + fp[j]
    y = torch.where(x == xp[j], fp[j], y)
    y = torch.where(x >= xp[-1], fp[-1], y)
    return torch.where(x <= xp[0], fp[0], y)


def interp_response_batch(table: Mapping[int, Tuple[float, float, float]],
                          caps, device=None) -> torch.Tensor:
    """Vectorized :func:`repro_torch.core.hardware.interp_response`:
    piecewise-linear (power %, runtime %, energy %) columns at each cap,
    clamped to the table's endpoints. Returns shape ``(len(caps), 3)``."""
    caps = f64(caps, device)
    keys = sorted(table)
    xp = f64([float(k) for k in keys], caps.device)
    cols = f64([table[k] for k in keys], caps.device)
    return torch.stack([_interp(caps, xp, cols[:, i]) for i in range(3)],
                       dim=1)


@dataclass
class BatchProjection:
    """Per-job savings projection: every tensor is ``(jobs, caps)``,
    computed as one tensor program over the whole job population."""
    caps: torch.Tensor                   # (caps,)
    kind: str
    ci_mwh: torch.Tensor                 # (jobs, caps)
    mi_mwh: torch.Tensor
    total_mwh: torch.Tensor
    savings_pct: torch.Tensor
    dt_pct: torch.Tensor
    savings_dt0_pct: torch.Tensor

    @property
    def n_jobs(self) -> int:
        return int(self.ci_mwh.shape[0])

    def rows(self, j: int = 0,
             objective: str = "energy") -> List[ProjectionRow]:
        """Row ``j`` as the scalar pipeline's list of ProjectionRows,
        annotated with ``objective``'s metric-equivalent savings %."""
        val = self.objective_value(objective)[j].tolist()
        cols = [x.tolist() for x in (
            self.caps, self.ci_mwh[j], self.mi_mwh[j], self.total_mwh[j],
            self.savings_pct[j], self.dt_pct[j], self.savings_dt0_pct[j])]
        return [ProjectionRow(
            cap=cols[0][c], ci_mwh=cols[1][c], mi_mwh=cols[2][c],
            total_mwh=cols[3][c], savings_pct=cols[4][c], dt_pct=cols[5][c],
            savings_dt0_pct=cols[6][c],
            objective=objective, objective_pct=val[c])
            for c in range(len(cols[0]))]

    def objective_value(self, objective: str = "energy",
                        dt0_only: bool = False) -> torch.Tensor:
        """Metric-equivalent savings % per (job, cap) under ``objective``
        (:meth:`repro_torch.power.objectives.Objective.cap_score`); equals
        ``savings_pct`` (or ``savings_dt0_pct`` with ``dt0_only``) for
        ``objective="energy"``."""
        from repro_torch.power.objectives import get_objective
        base = self.savings_dt0_pct if dt0_only else self.savings_pct
        return get_objective(objective).cap_score(base, self.dt_pct)

    def best_cap(self, dt0_only: bool = False,
                 objective: str = "energy") -> torch.Tensor:
        """Per-job cap maximizing the ``objective``'s metric-equivalent
        savings (raw savings for the default ``"energy"``); with
        ``dt0_only`` the argmax runs over the dT=0-eligible savings column
        instead (the paper's "no performance compromise" criterion)."""
        return self.caps[torch.argmax(
            self.objective_value(objective, dt0_only), dim=1)]


def project_batch(caps, kind: str = "freq",
                  e_ci_mwh=hw.FLEET_ENERGY_CI_MWH,
                  e_mi_mwh=hw.FLEET_ENERGY_MI_MWH,
                  e_total_mwh=hw.TOTAL_FLEET_ENERGY_MWH,
                  dt_weight=DT_WEIGHT_CI,
                  tables: Optional[ResponseTables] = None,
                  device=None) -> BatchProjection:
    """Vectorized projection over per-job modal energies.

    ``e_ci_mwh`` / ``e_mi_mwh`` / ``e_total_mwh`` are ``(jobs,)`` tensors
    (scalars work too and default to the paper's fleet constants, matching
    :func:`project`); ``dt_weight`` is the fleet constant or a ``(jobs,)``
    tensor of per-job C.I.-hours weights
    (``DT_WEIGHT_PER_CI_HOUR * hours_frac(3)``).

    ``tables`` selects the response surface: ``None`` means the paper's
    measured MI250X Table III columns for ``kind``; pass a
    :class:`ResponseTables` (e.g. from
    :func:`repro_torch.power.surface.response_table`) to project another
    chip. With ``device=None`` the projection runs where the energy tensors
    lie, and on the card when they are plain numbers.
    """
    if tables is None:
        tables = builtin_tables(kind)
    else:
        check_tables_kind(tables, kind)
    if device is None:
        device = device_of(e_ci_mwh, e_mi_mwh, e_total_mwh, dt_weight, caps) \
            or DEFAULT_DEVICE
    vai, mb = tables.vai, tables.mb
    caps = f64(caps, device)
    r_ci = interp_response_batch(vai, caps)       # (caps, 3)
    r_mi = interp_response_batch(mb, caps)
    e_ci = torch.atleast_1d(f64(e_ci_mwh, device))[:, None]
    e_mi = torch.atleast_1d(f64(e_mi_mwh, device))[:, None]
    e_tot = torch.atleast_1d(f64(e_total_mwh, device))[:, None]
    w_dt = torch.atleast_1d(f64(dt_weight, device))[:, None]

    s_ci = e_ci * (1.0 - r_ci[None, :, 2] / 100.0)          # (jobs, caps)
    s_mi = e_mi * (1.0 - r_mi[None, :, 2] / 100.0)
    total = s_ci + s_mi
    denom = torch.clamp(e_tot, min=1e-12)
    dt = torch.broadcast_to(w_dt * (r_ci[None, :, 1] - 100.0), total.shape)
    sav0 = (s_mi * (r_mi[None, :, 1] <= RUNTIME_UNAFFECTED_PCT)
            + s_ci * (r_ci[None, :, 1] <= RUNTIME_UNAFFECTED_PCT))
    return BatchProjection(
        caps=caps, kind=kind, ci_mwh=s_ci, mi_mwh=s_mi, total_mwh=total,
        savings_pct=100.0 * total / denom, dt_pct=dt,
        savings_dt0_pct=100.0 * sav0 / denom)


def project(caps: List[float], kind: str = "freq",
            e_ci_mwh: float = hw.FLEET_ENERGY_CI_MWH,
            e_mi_mwh: float = hw.FLEET_ENERGY_MI_MWH,
            e_total_mwh: float = hw.TOTAL_FLEET_ENERGY_MWH,
            tables: Optional[ResponseTables] = None,
            objective: str = "energy",
            device=DEFAULT_DEVICE) -> List[ProjectionRow]:
    """Paper-faithful projection from the measured MI250X response tables
    (or any :class:`ResponseTables` via ``tables=``) — the single-job
    special case of :func:`project_batch`. ``objective`` annotates every
    row with its metric-equivalent savings % (``objective_pct``; equal to
    ``savings_pct`` for the default ``"energy"``)."""
    bp = project_batch(caps, kind, e_ci_mwh=[e_ci_mwh], e_mi_mwh=[e_mi_mwh],
                       e_total_mwh=[e_total_mwh], tables=tables,
                       device=device)
    return bp.rows(0, objective=objective)


def project_from_decomposition(decomp, caps: List[float],
                               kind: str = "freq",
                               tables: Optional[ResponseTables] = None,
                               objective: str = "energy",
                               device=DEFAULT_DEVICE) -> List[ProjectionRow]:
    """Same engine, driven by a measured/synthetic ModalDecomposition
    (mode 2 -> M.I., mode 3 -> C.I.)."""
    return project(caps, kind,
                   e_ci_mwh=decomp.energy_mwh.get(3, 0.0),
                   e_mi_mwh=decomp.energy_mwh.get(2, 0.0),
                   e_total_mwh=decomp.total_energy_mwh, tables=tables,
                   objective=objective, device=device)


def domain_targeted_project(domain_energies: Mapping[str, Tuple[float, float]],
                            caps: List[float], kind: str = "freq",
                            e_total_mwh: float = hw.TOTAL_FLEET_ENERGY_MWH,
                            tables: Optional[ResponseTables] = None,
                            device=DEFAULT_DEVICE
                            ) -> Dict[str, List[ProjectionRow]]:
    """Table VI analogue: apply caps only to selected science domains /
    job-size classes. ``domain_energies``: name -> (E_CI, E_MI) MWh."""
    return {name: project(caps, kind, e_ci_mwh=ci, e_mi_mwh=mi,
                          e_total_mwh=e_total_mwh, tables=tables,
                          device=device)
            for name, (ci, mi) in domain_energies.items()}


def validate_against_paper(kind: str = "freq", tol_mwh: float = 3.0,
                           tol_pct: float = 0.15,
                           device=DEFAULT_DEVICE) -> Dict[str, float]:
    """Reproduce the paper's published Table V; returns max abs errors."""
    table = (hw.PAPER_TABLE_V_FREQ if kind == "freq"
             else hw.PAPER_TABLE_V_POWER)
    caps = sorted(table, reverse=True)
    rows = {r.cap: r for r in project(caps, kind, device=device)}
    errs = {"ci": 0.0, "mi": 0.0, "ts": 0.0, "sav": 0.0, "dt": 0.0,
            "sav0": 0.0}
    for cap, ref in table.items():
        r = rows[cap]
        errs["ci"] = max(errs["ci"], abs(r.ci_mwh - ref["ci"]))
        errs["mi"] = max(errs["mi"], abs(r.mi_mwh - ref["mi"]))
        errs["ts"] = max(errs["ts"], abs(r.total_mwh - ref["ts"]))
        errs["sav"] = max(errs["sav"], abs(r.savings_pct - ref["sav"]))
        errs["dt"] = max(errs["dt"], abs(r.dt_pct - ref["dt"]))
        errs["sav0"] = max(errs["sav0"], abs(r.savings_dt0_pct - ref["sav0"]))
    return errs


#: per-kind bounds on the Table V reproduction errors (the mi/freq bound
#: absorbs one Table-III rounding artifact at the 1100 MHz cell)
TABLE_V_BOUNDS = {
    "freq": {"ci": 1.0, "mi": 8.0, "sav": 0.15, "dt": 0.15, "sav0": 0.15},
    "power": {"ci": 0.2, "mi": 0.2, "sav": 0.05, "dt": 0.1},
}
#: the abstract's headline at the 900 MHz cap: (field, paper value, +-)
HEADLINE_900MHZ = (("mi_mwh", 1438.3, 1.0),
                   ("savings_dt0_pct", 8.5, 0.15),
                   ("savings_pct", 8.8, 0.15))


def validate_main(device=DEFAULT_DEVICE) -> int:
    """Reproduce Table V for both cap kinds, pin the paper's abstract
    headline (8.5% savings at dT=0 == the 1438 MWh M.I. cell at 900 MHz),
    and put a bootstrap 95% interval around the 8.5% from a job-structured
    synthetic fleet on ``device``. Returns 1 on any violation."""
    failures = []
    for kind, tol in TABLE_V_BOUNDS.items():
        errs = validate_against_paper(kind, device=device)
        for key, bound in tol.items():
            status = "ok" if errs[key] < bound else "FAIL"
            print(f"table-v[{kind}] {key:5s} max|err| {errs[key]:7.3f} "
                  f"(< {bound})  {status}")
            if errs[key] >= bound:
                failures.append(f"{kind}:{key}={errs[key]:.3f}")
    head = project([900], "freq", device=device)[0]
    for name, want, tol in HEADLINE_900MHZ:
        got = getattr(head, name)
        status = "ok" if abs(got - want) < tol else "FAIL"
        print(f"headline @900MHz {name:16s} {got:8.2f} "
              f"(paper {want} +- {tol})  {status}")
        if abs(got - want) >= tol:
            failures.append(f"headline:{name}={got:.2f}")
    # error bar on the headline: a job-structured synthetic fleet whose
    # class mix is calibrated to the paper's Table IV energy split, with
    # the savings @ dT=0 statistic resampled over jobs — the 95% bootstrap
    # CI must bracket the pinned 8.5%
    ci = headline_bootstrap_ci(device=device)
    status = "ok" if 8.5 in ci else "FAIL"
    print(f"headline bootstrap 95% CI [{ci.lo:.2f}, {ci.hi:.2f}] "
          f"(point {ci.value:.2f}, n={ci.n} jobs)  brackets 8.5  {status}")
    if 8.5 not in ci:
        failures.append(f"headline:ci=[{ci.lo:.2f},{ci.hi:.2f}]")
    if failures:
        print(f"paper validation FAILED: {', '.join(failures)}")
        return 1
    print("paper validation ok: Table V (freq+power) and the "
          "8.5% / 1438 MWh headline reproduced")
    return 0


def headline_bootstrap_ci(n_jobs: int = 1500, seed: int = 0,
                          n_boot: int = 2000, device=DEFAULT_DEVICE):
    """The third leg of :func:`validate_main`: the savings @ dT=0 at 900
    MHz of ``n_jobs`` synthetic jobs whose class mix follows the paper's
    Table IV energy split, with its bootstrap 95% interval over jobs (a
    :class:`repro_torch.power.scenarios.ConfidenceInterval`)."""
    # function-level imports: the power package imports this module
    from repro_torch.power import Study, Workload
    from repro_torch.power.jobs import HEADLINE_CLASS_MIX
    w = Workload.synthetic_jobs(n_jobs, seed=seed,
                                class_mix=HEADLINE_CLASS_MIX, device=device)
    return Study(workloads=[w], caps=[900.0]).run().confidence(
        "savings_dt0_pct", n_boot=n_boot)[0]
