"""Optimization objectives as first-class, registry-backed citizens.

The paper's 8.5% / 1438 MWh headline is derived under ONE objective —
energy at bounded slowdown — but the power-capping metric study
(arXiv:2505.21758) and the DVFS evaluation survey (arXiv:1703.02788)
both treat the objective itself as an axis: EDP, ED²P and perf-per-watt
pick materially different operating points on the same response tables.
This module is the single source of truth for that axis.

An :class:`Objective` scores an operating point in two complementary
spaces:

* **grid score** — ``obj.score(energy_j, time_s, power_w)`` on sweep
  grids: python floats and tensors both work, and the sweep machinery
  always *minimizes* it. ``energy`` scores ``e``, ``edp`` ``e*t``,
  ``ed2p`` ``e*t*t``, ``perf_per_watt`` ``t*power`` (minimizing ``t*P``
  == maximizing work/(time*power)), ``dt_bounded_savings`` scores ``e`` —
  its dT bound IS the sweep's slowdown-budget constraint;
* **cap score** — ``obj.cap_score(savings_pct, dt_pct)`` on projection
  rows, always *maximized*: the metric-equivalent savings percentage. For
  ``energy`` it is the energy savings itself, for ``edp`` / ``ed2p`` the
  EDP/ED²P savings implied by the row's (energy, runtime) response, for
  ``perf_per_watt`` it reduces to energy savings, and
  ``dt_bounded_savings`` masks rows whose slowdown exceeds the tolerance
  to ``-inf`` (the paper's "no performance compromise" criterion).

:func:`get_objective` / :func:`check_objective` are the one validator every
layer shares. :func:`decision_grid` is the batched evaluator: one
(profiles, freqs) transfer-surface pass shared across a whole
objectives × power-caps menu, each cell equal to the standalone
``sweep_decisions`` call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import device_of, f64

__all__ = [
    "Objective", "OBJECTIVES", "SWEEP_OBJECTIVES", "GridDecisions",
    "get_objective", "check_objective", "decision_grid", "grid_argbest",
]

#: Default dT tolerance (percent) for the ``dt_bounded_savings`` cap
#: score — the paper's "no performance compromise" criterion.
DT0_TOL_PCT = 0.5


@dataclass(frozen=True)
class Objective:
    """One optimization objective, usable on every layer of the stack.

    ``_score(e, t, p)`` must be pure arithmetic on its arguments so the
    same callable serves python scalars (``governor.sweep_decision``) and
    tensors (``surface.sweep_decisions``) with identical floating-point
    rounding. ``_cap_score(sav, dt, tol)`` is the projection-row view.
    """

    name: str
    _score: Callable[[Any, Any, Any], Any]
    _cap_score: Callable[[Any, Any, float], Any]
    #: grid score reads power_w (only ``perf_per_watt`` does) — lets hot
    #: sweep loops skip the power evaluation for the objectives that
    #: never look at it
    needs_power: bool = False
    #: the human-facing sense: every *score* is minimized, but
    #: perf-per-watt is conventionally reported as a maximized value
    #: (``value() == 1/score`` there)
    sense: str = "min"
    doc: str = ""

    def __post_init__(self):
        if self.sense not in ("min", "max"):
            raise ValueError(f"sense must be 'min' or 'max', "
                             f"got {self.sense!r}")

    # ------------------------------------------------------------ grid side
    def score(self, energy_j, time_s, power_w=None):
        """The minimized sweep-grid score at an operating point.

        Works elementwise on broadcastable tensors (or scalars).
        ``power_w`` may be omitted unless :attr:`needs_power`.
        """
        if self.needs_power and power_w is None:
            raise ValueError(
                f"objective {self.name!r} scores power — pass power_w")
        return self._score(energy_j, time_s, power_w)

    def value(self, energy_j, time_s, power_w=None):
        """The human-facing objective value: the score for minimized
        objectives, its reciprocal for maximized ones (perf-per-watt in
        work/(s*W) units)."""
        s = self.score(energy_j, time_s, power_w)
        return 1.0 / s if self.sense == "max" else s

    # ------------------------------------------------------------- cap side
    def cap_score(self, savings_pct, dt_pct, *,
                  dt_tol_pct: float = DT0_TOL_PCT):
        """The maximized projection-row score: metric-equivalent savings
        (percent) of a cap whose response is (energy savings ``sav``%,
        slowdown ``dt``%). ``objective="energy"`` returns ``savings_pct``
        unchanged."""
        return self._cap_score(savings_pct, dt_pct, dt_tol_pct)

    def __repr__(self) -> str:  # keep policy reprs short
        return f"Objective({self.name!r})"


def _edp_cap(sav, dt, _tol):
    # EDP_rel = energy_rel * runtime_rel; savings% = 100*(1 - EDP_rel)
    return 100.0 * (1.0 - (1.0 - sav / 100.0) * (1.0 + dt / 100.0))


def _ed2p_cap(sav, dt, _tol):
    return 100.0 * (1.0 - (1.0 - sav / 100.0) * (1.0 + dt / 100.0) ** 2)


def _dt_bounded_cap(sav, dt, tol):
    dt = f64(dt, device_of(dt, sav) or "cpu")
    sav = f64(sav, dt.device)
    return torch.where(dt <= tol, sav, -float("inf"))


#: The registry: name -> :class:`Objective`. Insertion order is the
#: public listing order (error messages, ``SWEEP_OBJECTIVES``).
OBJECTIVES: Dict[str, Objective] = {o.name: o for o in (
    Objective(
        "energy",
        _score=lambda e, t, p: e,
        _cap_score=lambda sav, dt, tol: sav,
        doc="energy per step (the paper's governor objective)"),
    Objective(
        "edp",
        _score=lambda e, t, p: e * t,
        _cap_score=_edp_cap,
        doc="energy-delay product"),
    Objective(
        "ed2p",
        _score=lambda e, t, p: e * t * t,
        _cap_score=_ed2p_cap,
        doc="energy-delay-squared product"),
    Objective(
        "perf_per_watt",
        _score=lambda e, t, p: t * p,
        _cap_score=lambda sav, dt, tol: sav,
        needs_power=True, sense="max",
        doc="performance per watt (work / (time * power), maximized)"),
    Objective(
        "dt_bounded_savings",
        _score=lambda e, t, p: e,
        _cap_score=_dt_bounded_cap,
        doc="energy savings subject to the dT<=tol no-compromise bound"),
)}

#: Every objective a frequency sweep accepts.
SWEEP_OBJECTIVES: tuple = tuple(OBJECTIVES)

ObjectiveLike = Union[str, Objective]


def get_objective(objective: ObjectiveLike, *,
                  what: str = "objective") -> Objective:
    """Resolve a name (or pass through an :class:`Objective`), raising
    the one shared ``ValueError``."""
    if isinstance(objective, Objective):
        return objective
    obj = OBJECTIVES.get(objective)
    if obj is None:
        raise ValueError(
            f"unknown {what} {objective!r}; known: {SWEEP_OBJECTIVES}")
    return obj


def check_objective(objective: ObjectiveLike, *,
                    what: str = "objective") -> str:
    """Validate and canonicalize to the registry name."""
    return get_objective(objective, what=what).name


def grid_argbest(objective: ObjectiveLike, energy_j, time_s, power_w=None,
                 mask=None, *, what: str = "objective",
                 device=None) -> Tuple[int, ...]:
    """Index of the best cell of a dense operating-point grid under an
    objective — the selection primitive behind the joint (config, freq)
    kernel tuner (:meth:`repro_torch.tuning.TuningResult.best`).

    ``energy_j`` / ``time_s`` / ``power_w`` broadcast to one grid; the
    objective's (minimized) score is evaluated elementwise and the argmin
    (first one on ties) returned as an unraveled index tuple. ``mask``
    (broadcastable bool, True = admissible) excludes cells — e.g. a
    slowdown-budget constraint; if no admissible cell has a finite score,
    raises ``ValueError``. Unregistered :class:`Objective` instances pass
    through, so callers can select on ad-hoc scores (pure step time)
    without touching the registry. Tensors are scored where they lie;
    ``device`` places plain python/numpy grids.
    """
    obj = get_objective(objective, what=what)
    if device is None:
        device = device_of(energy_j, time_s, power_w)
    e, t = torch.broadcast_tensors(f64(energy_j, device), f64(time_s, device))
    p = None
    if power_w is not None:
        e, t, p = torch.broadcast_tensors(e, t, f64(power_w, e.device))
    s = f64(obj.score(e, t, p), e.device)
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.bool, device=s.device)
        s = torch.where(torch.broadcast_to(m, s.shape), s, float("inf"))
    if s.numel() == 0 or not bool(torch.isfinite(s).any()):
        raise ValueError(
            f"no grid cell is admissible under objective {obj.name!r}"
            + ("" if mask is None else " with the given constraint mask"))
    flat = int(torch.argmin(s.reshape(-1)))
    return tuple(int(i) for i in torch.unravel_index(
        torch.tensor(flat), s.shape))


# ---------------------------------------------------------------------------
# Batched evaluation over an objectives x power-caps menu
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GridDecisions:
    """Sweep decisions over a (objectives, power_caps, *profiles) menu —
    the batched counterpart of nested ``surface.sweep_decisions`` calls.

    Tensors are shaped ``(n_objectives, n_caps, *profile_shape)``; cell
    ``[m, c]`` equals ``sweep_decisions(profiles, objective=objectives[m],
    power_cap_w=power_caps[c], ...)``.
    """

    objectives: Tuple[str, ...]
    power_caps: Tuple[Optional[float], ...]
    freq_frac: torch.Tensor
    freq_mhz: torch.Tensor
    time_s: torch.Tensor
    power_w: torch.Tensor
    energy_j: torch.Tensor
    baseline_energy_j: torch.Tensor

    @property
    def savings_pct(self) -> torch.Tensor:
        return 100.0 * (1.0 - self.energy_j / self.baseline_energy_j)

    def objective_value(self) -> torch.Tensor:
        """Each cell's human-facing objective value (its own metric)."""
        return torch.stack([
            get_objective(m).value(
                self.energy_j[i], self.time_s[i], self.power_w[i])
            for i, m in enumerate(self.objectives)])


def decision_grid(surface, profiles, *,
                  objectives: Sequence[ObjectiveLike] = ("energy",),
                  power_caps: Sequence[Optional[float]] = (None,),
                  slowdown_budget: float = 0.0,
                  n_freqs: int = 11) -> GridDecisions:
    """Evaluate a whole objectives x power-caps sweep menu in ONE
    transfer-surface pass (on the surface's device).

    The per-frequency ``step_time`` / ``energy_j`` / ``power_w``
    evaluations — the expensive part — are computed once and shared by
    every (objective, cap) cell; only the cheap score/accept lattice is
    per-cell. Each cell reproduces the standalone
    :meth:`~repro_torch.power.surface.TransferSurface.sweep_decisions`
    call (same 1e-12 hysteresis, same sequential accept order, same pow
    path).
    """
    from repro_torch.power.surface import ProfileArray  # import cycle
    objs = [get_objective(o, what="sweep objective") for o in objectives]
    caps = [None if c is None else float(c) for c in power_caps]
    p = ProfileArray.coerce(profiles, surface.device)
    t0 = surface.step_time(p, 1.0)
    e0 = surface.energy_j(p, 1.0)
    budget = t0 * (1.0 + slowdown_budget)
    pw0 = surface.power_w(p, 1.0)

    # the whole (objective, cap) lattice as stacked (M, C, *shape) tensors:
    # each objective's score is computed once per frequency, the accept
    # rule runs as ONE broadcast compare/where over the menu, and the
    # winning (t, pw, e) are carried along so nothing is re-evaluated at
    # the chosen clocks
    shape = (len(objs), len(caps)) + tuple(t0.shape)
    bf = torch.broadcast_to(torch.ones_like(t0), shape)
    bt = torch.broadcast_to(t0, shape)
    be = torch.broadcast_to(e0, shape)
    bpw = torch.broadcast_to(pw0, shape)
    bs = torch.broadcast_to(
        torch.stack([o.score(e0, t0, pw0) for o in objs])[:, None], shape)
    for f in surface.chip.freq_grid(n_freqs):
        t = surface.step_time(p, f)
        e = surface.energy_j(p, f)
        pw = surface.power_w(p, f)
        t_ok = t <= budget * (1.0 + 1e-9)
        ok_c = torch.stack([t_ok if cap is None else (t_ok & (pw <= cap))
                            for cap in caps])               # (C, *shape)
        s = torch.stack([o.score(e, t, pw) for o in objs])[:, None]
        ok = (s < bs - 1e-12) & ok_c[None]                  # (M, C, *shape)
        bf = torch.where(ok, f, bf)
        bt = torch.where(ok, t, bt)
        be = torch.where(ok, e, be)
        bpw = torch.where(ok, pw, bpw)
        bs = torch.where(ok, s, bs)
    mhz = torch.round(bf * surface.spec.f_nominal_mhz).to(torch.int64)
    return GridDecisions(
        objectives=tuple(o.name for o in objs), power_caps=tuple(caps),
        freq_frac=bf, freq_mhz=mhz,
        time_s=bt, power_w=bpw, energy_j=be,
        baseline_energy_j=torch.broadcast_to(e0, shape))
