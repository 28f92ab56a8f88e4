"""Joint (config, frequency) energy tuner — fastest is not lowest-energy.

Classic autotuners pick the fastest configuration at nominal clocks; DVFS
governors pick the best frequency for a fixed kernel. The paper's point
(and the DVFS literature's: Calore et al., Patrou et al.) is that the two
choices interact — the energy-optimal *cell* of the joint (config, freq)
grid is generally neither the fastest config nor at nominal frequency.
:func:`tune` measures the whole grid once (any harness backend) and
:meth:`TuningResult.best` selects under any
:class:`~repro_torch.power.objectives.Objective` via
:func:`~repro_torch.power.objectives.grid_argbest` — including the unregistered
:data:`STEP_TIME` pseudo-objective for the classic fastest-config pick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch import f64

from repro_torch.power.objectives import Objective, get_objective, grid_argbest
from repro_torch.tuning.harness import (DEFAULT_N_FREQS, Measurement,
                                  SimulatedBackend, default_freq_fracs)
from repro_torch.tuning.space import Candidate, KernelSpace

#: Pure step time as a selectable objective. Deliberately NOT in
#: :data:`repro_torch.power.objectives.OBJECTIVES` (the sweep registry is
#: pinned by golden tests and a time-"objective" sweep is just the
#: nominal point); grid selection accepts Objective instances directly.
STEP_TIME = Objective(
    "time",
    _score=lambda e, t, p: t,
    _cap_score=lambda sav, dt, tol: -dt,
    doc="pure step time (the classic fastest-config autotuner pick)")

ObjectiveLike = Union[str, Objective]


def _resolve_objective(objective: ObjectiveLike) -> Objective:
    if isinstance(objective, str) and objective == STEP_TIME.name:
        return STEP_TIME
    return get_objective(objective, what="tuning objective")


@dataclass(frozen=True)
class TunedCell:
    """One selected cell of the joint (config, freq) grid."""

    objective: str
    candidate: Candidate
    freq_frac: float
    freq_mhz: int
    time_s: float
    power_w: float
    energy_j: float
    index: Tuple[int, int]              # (candidate row, freq column)

    @property
    def config(self):
        return self.candidate.config

    def __repr__(self) -> str:
        return (f"TunedCell({self.objective!r}, "
                f"{self.candidate.label}, f={self.freq_frac:.3f} "
                f"({self.freq_mhz} MHz), t={self.time_s:.3e}s, "
                f"e={self.energy_j:.3e}J)")


@dataclass(frozen=True)
class TuningResult:
    """A measured joint grid plus objective-aware selection over it."""

    space: KernelSpace
    measurement: Measurement

    @property
    def kernel(self) -> str:
        return self.measurement.kernel

    @property
    def candidates(self) -> Tuple[Candidate, ...]:
        return self.measurement.candidates

    def cell(self, i: int, j: int, objective: str = "cell") -> TunedCell:
        m = self.measurement
        f = float(m.freq_fracs[j])
        return TunedCell(
            objective=objective, candidate=m.candidates[i],
            freq_frac=f,
            freq_mhz=int(round(f * m.chip.f_nominal_mhz)),
            time_s=float(m.time_s[i, j]), power_w=float(m.power_w[i, j]),
            energy_j=float(m.time_s[i, j] * m.power_w[i, j]),
            index=(i, j))

    def best(self, objective: ObjectiveLike = "energy",
             slowdown_budget: Optional[float] = None) -> TunedCell:
        """The grid argbest under ``objective`` (any registry name, an
        :class:`Objective`, or ``"time"`` for the classic fastest pick).

        ``slowdown_budget`` bounds admissible cells relative to the
        fastest cell of the whole grid: ``time <= t_best * (1 +
        budget)`` — the joint-grid analogue of the governor's
        slowdown-budget constraint."""
        obj = _resolve_objective(objective)
        m = self.measurement
        e = m.energy_j
        mask = None
        if slowdown_budget is not None:
            t_best = float(m.time_s.min())
            mask = m.time_s <= t_best * (1.0 + slowdown_budget) \
                * (1.0 + 1e-9)
        i, j = grid_argbest(obj, e, m.time_s,
                            m.power_w if obj.needs_power else None,
                            mask=mask, what="tuning objective")
        return self.cell(i, j, objective=obj.name)

    def summary(self, objectives: Sequence[ObjectiveLike] = ("time",
                                                             "energy"),
                slowdown_budget: Optional[float] = None) -> str:
        """A small markdown table of the selected cell per objective."""
        lines = ["| objective | config | freq MHz | time s | power W "
                 "| energy J |",
                 "|---|---|---|---|---|---|"]
        for o in objectives:
            c = self.best(o, slowdown_budget=slowdown_budget)
            lines.append(
                f"| {c.objective} | {c.candidate.label} | {c.freq_mhz} "
                f"| {c.time_s:.3e} | {c.power_w:.1f} "
                f"| {c.energy_j:.3e} |")
        return "\n".join(lines)

    def __repr__(self) -> str:
        n, f = self.measurement.shape
        return (f"TuningResult({self.kernel!r}, {n} candidates x "
                f"{f} freqs, source={self.measurement.source!r})")


def tune(space: KernelSpace, backend=None,
         freq_fracs: Optional[Sequence[float]] = None,
         n_freqs: int = DEFAULT_N_FREQS,
         validate: bool = True) -> TuningResult:
    """Autotune one kernel space over the joint (config, freq) grid.

    Enumerates and prunes the space, validates every surviving candidate
    against :mod:`repro_torch.kernels.ref` on the space's device (``validate=False``
    skips it — e.g. the analytic resolver pipeline), then measures the
    whole grid in one backend pass (default: the hermetic
    :class:`~repro_torch.tuning.harness.SimulatedBackend` on the space's chip
    and device).
    """
    if backend is None:
        backend = SimulatedBackend(space.chip, device=space.device)
    if freq_fracs is None:
        freq_fracs = default_freq_fracs(backend.chip, n_freqs,
                                        device=backend.device)
    meas = backend.measure(space, freq_fracs=f64(freq_fracs, backend.device),
                           validate=validate)
    return TuningResult(space=space, measurement=meas)
