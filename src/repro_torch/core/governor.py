"""Energy-aware DVFS sweep — the paper's policy as a pure function.

Per step the sweep: (1) classifies the step's mode from its roofline
profile, (2) walks the frequency grid through the power model, (3) picks the
frequency minimizing the objective subject to a slowdown budget. The default
budget dT=0 reproduces the paper's "Energy Sav. (%) dT=0" column semantics:
memory/latency-bound steps clock down for free, compute-bound steps stay at
nominal.

This is the scalar (python float) form, and :class:`PowerGovernor` its
legacy entry point (new code selects the same sweep via
``repro_torch.power.EnergyAwarePolicy`` inside an ``EnergySession``);
:meth:`repro_torch.power.surface.TransferSurface.sweep_decisions` is the
same accept/reject sequence over a tensor batch.

Actuation is behind ``PowerActuator``: ``SimulatedActuator`` records the
requested frequencies and lets the power model supply their consequences
(clocks cannot be set from an unprivileged process on the card's host);
deployments implement ``apply(freq_mhz)`` as their platform call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol

from repro_torch.core.hardware import ChipSpec, H100_SXM, Mode
from repro_torch.core.power_model import ChipModel, StepProfile


class PowerActuator(Protocol):
    def apply(self, freq_mhz: int) -> None: ...
    def current_mhz(self) -> int: ...


class SimulatedActuator:
    """Records requested frequencies and lets the power model supply the
    (time, power) consequences."""

    def __init__(self, chip: ChipSpec = H100_SXM):
        self.chip = chip
        self._freq = chip.f_nominal_mhz
        self.history: List[int] = []

    def apply(self, freq_mhz: int) -> None:
        self._freq = int(freq_mhz)
        self.history.append(self._freq)

    def current_mhz(self) -> int:
        return self._freq


@dataclass(frozen=True)
class GovernorConfig:
    slowdown_budget: float = 0.0        # dT budget (0 = paper's dT=0 column)
    n_freqs: int = 11                   # frequency grid resolution
    power_cap_w: Optional[float] = None

    def __post_init__(self):
        if self.n_freqs < 1:
            raise ValueError(f"n_freqs must be >= 1, got {self.n_freqs}")


@dataclass
class Decision:
    freq_mhz: int
    freq_frac: float
    mode: Mode
    time_s: float
    power_w: float
    energy_j: float
    baseline_energy_j: float

    @property
    def savings_pct(self) -> float:
        return 100.0 * (1.0 - self.energy_j
                        / max(self.baseline_energy_j, 1e-12))


def __getattr__(name: str):
    # lazy re-export: the objective registry lives in
    # ``repro_torch.power.objectives`` (single source of truth)
    if name == "SWEEP_OBJECTIVES":
        from repro_torch.power.objectives import SWEEP_OBJECTIVES
        return SWEEP_OBJECTIVES
    raise AttributeError(name)


def sweep_decision(profile: StepProfile, chip: ChipModel,
                   slowdown_budget: float = 0.0, n_freqs: int = 11,
                   power_cap_w: Optional[float] = None,
                   objective: str = "energy") -> Decision:
    """The paper's frequency sweep as a pure function: minimize the
    ``objective`` over the grid subject to the slowdown budget (and
    optional power cap). Objectives come from the shared registry
    ``repro_torch.power.objectives``: ``"energy"`` (the paper's sweep,
    default), ``"edp"`` / ``"ed2p"`` (energy-delay products ``E*t`` /
    ``E*t²``), ``"perf_per_watt"`` (minimize ``t*P``) and
    ``"dt_bounded_savings"`` (energy under the budget bound). A frequency
    replaces the incumbent only if it improves the score by more than
    1e-12 (the hysteresis that keeps ties at the higher clock)."""
    from repro_torch.power.objectives import get_objective
    obj = get_objective(objective, what="sweep objective")
    t0 = chip.step_time(profile, 1.0)
    e0 = chip.energy_j(profile, 1.0)
    budget = t0 * (1.0 + slowdown_budget)
    need_pw = obj.needs_power

    best_f, best_e = 1.0, e0
    best_s = obj.score(e0, t0, chip.power_w(profile, 1.0) if need_pw
                       else None)
    for f in chip.freq_grid(n_freqs):
        if power_cap_w is not None and chip.power_w(profile, f) > power_cap_w:
            continue
        t = chip.step_time(profile, f)
        if t > budget * (1.0 + 1e-9):
            continue
        e = chip.energy_j(profile, f)
        s = obj.score(e, t, chip.power_w(profile, f) if need_pw else None)
        if s < best_s - 1e-12:
            best_f, best_e, best_s = f, e, s
    return Decision(
        freq_mhz=chip.freq_mhz(best_f), freq_frac=best_f,
        mode=chip.classify_mode(profile),
        time_s=chip.step_time(profile, best_f),
        power_w=chip.power_w(profile, best_f),
        energy_j=best_e, baseline_energy_j=e0)


class PowerGovernor:
    """The legacy governor: :func:`sweep_decision` under a
    :class:`GovernorConfig`, each decision applied to its actuator."""

    def __init__(self, cfg: GovernorConfig = GovernorConfig(),
                 chip: ChipSpec = H100_SXM,
                 actuator: Optional[PowerActuator] = None):
        self.cfg = cfg
        self.chip = chip
        self.model = ChipModel(chip)
        self.actuator = actuator or SimulatedActuator(chip)

    def freq_grid(self) -> List[float]:
        return self.model.freq_grid(self.cfg.n_freqs)

    def choose(self, profile: StepProfile) -> Decision:
        d = sweep_decision(profile, self.model,
                           slowdown_budget=self.cfg.slowdown_budget,
                           n_freqs=self.cfg.n_freqs,
                           power_cap_w=self.cfg.power_cap_w)
        self.actuator.apply(d.freq_mhz)
        return d
