"""Pluggable power-management policies.

The paper's governor is one point in a wider policy space: static DVFS
schedules, RAPL-style power capping and energy-minimizing sweeps all pick a
frequency per step from the same information — the step's roofline profile
and the chip's transfer functions. ``PowerPolicy`` is that seam: a pure
``decide(profile, chip) -> Decision`` call with no actuation or telemetry
side effects (those belong to :class:`repro_torch.power.EnergySession`).

Policies are selected by name through :func:`get_policy` (``"nominal"``,
``"static"``, ``"power-cap"``, ``"energy-aware"``) or passed as objects.
Each built-in also implements ``decide_batch(profiles, chip, device)`` — one
vectorized pass over a profile batch on ``device``, equal to a loop of
``decide`` (rtol 1e-12 on values, discrete decisions equal).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Protocol, Union, runtime_checkable

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.governor import Decision, sweep_decision
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.power.objectives import check_objective
from repro_torch.power.surface import BatchDecision, ProfileArray, ProfilesLike


@runtime_checkable
class PowerPolicy(Protocol):
    """A per-step frequency policy. Implementations must be pure: given the
    same (profile, chip) they return the same Decision and touch nothing."""

    name: str

    def decide(self, profile: StepProfile, chip: ChipModel) -> Decision: ...


def _decision_at(profile: StepProfile, chip: ChipModel,
                 freq_frac: float) -> Decision:
    e0 = chip.energy_j(profile, 1.0)
    return Decision(
        freq_mhz=chip.freq_mhz(freq_frac), freq_frac=freq_frac,
        mode=chip.classify_mode(profile),
        time_s=chip.step_time(profile, freq_frac),
        power_w=chip.power_w(profile, freq_frac),
        energy_j=chip.energy_j(profile, freq_frac),
        baseline_energy_j=e0)


@dataclass(frozen=True)
class NominalPolicy:
    """Run at nominal frequency — the uncapped baseline."""

    name: str = field(default="nominal", init=False)

    def decide(self, profile: StepProfile, chip: ChipModel) -> Decision:
        return _decision_at(profile, chip, 1.0)

    def decide_batch(self, profiles: ProfilesLike, chip: ChipModel,
                     device=DEFAULT_DEVICE) -> BatchDecision:
        return chip.surface(device).decisions_at(profiles, 1.0)


@dataclass(frozen=True)
class StaticFrequencyPolicy:
    """A fixed DVFS set-point for the whole job, clamped to the chip's DVFS
    range."""

    freq_mhz: int
    name: str = field(default="static", init=False)

    def __post_init__(self):
        if self.freq_mhz <= 0:
            raise ValueError(f"freq_mhz must be positive, got {self.freq_mhz}")

    def decide(self, profile: StepProfile, chip: ChipModel) -> Decision:
        return _decision_at(profile, chip, chip.freq_frac(self.freq_mhz))

    def decide_batch(self, profiles: ProfilesLike, chip: ChipModel,
                     device=DEFAULT_DEVICE) -> BatchDecision:
        return chip.surface(device).decisions_at(
            profiles, chip.freq_frac(self.freq_mhz))


@dataclass(frozen=True)
class PowerCapPolicy:
    """RAPL-style power cap: the highest frequency whose predicted power
    stays under ``cap_w``."""

    cap_w: float
    grid: int = 64
    name: str = field(default="power-cap", init=False)

    def __post_init__(self):
        if self.cap_w <= 0:
            raise ValueError(f"cap_w must be positive, got {self.cap_w}")

    def decide(self, profile: StepProfile, chip: ChipModel) -> Decision:
        f = chip.freq_for_power_cap(profile, self.cap_w, self.grid)
        return _decision_at(profile, chip, f)

    def decide_batch(self, profiles: ProfilesLike, chip: ChipModel,
                     device=DEFAULT_DEVICE) -> BatchDecision:
        surf = chip.surface(device)
        f = surf.freq_for_power_cap(profiles, self.cap_w, self.grid)
        return surf.decisions_at(profiles, f)


@dataclass(frozen=True)
class EnergyAwarePolicy:
    """The paper's per-step energy-minimizing sweep
    (:func:`repro_torch.core.governor.sweep_decision`) behind the policy
    protocol. ``objective`` swaps the swept metric on the same grid — any
    name in :data:`repro_torch.power.objectives.OBJECTIVES`."""

    slowdown_budget: float = 0.0
    n_freqs: int = 11
    power_cap_w: Optional[float] = None
    objective: str = "energy"
    name: str = field(default="energy-aware", init=False)

    def __post_init__(self):
        if self.n_freqs < 1:
            raise ValueError(f"n_freqs must be >= 1, got {self.n_freqs}")
        check_objective(self.objective)

    def decide(self, profile: StepProfile, chip: ChipModel) -> Decision:
        return sweep_decision(profile, chip,
                              slowdown_budget=self.slowdown_budget,
                              n_freqs=self.n_freqs,
                              power_cap_w=self.power_cap_w,
                              objective=self.objective)

    def decide_batch(self, profiles: ProfilesLike, chip: ChipModel,
                     device=DEFAULT_DEVICE) -> BatchDecision:
        return chip.surface(device).sweep_decisions(
            profiles, slowdown_budget=self.slowdown_budget,
            n_freqs=self.n_freqs, power_cap_w=self.power_cap_w,
            objective=self.objective)


def decide_batch(policy: PowerPolicy, profiles: ProfilesLike,
                 chip: ChipModel, device=DEFAULT_DEVICE) -> BatchDecision:
    """One vectorized decision pass for *any* policy on ``device``: the
    built-ins' ``decide_batch``, otherwise a scalar ``decide`` loop lifted
    into a :class:`BatchDecision`."""
    if hasattr(policy, "decide_batch"):
        return policy.decide_batch(profiles, chip, device)
    pa = profiles if isinstance(profiles, ProfileArray) \
        else ProfileArray.coerce(profiles, device)
    return BatchDecision.from_decisions(
        [policy.decide(pa.profile(i), chip) for i in range(len(pa))],
        device)


# ---------------------------------------------------------------------------
# Name-based selection: CLIs accept "--policy <name>" and forward their
# knob values; each factory picks out the knobs it understands.
# ---------------------------------------------------------------------------
def _make_nominal(**kw) -> NominalPolicy:
    return NominalPolicy()


def _make_static(freq_mhz: Optional[int] = None, **kw
                 ) -> StaticFrequencyPolicy:
    if freq_mhz is None:
        raise ValueError("policy 'static' requires freq_mhz")
    return StaticFrequencyPolicy(freq_mhz=freq_mhz)


def _make_power_cap(cap_w: Optional[float] = None, **kw) -> PowerCapPolicy:
    if cap_w is None:
        raise ValueError("policy 'power-cap' requires cap_w")
    return PowerCapPolicy(cap_w=cap_w)


def _make_energy_aware(slowdown_budget: float = 0.0, n_freqs: int = 11,
                       power_cap_w: Optional[float] = None,
                       cap_w: Optional[float] = None,
                       objective: str = "energy", **kw
                       ) -> EnergyAwarePolicy:
    # cap_w is the shared CLI knob (same flag drives "power-cap")
    if power_cap_w is None:
        power_cap_w = cap_w
    return EnergyAwarePolicy(slowdown_budget=slowdown_budget,
                             n_freqs=n_freqs, power_cap_w=power_cap_w,
                             objective=objective)


POLICIES: Dict[str, Callable[..., PowerPolicy]] = {
    "nominal": _make_nominal,
    "static": _make_static,
    "power-cap": _make_power_cap,
    "energy-aware": _make_energy_aware,
}

PolicyLike = Union[None, str, PowerPolicy]


def get_policy(spec: PolicyLike = None, **knobs) -> PowerPolicy:
    """Resolve a policy: ``None`` -> nominal, a name from :data:`POLICIES`
    (with CLI knobs like ``slowdown_budget=``, ``freq_mhz=``, ``cap_w=``),
    or an existing policy object passed through unchanged."""
    if spec is None:
        spec = "nominal"
    if isinstance(spec, str):
        try:
            factory = POLICIES[spec]
        except KeyError:
            raise KeyError(f"unknown power policy {spec!r}; "
                           f"known: {sorted(POLICIES)}") from None
        return factory(**knobs)
    if hasattr(spec, "decide"):
        return spec
    raise TypeError(f"cannot resolve a PowerPolicy from {spec!r}")
