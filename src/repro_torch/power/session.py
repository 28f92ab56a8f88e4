"""EnergySession — one object that owns the power-management loop.

    with EnergySession(policy="energy-aware", chip=H100_SXM) as sess:
        for step in range(n):
            ...run the step...
            sess.observe(step, profile, wall_s)
    sess.summary()

``observe`` asks the policy for a :class:`Decision`, applies it through the
actuator, and records the resulting sample — the single write path into
telemetry. ``observe_many`` records a batch of steps with one vectorized
policy pass on the session's ``device``; ``fleet()`` hands the recorded
telemetry to :class:`~repro_torch.power.fleet.FleetAnalysis` on the same
device, classified against the session's own chip.
"""
from __future__ import annotations

import collections
from typing import Deque, Optional, Sequence, Union

import torch

from repro_torch import DEFAULT_DEVICE, as_device
from repro_torch.core.governor import (Decision, PowerActuator,
                                       SimulatedActuator)
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.core.telemetry import StepSample, TelemetryStore
from repro_torch.power.policies import PolicyLike, PowerPolicy, decide_batch, \
    get_policy
from repro_torch.power.surface import BatchDecision, ProfileArray


class EnergySession:
    """Binds a :class:`PowerPolicy`, a :class:`ChipModel`, a
    :class:`TelemetryStore` and a :class:`PowerActuator` behind one
    ``observe(step, profile, wall_s)`` call."""

    def __init__(self, policy: PolicyLike = None,
                 chip: Union[ChipSpec, ChipModel, str] = H100_SXM,
                 telemetry: Optional[TelemetryStore] = None,
                 actuator: Optional[PowerActuator] = None,
                 window_s: float = 15.0, job_id: str = "job0",
                 max_decisions: int = 100_000, device=DEFAULT_DEVICE,
                 **policy_knobs):
        self.chip = ChipModel(chip)
        self.policy: PowerPolicy = get_policy(policy, **policy_knobs)
        self.telemetry = telemetry if telemetry is not None \
            else TelemetryStore(window_s=window_s)
        self.actuator: PowerActuator = actuator \
            if actuator is not None else SimulatedActuator(self.chip.spec)
        self.job_id = job_id
        self.device = as_device(device)
        # bounded: aggregates below are running sums over all steps, the
        # deque keeps the recent decisions for inspection
        self.decisions: Deque[Decision] = collections.deque(
            maxlen=max_decisions)
        self.steps = 0
        self.wall_s_total = 0.0
        self._energy_sum = 0.0
        self._baseline_energy_sum = 0.0
        self._time_sum = 0.0
        self._baseline_time_sum = 0.0
        self._phase: dict = {}
        # running model-time clock: StepSample.t accumulates each decision's
        # step time, so it stays monotonic when the frequency changes
        self._clock_s = 0.0

    # ------------------------------------------------------------- observe
    def _record(self, step: int, d: Decision, wall_s: Optional[float],
                baseline_time_s: Optional[float] = None) -> None:
        """The single decision -> actuation -> telemetry write path.
        ``baseline_time_s`` is the step's nominal-frequency time
        (``profile.total_s``), the denominator of the slowdown report."""
        self.actuator.apply(d.freq_mhz)
        self.telemetry.record(StepSample(
            step=step, t=self._clock_s, duration_s=d.time_s,
            power_w=d.power_w, energy_j=d.energy_j, mode=d.mode.idx,
            freq_mhz=d.freq_mhz, job_id=self.job_id))
        self._clock_s += d.time_s
        self.decisions.append(d)
        self.steps += 1
        self._energy_sum += d.energy_j
        self._baseline_energy_sum += d.baseline_energy_j
        bt = d.time_s if baseline_time_s is None else float(baseline_time_s)
        self._time_sum += d.time_s
        self._baseline_time_sum += bt
        ph = self._phase.get(d.mode.idx)
        if ph is None:
            ph = self._phase[d.mode.idx] = {
                "steps": 0, "time_s": 0.0, "baseline_time_s": 0.0,
                "energy_j": 0.0, "baseline_energy_j": 0.0,
                "freq_mhz_sum": 0.0}
        ph["steps"] += 1
        ph["time_s"] += d.time_s
        ph["baseline_time_s"] += bt
        ph["energy_j"] += d.energy_j
        ph["baseline_energy_j"] += d.baseline_energy_j
        ph["freq_mhz_sum"] += d.freq_mhz
        if wall_s is not None:
            self.wall_s_total += wall_s

    def observe(self, step: int, profile: StepProfile,
                wall_s: Optional[float] = None) -> Decision:
        """Record one step: policy decision -> actuation -> telemetry.

        ``wall_s`` is the measured wall-clock of the step, kept for
        reporting; the recorded (time, power, energy) come from the chip
        model at the chosen frequency."""
        d = self.policy.decide(profile, self.chip)
        self._record(step, d, wall_s, baseline_time_s=profile.total_s)
        return d

    def observe_many(self, profiles: Union[Sequence[StepProfile],
                                           ProfileArray],
                     wall_s: Union[None, float, Sequence[float]] = None,
                     start_step: Optional[int] = None) -> BatchDecision:
        """Record a batch of steps with ONE vectorized policy pass.

        Equivalent to looping :meth:`observe`. Steps are numbered from
        ``start_step`` (default: continues this session's step count);
        ``wall_s`` is a per-step sequence or a batch total."""
        batch = profiles if isinstance(profiles, ProfileArray) \
            else list(profiles)
        if len(batch) == 0:
            return BatchDecision.from_decisions([], self.device)
        start = self.steps if start_step is None else start_step
        bd = decide_batch(self.policy, batch, self.chip, self.device)
        ds = bd.decisions()
        if wall_s is None:
            walls = [None] * len(ds)
        elif isinstance(wall_s, (int, float)):
            walls = [None] * len(ds)
            self.wall_s_total += wall_s
        else:
            walls = list(wall_s)
            if len(walls) != len(ds):
                raise ValueError(
                    f"wall_s has {len(walls)} entries for {len(ds)} steps")
        if isinstance(batch, ProfileArray):
            pa = batch
            bts = torch.maximum(
                torch.maximum(pa.compute_s, pa.memory_s),
                torch.clamp(pa.collective_s, min=1e-12))
            bts = torch.broadcast_to(bts, (len(ds),)).tolist()
        else:
            bts = [p.total_s for p in batch]
        for i, (d, w, bt) in enumerate(zip(ds, walls, bts)):
            self._record(start + i, d, w, baseline_time_s=bt)
        return bd

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "EnergySession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.telemetry.flush()

    # ------------------------------------------------------------ analysis
    def fleet(self):
        """This session's telemetry as a
        :class:`repro_torch.power.FleetAnalysis` on the session's device,
        classified against *this* chip's power envelope (building it by hand
        via ``FleetAnalysis.from_store`` defaults to the paper's MI250X
        bands)."""
        from repro_torch.power.fleet import FleetAnalysis
        return FleetAnalysis.from_store(self.telemetry, chip=self.chip.spec,
                                        device=self.device)

    def total_energy_j(self) -> float:
        return self.telemetry.total_energy_j()

    def mode_hours_pct(self):
        return self.telemetry.mode_hours_pct()

    def savings_pct(self) -> float:
        """Aggregate energy saved vs the nominal-frequency baseline."""
        if self._baseline_energy_sum <= 0:
            return 0.0
        return 100.0 * (1.0 - self._energy_sum / self._baseline_energy_sum)

    def dt_pct(self) -> float:
        """Aggregate slowdown vs the nominal-frequency baseline."""
        if self._baseline_time_sum <= 0:
            return 0.0
        return 100.0 * (self._time_sum / self._baseline_time_sum - 1.0)

    def phase_report(self) -> dict:
        """Per-mode decision summary, keyed by mode index: how deep the
        policy capped each phase and at what cost (a serving engine's
        compute-bound prefill and memory-bound decode land in different
        modes)."""
        out = {}
        for idx in sorted(self._phase):
            ph = self._phase[idx]
            be, bt = ph["baseline_energy_j"], ph["baseline_time_s"]
            out[idx] = {
                "steps": ph["steps"],
                "freq_mhz_mean": ph["freq_mhz_sum"] / ph["steps"],
                "time_s": ph["time_s"],
                "energy_j": ph["energy_j"],
                "savings_pct": (100.0 * (1.0 - ph["energy_j"] / be)
                                if be > 0 else 0.0),
                "dt_pct": (100.0 * (ph["time_s"] / bt - 1.0)
                           if bt > 0 else 0.0),
            }
        return out

    def summary(self) -> dict:
        return {
            "policy": self.policy.name,
            "chip": self.chip.spec.name,
            "steps": self.steps,
            "energy_j": self.total_energy_j(),
            "savings_pct": self.savings_pct(),
            "dt_pct": self.dt_pct(),
            "mode_hours_pct": self.mode_hours_pct(),
            "wall_s": self.wall_s_total,
        }
