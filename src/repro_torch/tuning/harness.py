"""Measurement harness — time surviving candidates across a frequency sweep.

Two interchangeable backends produce the same :class:`Measurement` record
(a ``(candidates, freqs)`` grid of step time and power):

* :class:`SimulatedBackend` — a deterministic timer backed by
  :class:`~repro_torch.power.surface.TransferSurface`: each candidate's
  analytic :class:`~repro_torch.core.power_model.StepProfile` (from
  :meth:`KernelSpace.profile`) is pushed through the chip's transfer
  functions in ONE batched ``(profiles, freqs)`` pass. Hermetic — no
  clocks, no RNG — so tests can pin exact outputs.
* :class:`WallClockBackend` — times the real kernel (best of ``repeats``,
  after a warmup run; CUDA events on the card, the host clock for CPU
  tensors) and anchors the analytic profile to the observed time: the
  roofline terms are rescaled so ``step_time(profile, 1.0)`` equals the
  measured time, then the frequency/power response comes from the same
  transfer surface. On a machine with a DVFS actuator, pass
  ``actuator``/``power_sensor`` callables to measure the response directly
  instead of modeling it.

Both stamp ``Measurement.source`` so downstream calibration artifacts
(:mod:`repro_torch.tuning.calibrate`) record their provenance.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.tuning.space import Candidate, Config, KernelSpace, PerfParams

#: Default frequency sweep: the chip's 11-point DVFS grid (matches the
#: paper's governor sweep in ``repro_torch.core.governor``).
DEFAULT_N_FREQS = 11


def default_freq_fracs(chip: ChipModel, n_freqs: int = DEFAULT_N_FREQS,
                       device=DEFAULT_DEVICE) -> torch.Tensor:
    return f64(chip.freq_grid(n_freqs), as_device(device))


@dataclass(eq=False)
class Measurement:
    """A ``(candidates, freqs)`` grid of measured/simulated step behavior.

    ``time_s`` and ``power_w`` are ``(N, F)`` float64 tensors over the
    ``candidates`` batch and the ``freq_fracs`` sweep, all on one device;
    ``energy_j`` is their product. ``source`` records which backend
    produced the grid (``"simulated:<chip>"`` / ``"wallclock:<chip>"``).
    """

    kernel: str
    chip: ChipSpec
    source: str
    candidates: Tuple[Candidate, ...]
    freq_fracs: torch.Tensor            # (F,)
    time_s: torch.Tensor                # (N, F)
    power_w: torch.Tensor               # (N, F)
    validation_err: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        self.time_s = f64(self.time_s)
        dev = self.time_s.device
        self.freq_fracs = f64(self.freq_fracs, dev)
        self.power_w = f64(self.power_w, dev)
        n, f = len(self.candidates), self.freq_fracs.shape[0]
        if tuple(self.time_s.shape) != (n, f) or \
                tuple(self.power_w.shape) != (n, f):
            raise ValueError(
                f"measurement grids must be ({n}, {f}); got time_s "
                f"{tuple(self.time_s.shape)}, power_w "
                f"{tuple(self.power_w.shape)}")

    @property
    def configs(self) -> Tuple[Config, ...]:
        return tuple(c.config for c in self.candidates)

    @property
    def energy_j(self) -> torch.Tensor:
        return self.time_s * self.power_w

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.candidates), int(self.freq_fracs.shape[0]))

    @property
    def device(self) -> torch.device:
        return self.time_s.device

    def nominal_column(self) -> int:
        """Index of the sweep column closest to nominal frequency."""
        return int(torch.argmin(torch.abs(self.freq_fracs - 1.0)))

    def __repr__(self) -> str:
        n, f = self.shape
        return (f"Measurement({self.kernel!r}, {n} candidates x {f} freqs, "
                f"source={self.source!r})")


class SimulatedBackend:
    """Deterministic transfer-surface timer (the hermetic backend).

    The whole ``(candidates, freqs)`` grid is one batched surface pass on
    ``device`` over the candidates' analytic profiles;
    ``measure_one(space, c, f)`` is the scalar (host) view of one cell.
    """

    name = "simulated"

    def __init__(self, chip: "ChipSpec | str | ChipModel" = H100_SXM,
                 perf: Optional[PerfParams] = None, device=DEFAULT_DEVICE):
        self.chip = ChipModel(chip)
        self.perf = perf if perf is not None else PerfParams()
        self.device = as_device(device)

    def __repr__(self) -> str:
        return f"SimulatedBackend({self.chip.spec.name!r}, perf={self.perf})"

    def profiles(self, space: KernelSpace,
                 candidates: Sequence[Candidate]) -> List[StepProfile]:
        return [space.profile(c, self.chip, self.perf) for c in candidates]

    def _prepare(self, space, candidates, freq_fracs, validate):
        if candidates is None:
            candidates = space.candidates()
        candidates = tuple(candidates)
        if not candidates:
            raise ValueError(
                f"no candidates to measure for {space.kernel!r} "
                f"(all pruned?)")
        fr = (default_freq_fracs(self.chip, device=self.device)
              if freq_fracs is None else f64(freq_fracs, self.device))
        errs = tuple(space.validate(c) for c in candidates) \
            if validate else None
        return candidates, fr, errs

    def _grid(self, space, candidates, fr, errs, profiles) -> Measurement:
        from repro_torch.power.surface import ProfileArray
        surf = self.chip.surface(self.device)
        pa = ProfileArray.from_profiles(profiles, self.device).expand()
        return Measurement(kernel=space.kernel, chip=self.chip.spec,
                           source=f"{self.name}:{self.chip.spec.name}",
                           candidates=candidates, freq_fracs=fr,
                           time_s=surf.step_time(pa, fr),       # (N, F)
                           power_w=surf.power_w(pa, fr),
                           validation_err=errs)

    def measure(self, space: KernelSpace,
                candidates: Optional[Sequence[Candidate]] = None,
                freq_fracs: Optional[Sequence[float]] = None,
                validate: bool = False) -> Measurement:
        candidates, fr, errs = self._prepare(space, candidates, freq_fracs,
                                             validate)
        return self._grid(space, candidates, fr, errs,
                          self.profiles(space, candidates))

    def measure_one(self, space: KernelSpace, candidate: Candidate,
                    freq_frac: float = 1.0) -> Tuple[float, float]:
        """Scalar ``(time_s, power_w)`` of one cell on the host."""
        prof = space.profile(candidate, self.chip, self.perf)
        return (self.chip.step_time(prof, freq_frac),
                self.chip.power_w(prof, freq_frac))


class WallClockBackend(SimulatedBackend):
    """Times the real kernel and anchors the model to the measured time.

    Each candidate runs ``repeats`` times after a warmup and the minimum
    time is kept. On the card every repeat sits between two CUDA events
    and the device is synchronised once after the last; for CPU tensors
    ``timer`` (the host clock) brackets each run. The candidate's analytic
    profile is then rescaled uniformly so ``step_time(profile, 1.0)``
    reproduces the measurement, and the frequency/power response is read
    off the transfer surface — the model supplies what this machine
    cannot actuate (clocks cannot be set without root). To measure the
    response directly on hardware with DVFS control, pass
    ``actuator(freq_frac)`` (called before each column's timings) and
    ``power_sensor()`` (sampled after each run).
    """

    name = "wallclock"

    def __init__(self, chip: "ChipSpec | str | ChipModel" = H100_SXM,
                 perf: Optional[PerfParams] = None, repeats: int = 3,
                 actuator: Optional[Callable[[float], None]] = None,
                 power_sensor: Optional[Callable[[], float]] = None,
                 timer: Callable[[], float] = _time.perf_counter,
                 device=DEFAULT_DEVICE):
        super().__init__(chip, perf, device)
        if repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {repeats}")
        self.repeats = int(repeats)
        self.actuator = actuator
        self.power_sensor = power_sensor
        self.timer = timer
        #: measured seconds per candidate of the last anchored measure()
        self.wall_s: Tuple[float, ...] = ()

    def _time_candidate(self, space: KernelSpace,
                        candidate: Candidate) -> float:
        if space.device.type == "cuda":
            space._run(candidate)                    # warmup: build + run
            events = []
            for _ in range(self.repeats):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                space._run(candidate)
                stop.record()
                events.append((start, stop))
            torch.cuda.synchronize(space.device)
            return min(s.elapsed_time(e) for s, e in events) * 1e-3
        space._run(candidate)                        # warmup
        best = float("inf")
        for _ in range(self.repeats):
            t0 = self.timer()
            space._run(candidate)
            best = min(best, self.timer() - t0)
        return best

    def anchored_profile(self, space: KernelSpace, candidate: Candidate,
                         wall_s: float) -> StepProfile:
        """The analytic profile scaled uniformly so its nominal step time
        equals the measurement (shape from the model, scale from the
        machine)."""
        model_prof = space.profile(candidate, self.chip, self.perf)
        scale = wall_s / max(model_prof.total_s, 1e-12)
        return StepProfile(compute_s=model_prof.compute_s * scale,
                           memory_s=model_prof.memory_s * scale,
                           collective_s=model_prof.collective_s * scale)

    def measure(self, space: KernelSpace,
                candidates: Optional[Sequence[Candidate]] = None,
                freq_fracs: Optional[Sequence[float]] = None,
                validate: bool = False) -> Measurement:
        candidates, fr, errs = self._prepare(space, candidates, freq_fracs,
                                             validate)
        if self.actuator is not None and self.power_sensor is not None:
            # direct hardware response: actuate each frequency column
            t = [[0.0] * fr.shape[0] for _ in candidates]
            p = [[0.0] * fr.shape[0] for _ in candidates]
            for j, f in enumerate(fr.tolist()):
                self.actuator(float(f))
                for i, c in enumerate(candidates):
                    t[i][j] = self._time_candidate(space, c)
                    p[i][j] = float(self.power_sensor())
            return Measurement(kernel=space.kernel, chip=self.chip.spec,
                               source=f"{self.name}:{self.chip.spec.name}",
                               candidates=candidates, freq_fracs=fr,
                               time_s=f64(t, self.device),
                               power_w=f64(p, self.device),
                               validation_err=errs)
        self.wall_s = tuple(self._time_candidate(space, c)
                            for c in candidates)
        profs = [self.anchored_profile(space, c, w)
                 for c, w in zip(candidates, self.wall_s)]
        return self._grid(space, candidates, fr, errs, profs)
