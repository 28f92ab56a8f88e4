"""Tensor-native chip transfer surface — batched DVFS sweeps and capping.

The scalar :class:`repro_torch.core.power_model.ChipModel` answers one
``(profile, freq)`` question per call. :class:`TransferSurface` is the same
calibrated transfer functions evaluated over broadcastable
``(profiles…, freqs)`` float64 tensors in one pass, on one device:

    surf = TransferSurface("h100-sxm")               # or ChipModel/ChipSpec
    pa = ProfileArray.from_profiles(step_profiles)   # (N,) roofline batch
    t = surf.step_time(pa.expand(), freqs)           # (N, F) in one pass
    bd = surf.sweep_decisions(pa, slowdown_budget=0) # vectorized governor

Guarantees:

* the elementwise formulas here are the canonical implementation —
  ``ChipModel.step_time`` / ``power_w`` / ``energy_j`` /
  ``freq_for_power_cap`` are single-element views of a surface on the host,
  and :meth:`sweep_decisions` replays the exact accept/reject sequence of
  :func:`repro_torch.core.governor.sweep_decision` (including its 1e-12
  improvement hysteresis);
* ``+ * / max min`` are exactly rounded on every device, so scalar and
  tensor calls agree in everything but ``f ** GAMMA``: that one op goes
  through :meth:`TransferSurface._pow_gamma` for scalar and tensor calls
  alike, and gives an element the same bits wherever it lies in its tensor
  (numpy's ufunc on the CPU, ``torch.pow`` on the card). The card's pow may
  differ from the host's by an ulp, so values are held to ``rtol 1e-12``
  against the reference package and every discrete decision to equality;
* ``freq_for_power_cap`` is an argmax over the whole ``(profiles, grid)``
  power tensor instead of a per-frequency Python loop.

:func:`response_table` uses the surface to synthesize Table III-style
``(power %, runtime %, energy %)`` response columns for *any* registered
chip, which :func:`repro_torch.core.projection.project_batch` accepts in
place of the built-in measured MI250X tables — the cross-chip what-if
projection the paper stops short of.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device, device_of, f64
from repro_torch.core.governor import Decision
from repro_torch.core.hardware import ChipSpec, H100_SXM, MODES
from repro_torch.core.power_model import (GAMMA, W_COMPUTE, W_MEMORY,
                                          W_NETWORK, ChipModel, StepProfile)
from repro_torch.core.projection import ResponseTables

ProfilesLike = Union["ProfileArray", StepProfile, Sequence[StepProfile], Any]


@dataclass(frozen=True)
class ProfileArray:
    """A batch of roofline positions as three broadcastable float64 tensors
    (seconds at nominal frequency, like :class:`StepProfile`). Any common
    shape works — ``(N,)`` job batches, ``(jobs, phases)`` grids, 0-d."""

    compute_s: torch.Tensor
    memory_s: torch.Tensor
    collective_s: torch.Tensor

    @classmethod
    def from_profiles(cls, profiles: Sequence[StepProfile],
                      device=DEFAULT_DEVICE) -> "ProfileArray":
        return cls(f64([p.compute_s for p in profiles], device),
                   f64([p.memory_s for p in profiles], device),
                   f64([p.collective_s for p in profiles], device))

    @classmethod
    def coerce(cls, profiles: ProfilesLike, device=None) -> "ProfileArray":
        """Accept a ProfileArray, one StepProfile, a sequence of
        StepProfiles, or an array-like of shape ``(..., 3)``. Tensors stay
        on their device unless ``device`` names another; python and numpy
        data go to ``device`` (default: the card)."""
        if isinstance(profiles, (ProfileArray, StepProfile)):
            if device is None:
                device = device_of(profiles.compute_s, profiles.memory_s,
                                   profiles.collective_s)
            return cls(f64(profiles.compute_s, device),
                       f64(profiles.memory_s, device),
                       f64(profiles.collective_s, device))
        if isinstance(profiles, (list, tuple)) and profiles and \
                isinstance(profiles[0], StepProfile):
            return cls.from_profiles(profiles, as_device(device))
        arr = f64(profiles, device)
        if arr.ndim < 1 or arr.shape[-1] != 3:
            raise ValueError(
                "profiles must be a ProfileArray, StepProfile(s), or an "
                f"array of (compute_s, memory_s, collective_s) triples; got "
                f"shape {tuple(arr.shape)}")
        return cls(arr[..., 0], arr[..., 1], arr[..., 2])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(torch.broadcast_shapes(
            *(tuple(getattr(x, "shape", ())) for x in
              (self.compute_s, self.memory_s, self.collective_s))))

    def __len__(self) -> int:
        return int(self.shape[0])

    def expand(self) -> "ProfileArray":
        """Append a trailing length-1 axis so the batch broadcasts against a
        frequency grid: ``surf.power_w(pa.expand(), freqs)`` -> ``(N, F)``."""
        return ProfileArray(self.compute_s[..., None],
                            self.memory_s[..., None],
                            self.collective_s[..., None])

    def profile(self, i: int) -> StepProfile:
        return StepProfile(float(self.compute_s[i]), float(self.memory_s[i]),
                           float(self.collective_s[i]))


@dataclass
class BatchDecision:
    """Vectorized :class:`repro_torch.core.governor.Decision`: every field
    is a tensor over the profile batch; :meth:`decision` lifts one element
    back into the scalar Decision."""

    freq_mhz: torch.Tensor              # int64
    freq_frac: torch.Tensor
    mode_idx: torch.Tensor              # paper mode index 1..4
    time_s: torch.Tensor
    power_w: torch.Tensor
    energy_j: torch.Tensor
    baseline_energy_j: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.freq_frac.shape)

    def __len__(self) -> int:
        return int(self.shape[0])

    @property
    def savings_pct(self) -> torch.Tensor:
        return 100.0 * (1.0 - self.energy_j
                        / torch.clamp(self.baseline_energy_j, min=1e-12))

    def decision(self, i) -> Decision:
        return Decision(
            freq_mhz=int(self.freq_mhz[i]),
            freq_frac=float(self.freq_frac[i]),
            mode=MODES[int(self.mode_idx[i]) - 1],
            time_s=float(self.time_s[i]),
            power_w=float(self.power_w[i]),
            energy_j=float(self.energy_j[i]),
            baseline_energy_j=float(self.baseline_energy_j[i]))

    def decisions(self) -> List[Decision]:
        return [self.decision(i) for i in range(len(self))]

    @classmethod
    def from_decisions(cls, ds: Sequence[Decision],
                       device=DEFAULT_DEVICE) -> "BatchDecision":
        dev = as_device(device)

        def ints(xs):
            return torch.as_tensor(xs, dtype=torch.int64, device=dev)
        return cls(
            freq_mhz=ints([d.freq_mhz for d in ds]),
            freq_frac=f64([d.freq_frac for d in ds], dev),
            mode_idx=ints([d.mode.idx for d in ds]),
            time_s=f64([d.time_s for d in ds], dev),
            power_w=f64([d.power_w for d in ds], dev),
            energy_j=f64([d.energy_j for d in ds], dev),
            baseline_energy_j=f64([d.baseline_energy_j for d in ds], dev))


class TransferSurface:
    """The power/performance transfer functions of one chip evaluated over
    broadcastable float64 tensors on ``device`` (default: the card)."""

    def __init__(self, chip: Union[ChipSpec, str, ChipModel] = H100_SXM,
                 device=DEFAULT_DEVICE):
        self.chip = ChipModel(chip)
        self.spec: ChipSpec = self.chip.spec
        self.device = as_device(device)

    def __repr__(self) -> str:
        return (f"TransferSurface({self.spec.name!r}, "
                f"device={str(self.device)!r})")

    # ----------------------------------------------------- transfer surface
    # Each method has a scalar fast path on a host surface (a StepProfile at
    # one python-float frequency stays python floats — the per-step scalar
    # callers can't batch and must stay cheap); it shares every formula with
    # the tensor path, pow included.
    def _scalar(self, profiles, freq_frac) -> bool:
        return (self.device.type == "cpu"
                and isinstance(profiles, StepProfile)
                and isinstance(freq_frac, (int, float)))

    def _f(self, x) -> torch.Tensor:
        return f64(x, self.device)

    def _pow_gamma(self, freq_frac) -> torch.Tensor:
        # the one pow path of the package, whatever shape the caller had.
        # On the CPU torch.pow takes a vectorised pow for the body of a
        # tensor and libm's for its last few elements, which differ by an
        # ulp on some inputs, so an element's bits would depend on where it
        # lies; numpy's ufunc computes every element of an array alike (a
        # 0-d array too). On the card torch.pow computes every element alike
        f = self._f(freq_frac)
        if f.device.type == "cpu":
            return torch.as_tensor(np.power(f.numpy(), GAMMA))
        return torch.pow(f, GAMMA)

    def step_time(self, profiles: ProfilesLike, freq_frac=1.0):
        if self._scalar(profiles, freq_frac):
            return max(profiles.compute_s / max(freq_frac, 1e-6),
                       profiles.memory_s, profiles.collective_s, 1e-12)
        p = ProfileArray.coerce(profiles, self.device)
        f = torch.clamp(self._f(freq_frac), min=1e-6)
        return torch.maximum(torch.maximum(p.compute_s / f, p.memory_s),
                             torch.clamp(p.collective_s, min=1e-12))

    def utilizations(self, profiles: ProfilesLike, freq_frac=1.0):
        if self._scalar(profiles, freq_frac):
            t = self.step_time(profiles, freq_frac)
            f = max(freq_frac, 1e-6)
            return (profiles.compute_s / f / t, profiles.memory_s / t,
                    profiles.collective_s / t)
        p = ProfileArray.coerce(profiles, self.device)
        t = self.step_time(p, freq_frac)
        f = torch.clamp(self._f(freq_frac), min=1e-6)
        return (p.compute_s / f / t, p.memory_s / t, p.collective_s / t)

    def power_w(self, profiles: ProfilesLike, freq_frac=1.0):
        spec = self.spec
        span = spec.tdp_w - spec.idle_w
        if self._scalar(profiles, freq_frac):
            u_c, u_m, u_n = self.utilizations(profiles, freq_frac)
            p = spec.idle_w + span * (
                W_COMPUTE * u_c * float(self._pow_gamma(freq_frac))
                + W_MEMORY * u_m + W_NETWORK * u_n)
            return min(p, spec.tdp_w)
        u_c, u_m, u_n = self.utilizations(profiles, freq_frac)
        p = spec.idle_w + span * (W_COMPUTE * u_c * self._pow_gamma(freq_frac)
                                  + W_MEMORY * u_m + W_NETWORK * u_n)
        return torch.clamp(p, max=spec.tdp_w)

    def energy_j(self, profiles: ProfilesLike, freq_frac=1.0):
        if self._scalar(profiles, freq_frac):
            return self.power_w(profiles, freq_frac) \
                * self.step_time(profiles, freq_frac)
        p = ProfileArray.coerce(profiles, self.device)
        return self.power_w(p, freq_frac) * self.step_time(p, freq_frac)

    def classify_mode_idx(self, profiles: ProfilesLike, freq_frac=1.0):
        """Structural mode index (1..4) per element — the tensor form of
        :meth:`ChipModel.classify_mode`."""
        if self._scalar(profiles, freq_frac):
            u_c, u_m, u_n = self.utilizations(profiles, freq_frac)
            if u_n >= max(u_c, u_m):
                return 1
            return 2 if u_m >= u_c else 3
        u_c, u_m, u_n = self.utilizations(profiles, freq_frac)
        one = torch.ones_like(u_c, dtype=torch.int64)
        return torch.where(u_n >= torch.maximum(u_c, u_m), one,
                           torch.where(u_m >= u_c, 2 * one, 3 * one))

    # ----------------------------------------------------------- inversion
    def infer_profiles(self, power_w, freq_frac=1.0, duration_s=1.0,
                       mode_idx=None) -> ProfileArray:
        """Invert the power model: a canonical roofline profile per recorded
        power sample.

        One power reading cannot pin down three utilizations, so the
        recorded (or power-band-classified) ``mode_idx`` names the
        saturated resource — mode 2 pins HBM at busy fraction 1, modes 3/4
        pin compute, mode 1 the interconnect — and the residual dynamic
        power is attributed down the chain (network -> memory -> compute),
        clipped to physical ``[0, 1]`` busy fractions. The inversion is
        exact where it can be: ``power_w(infer_profiles(p, f, d, m), f)``
        round-trips ``p`` to float rounding whenever ``p`` lies inside the
        mode's representable band (no TDP clip, residuals within the
        weights), and ``step_time(..., f) == duration_s`` always.

        All of ``power_w`` / ``freq_frac`` / ``duration_s`` broadcast
        together; ``mode_idx`` defaults to the paper's power-band
        classification against this chip's envelope.
        """
        spec = self.spec
        p = self._f(power_w)
        f = torch.clamp(self._f(freq_frac), min=1e-6)
        dur = self._f(duration_s)
        if mode_idx is None:
            from repro_torch.core.modal import classify_power
            mode_idx = classify_power(p, spec)
        m = torch.as_tensor(mode_idx, device=self.device)
        span = spec.tdp_w - spec.idle_w
        u = torch.clamp((p - spec.idle_w) / span, min=0.0)
        wc = W_COMPUTE * self._pow_gamma(f)
        is_cmp = m >= 3                        # boost replays as compute
        u_n = (m == 1).to(torch.float64)
        u_m = torch.where(m == 2, 1.0,
                          torch.clamp((u - W_NETWORK * u_n) / W_MEMORY,
                                      0.0, 1.0))
        u_m = torch.where(is_cmp,
                          torch.clamp((u - wc) / W_MEMORY, 0.0, 1.0), u_m)
        u_c = torch.where(
            is_cmp, 1.0,
            torch.clamp((u - W_NETWORK * u_n - W_MEMORY * u_m) / wc,
                        0.0, 1.0))
        # seconds at nominal: the saturated resource binds the step at the
        # recorded frequency, so step_time(profile, f) == duration_s
        return ProfileArray(compute_s=u_c * f * dur, memory_s=u_m * dur,
                            collective_s=u_n * dur)

    # ------------------------------------------------------------- capping
    def freq_for_power_cap(self, profiles: ProfilesLike, cap_w,
                           grid: int = 64):
        """RAPL-style enforcement as one argmax over the whole grid: the
        highest grid frequency whose power stays under ``cap_w`` (the DVFS
        floor when even that breaches — paper Fig. 6d). ``cap_w`` broadcasts
        against the profile batch."""
        lo = self.chip.f_min_frac
        i = torch.arange(grid + 1, dtype=torch.float64, device=self.device)
        fgrid = lo + ((1.0 - lo) * i) / grid
        p = ProfileArray.coerce(profiles, self.device)
        pw = self.power_w(p.expand(), fgrid)
        ok = pw <= self._f(cap_w)[..., None]
        return torch.where(ok, fgrid, lo).amax(dim=-1)

    # ----------------------------------------------------------- decisions
    def decisions_at(self, profiles: ProfilesLike,
                     freq_frac) -> BatchDecision:
        """Full decision record at a fixed (per-element) frequency."""
        p = ProfileArray.coerce(profiles, self.device)
        e0 = self.energy_j(p, 1.0)
        t = self.step_time(p, freq_frac)
        pw = self.power_w(p, freq_frac)
        e = self.energy_j(p, freq_frac)
        mode = self.classify_mode_idx(p)
        ff = self._f(freq_frac) * torch.ones_like(t)
        mhz = torch.round(ff * self.spec.f_nominal_mhz).to(torch.int64)
        mhz, ff, mode, t, pw, e, e0 = torch.broadcast_tensors(
            mhz, ff, mode, t, pw, e, e0)
        return BatchDecision(freq_mhz=mhz, freq_frac=ff, mode_idx=mode,
                             time_s=t, power_w=pw, energy_j=e,
                             baseline_energy_j=e0)

    def sweep_decisions(self, profiles: ProfilesLike,
                        slowdown_budget: float = 0.0, n_freqs: int = 11,
                        power_cap_w: Optional[float] = None,
                        objective: str = "energy") -> BatchDecision:
        """The paper's frequency sweep, vectorized over the profile batch —
        a Python loop of :func:`repro_torch.core.governor.sweep_decision`
        in one pass (same grid, same sequential accept rule with its 1e-12
        improvement hysteresis, same ``objective`` registry).
        """
        from repro_torch.power.objectives import get_objective
        obj = get_objective(objective, what="sweep objective")
        p = ProfileArray.coerce(profiles, self.device)
        t0 = self.step_time(p, 1.0)
        e0 = self.energy_j(p, 1.0)
        budget = t0 * (1.0 + slowdown_budget)
        need_pw = obj.needs_power

        best_f = torch.ones_like(t0)
        best_e = e0
        best_s = obj.score(e0, t0, self.power_w(p, 1.0) if need_pw else None)
        for f in self.chip.freq_grid(n_freqs):
            t = self.step_time(p, f)
            e = self.energy_j(p, f)
            s = obj.score(e, t, self.power_w(p, f) if need_pw else None)
            ok = (s < best_s - 1e-12) & (t <= budget * (1.0 + 1e-9))
            if power_cap_w is not None:
                ok = ok & (self.power_w(p, f) <= power_cap_w)
            best_f = torch.where(ok, f, best_f)
            best_e = torch.where(ok, e, best_e)
            best_s = torch.where(ok, s, best_s)
        mhz = torch.round(best_f * self.spec.f_nominal_mhz).to(torch.int64)
        return BatchDecision(
            freq_mhz=mhz, freq_frac=best_f,
            mode_idx=self.classify_mode_idx(p),
            time_s=self.step_time(p, best_f),
            power_w=self.power_w(p, best_f),
            energy_j=best_e, baseline_energy_j=e0)


# ---------------------------------------------------------------------------
# Model-derived response tables (cross-chip Table III analogue)
# ---------------------------------------------------------------------------
# VAI family: the paper's arithmetic-intensity sweep (AI = 2L / 8 bytes per
# element at itemsize 4 -> loopsize L = 8 * AI), spanning stream-copy to far
# past the roofline ridge. MB family: HBM-streaming probes at several
# compute/memory overlap ratios (the MB benchmark's data-size sweep
# collapses to the ratio in this roofline model).
VAI_TABLE_AIS: Tuple[float, ...] = (0.0625, 0.25, 1.0, 4.0, 16.0, 64.0,
                                    256.0, 1024.0)
MB_TABLE_RATIOS: Tuple[float, ...] = (0.02, 0.05, 0.1, 0.2)
_TABLE_N_ELEMS = 1 << 20
DEFAULT_POWER_CAP_FRACS: Tuple[float, ...] = (1.0, 0.9, 0.72, 0.54, 0.36)


def _vai_family(chip: ChipModel) -> List[StepProfile]:
    return [chip.vai_profile(_TABLE_N_ELEMS, int(round(ai * 8)))
            for ai in VAI_TABLE_AIS]


def _mb_family(chip: ChipModel) -> List[StepProfile]:
    return [StepProfile(compute_s=r, memory_s=1.0) for r in MB_TABLE_RATIOS]


def _resolve_caps(surf: TransferSurface,
                  caps: Optional[Sequence[float]],
                  kind: str) -> Tuple[List[float], List[int]]:
    """Default/validate a cap list for response columns; returns the caps
    and their integer table keys (tables are integer-keyed — caps that
    collide after rounding are rejected up front)."""
    model = surf.chip
    if kind == "freq":
        if caps is None:
            caps = [model.freq_mhz(f) for f in model.freq_grid(6)][::-1]
    elif kind == "power":
        if caps is None:
            caps = [frac * surf.spec.tdp_w for frac in DEFAULT_POWER_CAP_FRACS]
    else:
        raise ValueError(f"kind must be 'freq' or 'power', got {kind!r}")
    caps = [float(c) for c in caps]
    keys = [int(round(c)) for c in caps]
    if len(set(keys)) != len(keys):
        raise ValueError(
            f"caps {caps} collide after integer rounding ({keys}); response "
            f"tables are integer-keyed — space caps at least 1 "
            f"{'MHz' if kind == 'freq' else 'W'} apart")
    return caps, keys


def family_response_tables(chip: Union[ChipSpec, str, ChipModel],
                           families: "dict",
                           caps: Optional[Sequence[float]] = None,
                           kind: str = "freq", grid: int = 64,
                           device=DEFAULT_DEVICE,
                           source: Optional[str] = None) -> ResponseTables:
    """Synthesize Table III-style response columns from arbitrary benchmark
    families — the engine behind :func:`response_table` and the calibrated
    tables of :mod:`repro_torch.tuning.calibrate`.

    ``families`` maps ``"vai"`` / ``"mb"`` to a profile family (anything
    :meth:`ProfileArray.coerce` accepts — StepProfiles or inferred
    ProfileArrays). For each cap the family is pushed through the chip's
    :class:`TransferSurface` in one ``(profiles, caps)`` pass; columns are
    the family averages relative to the uncapped run, in the paper's
    format: ``power %`` as the ratio of mean powers, ``runtime %`` /
    ``energy %`` as means of per-profile ratios (matching
    :func:`repro_torch.core.vai.response_table`). The means are plain
    ``Tensor.mean`` calls, whose summation order is the device's own.
    """
    surf = TransferSurface(chip, device=device)
    model = surf.chip
    caps, keys = _resolve_caps(surf, caps, kind)
    missing = [k for k in ("vai", "mb") if k not in families]
    if missing:
        raise ValueError(f"families must provide 'vai' and 'mb' columns; "
                         f"missing {missing}")

    columns = {}
    for name in ("vai", "mb"):
        pa = ProfileArray.coerce(families[name], surf.device)
        grid_pa = pa.expand()                                 # (P, 1)
        if kind == "freq":
            fr = f64([model.freq_frac(c) for c in caps], surf.device)  # (C,)
        else:
            fr = surf.freq_for_power_cap(grid_pa, f64(caps, surf.device),
                                         grid=grid)              # (P, C)
        t = surf.step_time(grid_pa, fr)
        p = surf.power_w(grid_pa, fr)
        e = surf.energy_j(grid_pa, fr)
        t0 = surf.step_time(pa, 1.0)[:, None]
        p0 = surf.power_w(pa, 1.0)[:, None]
        e0 = surf.energy_j(pa, 1.0)[:, None]
        power_pct = (100.0 * p.mean(dim=0) / p0.mean()).tolist()
        runtime_pct = (100.0 * (t / t0).mean(dim=0)).tolist()
        energy_pct = (100.0 * (e / e0).mean(dim=0)).tolist()
        columns[name] = {
            k: (power_pct[j], runtime_pct[j], energy_pct[j])
            for j, k in enumerate(keys)}
    return ResponseTables(
        vai=columns["vai"], mb=columns["mb"], kind=kind,
        source=source if source is not None else f"model:{surf.spec.name}")


def response_table(chip: Union[ChipSpec, str, ChipModel],
                   caps: Optional[Sequence[float]] = None,
                   kind: str = "freq", grid: int = 64,
                   device=DEFAULT_DEVICE) -> ResponseTables:
    """Synthesize Table III-style response columns for any registered chip.

    The VAI (compute-family) and MB (memory-family) benchmark profiles go
    through :func:`family_response_tables` — see there for the column
    math.

    ``kind="freq"``: caps are clock values in MHz (default: the chip's own
    6-point DVFS grid). ``kind="power"``: caps are watt limits (default:
    :data:`DEFAULT_POWER_CAP_FRACS` of TDP), enforced RAPL-style through
    :meth:`TransferSurface.freq_for_power_cap`.

    The result plugs into :func:`repro_torch.core.projection.project_batch`
    in place of the measured MI250X tables — the cross-chip what-if
    projection.
    """
    model = ChipModel(chip)
    return family_response_tables(
        model, {"vai": _vai_family(model), "mb": _mb_family(model)},
        caps=caps, kind=kind, grid=grid, device=device)
