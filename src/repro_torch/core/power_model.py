"""Analytic power/performance model for a chip under DVFS & power caps.

The paper measures (MI250X) how power, runtime and energy respond to
frequency/power caps at each roofline position. For chips with no public
Table III the response is modelled from first principles, with the endpoints
calibrated to the paper's qualitative findings:

* runtime: t(f) = max(t_compute * f_nom/f, t_memory, t_collective) — compute
  scales with clock, HBM/interconnect do not (paper Fig. 6: memory-bound
  runtime is frequency-insensitive until very low caps);
* power:   P(f) = P_idle + span * (w_c * u_c * (f/f_nom)^gamma
                                   + w_m * u_m + w_n * u_n), capped at TDP.
  With w_c + w_m > 1, TDP is reached only when compute *and* HBM are both
  busy — exactly the paper's AI=4 peak (Fig. 4);
* a power cap is enforced RAPL-style: the highest frequency whose predicted
  power is below the cap (paper: "a power limit only affects codes
  surpassing the limit, while a set frequency affects all").

Calibration to the paper's MI250X data: memory-only stress draws
(380-89)/(560-89) = 0.62 of the dynamic span -> w_m = 0.62; compute-only
(430-89)/(560-89) = 0.72 -> w_c = 0.72; w_c + w_m = 1.34 > 1 with the TDP
cap reproduces the observed plateau.

The API is the bound :class:`ChipModel` object. Its scalar methods take and
return python floats and are host arithmetic; the tensor engine behind them
is :class:`repro_torch.power.surface.TransferSurface`.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple, Union

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.hardware import (CHIPS, ChipSpec, H100_SXM, MODES,
                                       TPU_V5E, Mode)

W_COMPUTE = 0.72
W_MEMORY = 0.62
W_NETWORK = 0.25
GAMMA = 2.4          # V^2*f with limited voltage range: f^2..f^3


@dataclass(frozen=True)
class StepProfile:
    """Roofline position of one step (seconds at nominal frequency)."""
    compute_s: float
    memory_s: float
    collective_s: float = 0.0

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s, 1e-12)


class ChipModel:
    """The power/performance transfer functions of one chip, bound to its
    :class:`ChipSpec` — ``ChipModel(H100_SXM).energy_j(profile, f)``.

    Accepts a spec, a chip name from :data:`repro_torch.core.hardware.CHIPS`,
    or another ``ChipModel`` (copy-construction), so APIs can take any of the
    three interchangeably.
    """

    __slots__ = ("spec", "_surfaces")

    def __init__(self, chip: Union[ChipSpec, str, "ChipModel"] = H100_SXM):
        if isinstance(chip, ChipModel):
            chip = chip.spec
        elif isinstance(chip, str):
            try:
                chip = CHIPS[chip]
            except KeyError:
                raise KeyError(
                    f"unknown chip {chip!r}; known: {sorted(CHIPS)}") from None
        self.spec: ChipSpec = chip
        self._surfaces: dict = {}

    def __repr__(self) -> str:
        return f"ChipModel({self.spec.name!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ChipModel) and other.spec == self.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    # ------------------------------------------------------------ frequency
    @property
    def f_min_frac(self) -> float:
        return self.spec.f_min_mhz / self.spec.f_nominal_mhz

    def freq_frac(self, freq_mhz: float) -> float:
        """MHz -> fraction of nominal, clamped to the chip's DVFS range."""
        return min(max(freq_mhz / self.spec.f_nominal_mhz, self.f_min_frac),
                   1.0)

    def freq_mhz(self, freq_frac: float) -> int:
        return int(round(freq_frac * self.spec.f_nominal_mhz))

    def freq_grid(self, n: int) -> list:
        """``n`` evenly spaced frequency fractions spanning [f_min, f_nom].
        A single-point grid degenerates to nominal frequency."""
        if n < 1:
            raise ValueError(f"freq_grid needs n >= 1, got {n}")
        if n == 1:
            return [1.0]
        lo = self.f_min_frac
        return [lo + (1.0 - lo) * i / (n - 1) for i in range(n)]

    # ----------------------------------------------------- transfer surface
    # The elementwise formulas live in TransferSurface; every scalar method
    # below is the single-element view of that engine on the host.
    def surface(self, device=DEFAULT_DEVICE):
        """This chip's tensor :class:`~repro_torch.power.surface.
        TransferSurface` on ``device``, cached per device."""
        key = str(device)
        surf = self._surfaces.get(key)
        if surf is None:
            from repro_torch.power.surface import TransferSurface
            surf = self._surfaces[key] = TransferSurface(self, device=device)
        return surf

    def step_time(self, profile: StepProfile, freq_frac: float = 1.0
                  ) -> float:
        return float(self.surface("cpu").step_time(profile, freq_frac))

    def utilizations(self, profile: StepProfile, freq_frac: float = 1.0
                     ) -> Tuple[float, float, float]:
        u_c, u_m, u_n = self.surface("cpu").utilizations(profile, freq_frac)
        return (float(u_c), float(u_m), float(u_n))

    def power_w(self, profile: StepProfile, freq_frac: float = 1.0) -> float:
        return float(self.surface("cpu").power_w(profile, freq_frac))

    def energy_j(self, profile: StepProfile, freq_frac: float = 1.0) -> float:
        return float(self.surface("cpu").energy_j(profile, freq_frac))

    def freq_for_power_cap(self, profile: StepProfile, cap_w: float,
                           grid: int = 64) -> float:
        """RAPL-style enforcement: highest frequency with power <= cap —
        one argmax over the whole grid, not ``grid + 1`` scalar calls."""
        return float(self.surface("cpu").freq_for_power_cap(
            profile, cap_w, grid))

    # -------------------------------------------------- mode classification
    def classify_mode(self, profile: StepProfile,
                      freq_frac: float = 1.0) -> Mode:
        """Structural mode classification from the roofline profile. The
        paper must *infer* the mode from power alone (power-only telemetry);
        with the roofline terms known the classification is exact — the
        inverse inference is :meth:`classify_mode_from_power`."""
        idx = int(self.surface("cpu").classify_mode_idx(profile, freq_frac))
        return MODES[idx - 1]

    def classify_mode_from_power(self, p_w: float) -> Mode:
        """Paper-faithful power-band inference, MI250X bands rescaled to the
        chip's (idle, TDP) envelope (Table IV)."""
        spec = self.spec
        frac = (p_w - spec.idle_w) / (spec.tdp_w - spec.idle_w)
        # paper bands on MI250X: <=200 / 200-420 / 420-560 / >560 W
        b1 = (200.0 - 89.0) / (560.0 - 89.0)   # 0.236
        b2 = (420.0 - 89.0) / (560.0 - 89.0)   # 0.703
        if frac <= b1:
            return MODES[0]
        if frac <= b2:
            return MODES[1]
        if frac <= 1.0 - 1e-9:
            return MODES[2]
        return MODES[3]

    # ----------------------------------------------------- profile constructors
    def vai_profile(self, n_elems: int, loopsize: int,
                    itemsize: int = 4) -> StepProfile:
        """Roofline position of one VAI pass (paper Algorithm 1).

        ``loopsize`` fully determines the arithmetic intensity
        (``AI = 2 * loopsize / (accesses * itemsize)``)."""
        flops = 2.0 * loopsize * n_elems
        byts = (4 if loopsize else 2) * n_elems * itemsize
        # VAI is a vector (non-matrix-unit) workload: the model takes the
        # vector peak as peak/8, the reference's formula for every chip
        vector_peak = self.spec.peak_flops / 8.0
        return StepProfile(compute_s=flops / vector_peak,
                           memory_s=byts / self.spec.hbm_bw)


def profile_from_roofline(compute_s: float, memory_s: float,
                          collective_s: float = 0.0) -> StepProfile:
    return StepProfile(compute_s, memory_s, collective_s)


# ---------------------------------------------------------------------------
# Deprecated chip-threaded free functions: the reference's thin shims over
# ChipModel, with its defaults (the TPU v5e where no chip is given), kept
# for callers of the reference's names; in-tree code binds a ChipModel.
# ---------------------------------------------------------------------------
def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.power_model.{name} is deprecated; use "
        f"repro_torch.core.power_model.ChipModel.{name} instead",
        DeprecationWarning, stacklevel=3)


def step_time(profile: StepProfile, freq_frac: float) -> float:
    _deprecated("step_time")
    return ChipModel(TPU_V5E).step_time(profile, freq_frac)


def utilizations(profile: StepProfile, freq_frac: float
                 ) -> Tuple[float, float, float]:
    _deprecated("utilizations")
    return ChipModel(TPU_V5E).utilizations(profile, freq_frac)


def power_w(profile: StepProfile, freq_frac: float,
            chip: ChipSpec = TPU_V5E) -> float:
    _deprecated("power_w")
    return ChipModel(chip).power_w(profile, freq_frac)


def energy_j(profile: StepProfile, freq_frac: float,
             chip: ChipSpec = TPU_V5E) -> float:
    _deprecated("energy_j")
    return ChipModel(chip).energy_j(profile, freq_frac)


def freq_for_power_cap(profile: StepProfile, cap_w: float,
                       chip: ChipSpec = TPU_V5E, grid: int = 64) -> float:
    _deprecated("freq_for_power_cap")
    return ChipModel(chip).freq_for_power_cap(profile, cap_w, grid)


def classify_mode(profile: StepProfile, chip: ChipSpec = TPU_V5E,
                  freq_frac: float = 1.0) -> Mode:
    _deprecated("classify_mode")
    return ChipModel(chip).classify_mode(profile, freq_frac)


def classify_mode_from_power(p_w: float, chip: ChipSpec = TPU_V5E) -> Mode:
    _deprecated("classify_mode_from_power")
    return ChipModel(chip).classify_mode_from_power(p_w)


def vai_profile(ai: float, n_elems: int, loopsize: int,
                chip: ChipSpec = TPU_V5E, itemsize: int = 4) -> StepProfile:
    """The reference's historical ``(ai, ...)`` signature: ``ai`` is not
    read, the loopsize sets the intensity (ChipModel.vai_profile)."""
    _deprecated("vai_profile")
    return ChipModel(chip).vai_profile(n_elems, loopsize, itemsize)
