"""Hardware constants + measured power-management response tables.

A copy of the reference package's chip registry, kept here so that this
package imports nothing from it. Three kinds of entries matter:

* **AMD MI250X GCD** — the paper's subject. Its frequency/power-cap response
  is taken *verbatim* from the paper's Table III (measured on Frontier); the
  modal decomposition boundaries come from Table IV. This path is what makes
  the reproduction of Tables V/VI exact.
* **NVIDIA H100 SXM** — the card this package runs on and its default chip.
  No public Table-III equivalent exists, so its response surface is derived
  analytically from the roofline position (see
  :mod:`repro_torch.core.power_model`), or calibrated from kernel timings
  taken on the card (:mod:`repro_torch.tuning.calibrate`).
* the other registry rows are datasheet specs kept for cross-chip
  projection.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

GiB = 1024 ** 3
MiB = 1024 ** 2


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float          # FLOP/s at nominal frequency (dense bf16)
    hbm_bw: float              # bytes/s
    hbm_bytes: int
    ici_bw: float              # bytes/s per link (interconnect)
    vmem_bytes: int            # on-chip fast memory (the L2 on a GPU)
    idle_w: float
    tdp_w: float
    f_nominal_mhz: int
    f_min_mhz: int


# Datasheet row kept for cross-chip projection; the power envelope numbers
# are model parameters.
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * GiB,
    ici_bw=50e9,
    vmem_bytes=128 * MiB,
    idle_w=35.0,
    tdp_w=220.0,
    f_nominal_mhz=1700,
    f_min_mhz=700,
)

# MI250X *GCD* (one of two per package): paper Table I.
MI250X_GCD = ChipSpec(
    name="mi250x-gcd",
    peak_flops=23.9e12,        # FP64 vector peak, the paper's roofline unit
    hbm_bw=1.6e12,
    hbm_bytes=64 * GiB,
    ici_bw=50e9,
    vmem_bytes=16 * MiB,       # L2 cache (paper Fig. 6 boundary)
    idle_w=89.0,               # "idle power of a GPU is between 88 to 90 W"
    tdp_w=560.0,
    f_nominal_mhz=1700,
    f_min_mhz=700,
)

# H100 SXM and MI300X: no public Table-III equivalent either, so their
# response surfaces are model-derived from the roofline position.
# Datasheet points: dense bf16 peak, HBM3(E) bandwidth, board TDP; the clock
# range spans the advertised boost ceiling down to the lowest DVFS state.
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops=989e12,         # dense bf16 (no sparsity)
    hbm_bw=3.35e12,
    hbm_bytes=80 * GiB,
    ici_bw=450e9,              # NVLink4, one direction
    vmem_bytes=50 * MiB,       # L2
    idle_w=90.0,
    tdp_w=700.0,
    f_nominal_mhz=1980,
    f_min_mhz=210,
)

MI300X = ChipSpec(
    name="mi300x",
    peak_flops=1307e12,        # dense bf16
    hbm_bw=5.3e12,
    hbm_bytes=192 * GiB,
    ici_bw=128e9,              # Infinity Fabric, per link
    vmem_bytes=256 * MiB,      # Infinity Cache
    idle_w=130.0,
    tdp_w=750.0,
    f_nominal_mhz=2100,
    f_min_mhz=500,
)

CHIPS = {c.name: c for c in (TPU_V5E, MI250X_GCD, H100_SXM, MI300X)}

# ---------------------------------------------------------------------------
# Paper Table III — measured relative response (% of the uncapped run) on
# MI250X, averaged across arithmetic intensities (VAI) and data sizes (MB).
#   columns: (avg_power_pct, runtime_pct, avg_energy_pct)
# ---------------------------------------------------------------------------
FREQ_RESPONSE_VAI: Dict[int, Tuple[float, float, float]] = {
    1700: (100.0, 100.0, 100.0),
    1500: (83.7, 112.8, 94.4),
    1300: (68.2, 129.8, 88.6),
    1100: (61.8, 152.2, 94.0),
    900: (53.3, 182.4, 97.3),
    700: (46.0, 231.0, 106.3),
}
FREQ_RESPONSE_MB: Dict[int, Tuple[float, float, float]] = {
    1700: (100.0, 100.0, 100.0),
    1500: (87.2, 99.7, 86.9),
    1300: (84.5, 99.5, 84.3),
    1100: (84.9, 98.9, 83.8),
    900: (79.7, 99.0, 79.7),
    700: (82.9, 99.1, 95.7),
}
POWER_RESPONSE_VAI: Dict[int, Tuple[float, float, float]] = {
    560: (100.0, 100.0, 100.0),
    500: (99.3, 100.4, 99.7),
    400: (90.8, 105.2, 95.0),
    300: (72.7, 128.4, 91.3),
    200: (49.3, 222.3, 105.7),
}
POWER_RESPONSE_MB: Dict[int, Tuple[float, float, float]] = {
    560: (100.0, 100.0, 100.0),
    500: (100.0, 99.9, 92.2),
    400: (99.0, 100.1, 93.6),
    300: (99.0, 100.0, 94.7),
    200: (85.0, 125.7, 84.6),
}

# ---------------------------------------------------------------------------
# Paper Table IV — modal decomposition of 3 months of Frontier GPU telemetry.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Mode:
    idx: int
    name: str
    lo_w: float                # inclusive lower power bound
    hi_w: float                # exclusive upper power bound
    gpu_hours_pct: float


MODES: Tuple[Mode, ...] = (
    Mode(1, "latency/network/io-bound", 0.0, 200.0, 29.8),
    Mode(2, "memory-intensive", 200.0, 420.0, 49.5),
    Mode(3, "compute-intensive", 420.0, 560.0, 19.5),
    Mode(4, "boosted-frequency", 560.0, float("inf"), 1.1),
)
MODE_BY_NAME = {m.name: m for m in MODES}

# ---------------------------------------------------------------------------
# Fleet energies (MWh) decoded from Table V (DESIGN.md §1.1): savings_m(c) =
# E_m * (1 - energy_pct(c, m)).  Over-determined fit across 10 published cells.
# ---------------------------------------------------------------------------
TOTAL_FLEET_ENERGY_MWH = 16820.0
FLEET_ENERGY_MI_MWH = 7085.0
FLEET_ENERGY_CI_MWH = 2059.0

# Paper Table V published cells, used as regression targets in tests.
PAPER_TABLE_V_FREQ: Dict[int, Dict[str, float]] = {
    # freq: CI MWh, MI MWh, TS MWh, savings %, dT %, savings@dT=0 %
    1500: dict(ci=115.3, mi=928.2, ts=1043.5, sav=6.2, dt=1.7, sav0=5.5),
    1300: dict(ci=234.7, mi=1112.4, ts=1347.1, sav=8.0, dt=4.1, sav0=6.6),
    1100: dict(ci=123.5, mi=1154.9, ts=1278.4, sav=7.6, dt=7.1, sav0=6.8),
    900: dict(ci=55.6, mi=1438.3, ts=1493.9, sav=8.8, dt=11.2, sav0=8.5),
    700: dict(ci=-129.7, mi=304.6, ts=174.9, sav=1.0, dt=17.7, sav0=1.8),
}
PAPER_TABLE_V_POWER: Dict[int, Dict[str, float]] = {
    500: dict(ci=6.17, mi=552.65, ts=558.83, sav=3.32, dt=0.1, sav0=3.2),
    400: dict(ci=102.96, mi=453.46, ts=556.42, sav=3.30, dt=0.7, sav0=2.6),
    300: dict(ci=179.16, mi=375.52, ts=554.68, sav=3.30, dt=3.83, sav0=2.2),
    200: dict(ci=-117.38, mi=1091.14, ts=973.75, sav=5.79, dt=16.53, sav0=6.4),
}

# Frontier fleet geometry (paper Table I / VII).
FRONTIER_NODES = 9408
GCDS_PER_NODE = 8
JOB_SIZE_CLASSES: Mapping[str, Tuple[int, int, int]] = {
    # class: (min_nodes, max_nodes, max_walltime_hours)
    "A": (5645, 9408, 12),
    "B": (1882, 5644, 12),
    "C": (184, 1881, 12),
    "D": (92, 183, 6),
    "E": (1, 91, 2),
}


def interp_response(table: Mapping[int, Tuple[float, float, float]],
                    cap: float) -> Tuple[float, float, float]:
    """Piecewise-linear interpolation of a Table-III response column at an
    arbitrary cap value (power %, runtime %, energy %)."""
    keys = sorted(table)
    if cap <= keys[0]:
        return table[keys[0]]
    if cap >= keys[-1]:
        return table[keys[-1]]
    for lo, hi in zip(keys, keys[1:]):
        if lo <= cap <= hi:
            t = (cap - lo) / (hi - lo)
            a, b = table[lo], table[hi]
            return tuple(a[i] + t * (b[i] - a[i]) for i in range(3))  # type: ignore
    raise AssertionError("unreachable")
