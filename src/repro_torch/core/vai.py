"""VAI sweep (paper §IV-A, Figs. 4/5) — runs the VAI kernel across
arithmetic intensities under every frequency and power cap, recording
runtime / power / energy via the calibrated power model (clocks and caps
cannot be set without root, so the calibrated
:class:`repro_torch.core.power_model.ChipModel` stands in for the rails; on
hardware with an actuator the same sweep reads the platform's power
channel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import DEFAULT_DEVICE, as_device
from repro_torch.configs.paper_vai import VAISuiteConfig
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel
from repro_torch.kernels import vai as vai_kernel

#: largest loopsize whose kernel run is checked when the sweep runs on CPU
#: tensors (the plain version walks the loop step by step there); on the
#: card every unique loopsize is checked
CPU_VALIDATE_MAX_LOOPSIZE = 64


@dataclass
class VAIPoint:
    ai: float                 # flops/byte
    loopsize: int
    freq_mhz: int
    power_cap_w: Optional[float]
    tflops: float
    gbytes_s: float
    power_w: float
    time_rel: float           # runtime normalized to the uncapped run
    energy_rel: float

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


def _loopsize_for(ai: float, itemsize: int = 4) -> int:
    # AI = 2L / (4 accesses * itemsize)  ->  L = AI * 2 * itemsize.
    # Python's round (half to even): AI = 1/16 gives round(0.5) == 0, the
    # stream copy, as in the reference sweep.
    return int(round(ai * 2 * itemsize))


def run_sweep(cfg: VAISuiteConfig = VAISuiteConfig(),
              chip: ChipSpec = H100_SXM,
              execute_kernel: bool = True,
              device=DEFAULT_DEVICE) -> List[VAIPoint]:
    """Full (AI x frequency) and (AI x power-cap) sweep.

    Seated on the :mod:`repro_torch.tuning` harness: the kernel's
    :class:`~repro_torch.tuning.VaiSpace` enumerates one candidate per
    intensity (at the kernel's default block) and supplies its analytic
    profile under :meth:`PerfParams.ideal` — bit-for-bit
    ``ChipModel.vai_profile`` — while the deterministic
    :class:`~repro_torch.tuning.SimulatedBackend` answers every (freq, cap)
    point. ``execute_kernel`` runs the kernel on ``device`` and checks it
    against :mod:`repro_torch.kernels.ref`: every unique loopsize on the
    card, those up to :data:`CPU_VALIDATE_MAX_LOOPSIZE` on the CPU.
    """
    from repro_torch.tuning.harness import SimulatedBackend
    from repro_torch.tuning.space import PerfParams, VaiSpace

    device = as_device(device)
    model = ChipModel(chip)
    chip = model.spec
    loopsizes = [_loopsize_for(ai) for ai in cfg.intensities]
    space = VaiSpace(n_elems=cfg.elements, loopsizes=loopsizes,
                     block_rows_options=(vai_kernel.DEFAULT_BLOCK_ROWS,),
                     chip=chip, device=device)
    backend = SimulatedBackend(model, perf=PerfParams.ideal(), device=device)
    candidates, pruned = space.enumerate_all()
    if pruned:
        reasons = "; ".join(f"{dict(cfg_)}: {why}" for cfg_, why in pruned)
        raise ValueError(
            f"VAI sweep configuration does not tile the kernel: {reasons}")

    points: List[VAIPoint] = []
    validated: set = set()
    max_validated = None if device.type != "cpu" else CPU_VALIDATE_MAX_LOOPSIZE
    for ai, cand in zip(cfg.intensities, candidates):
        L = cand.get("loopsize")
        if execute_kernel and L not in validated and (
                max_validated is None or L <= max_validated):
            space.validate(cand)
            validated.add(L)
        profile = space.profile(cand, model, backend.perf)
        t0, p0 = backend.measure_one(space, cand, 1.0)
        e0 = p0 * t0
        flops, byts = cand.flops, cand.hbm_bytes

        for f_mhz in cfg.frequencies_mhz:
            frac = f_mhz / chip.f_nominal_mhz * (
                chip.f_nominal_mhz / 1700)   # grid defined on 1700 nominal
            frac = min(max(frac, chip.f_min_mhz / chip.f_nominal_mhz), 1.0)
            t, p = backend.measure_one(space, cand, frac)
            points.append(VAIPoint(
                ai=ai, loopsize=L, freq_mhz=f_mhz, power_cap_w=None,
                tflops=flops / t / 1e12, gbytes_s=byts / t / 1e9,
                power_w=p, time_rel=t / t0, energy_rel=p * t / e0))

        for cap_frac in (1.0, 0.9, 0.72, 0.54, 0.36, 0.25, 0.18):
            cap_w = cap_frac * chip.tdp_w
            frac = model.freq_for_power_cap(profile, cap_w)
            t, p = backend.measure_one(space, cand, frac)
            points.append(VAIPoint(
                ai=ai, loopsize=L, freq_mhz=int(frac * chip.f_nominal_mhz),
                power_cap_w=cap_w,
                tflops=flops / t / 1e12, gbytes_s=byts / t / 1e9,
                power_w=p, time_rel=t / t0, energy_rel=p * t / e0))
    space.release()
    return points


def _mean(xs: List[float]) -> float:
    """Mean of a short list of python floats, added left to right."""
    total = 0.0
    for x in xs:
        total += x
    return total / len(xs)


def response_table(points: List[VAIPoint], by: str = "freq"
                   ) -> Dict[float, Dict[str, float]]:
    """Average over arithmetic intensities -> the paper's Table III format:
    cap -> (power %, runtime %, energy %)."""
    groups: Dict[float, List[VAIPoint]] = {}
    for p in points:
        if by == "freq" and p.power_cap_w is None:
            groups.setdefault(p.freq_mhz, []).append(p)
        elif by == "power" and p.power_cap_w is not None:
            groups.setdefault(round(p.power_cap_w, 1), []).append(p)
    base_key = max(groups)
    base_power = _mean([p.power_w for p in groups[base_key]])
    out = {}
    for cap, ps in sorted(groups.items(), reverse=True):
        out[cap] = {
            "power_pct": 100.0 * _mean([p.power_w for p in ps]) / base_power,
            "runtime_pct": 100.0 * _mean([p.time_rel for p in ps]),
            "energy_pct": 100.0 * _mean([p.energy_rel for p in ps]),
        }
    return out
