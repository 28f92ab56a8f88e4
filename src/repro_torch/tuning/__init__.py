"""Kernel autotuning that calibrates the power model.

The bridge between the kernel tier and the power tier, in four layers:

* :mod:`repro_torch.tuning.space` — per-kernel config-space enumerators
  with pruning by the card's own rules (thread-block step, grid
  divisibility, instantiated tiles and shared memory) and oracle
  validation against :mod:`repro_torch.kernels.ref` (bit-for-bit for
  VAI/membw, 2e-5 for flash attention);
* :mod:`repro_torch.tuning.harness` — times surviving candidates across a
  frequency sweep: :class:`WallClockBackend` with CUDA events on the card,
  :class:`SimulatedBackend` as a deterministic
  :class:`~repro_torch.power.surface.TransferSurface` timer;
* :mod:`repro_torch.tuning.calibrate` — inverts the (config, freq, time,
  power) grid through ``TransferSurface.infer_profiles`` into per-kernel
  :class:`~repro_torch.core.projection.ResponseTables`, persistable to a
  bit-for-bit JSON cache;
* :mod:`repro_torch.tuning.tuner` — the joint (config, freq) selector under
  any :class:`~repro_torch.power.objectives.Objective`: the fastest cell
  and the lowest-energy cell of the same grid generally differ.

Quick start::

    from repro_torch.tuning import VaiSpace, tune

    result = tune(VaiSpace(loopsizes=(256,)))
    fast = result.best("time")        # classic autotuner pick
    green = result.best("energy")     # usually a different cell
"""
from repro_torch.tuning.space import (Candidate, FlashAttentionSpace,
                                      KernelSpace, MembwSpace, PerfParams,
                                      VaiSpace, ValidationError)
from repro_torch.tuning.harness import (Measurement, SimulatedBackend,
                                        WallClockBackend, default_freq_fracs)
from repro_torch.tuning.calibrate import (SPACES, CalibrationResult,
                                          calibrate, calibrated_tables,
                                          load_calibration,
                                          register_calibration,
                                          save_calibration)
from repro_torch.tuning.tuner import (STEP_TIME, TunedCell, TuningResult, tune)

__all__ = [
    # space
    "Candidate", "KernelSpace", "PerfParams", "ValidationError",
    "VaiSpace", "MembwSpace", "FlashAttentionSpace",
    # harness
    "Measurement", "SimulatedBackend", "WallClockBackend",
    "default_freq_fracs",
    # calibrate
    "SPACES", "CalibrationResult", "calibrate", "calibrated_tables",
    "load_calibration", "register_calibration", "save_calibration",
    # tuner
    "STEP_TIME", "TunedCell", "TuningResult", "tune",
]
