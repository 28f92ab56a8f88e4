"""Public door to the chip-bound power model.

``ChipModel`` binds a :class:`ChipSpec` once so call sites stop threading a
``chip`` argument through every free function:

    chip = ChipModel(H100_SXM)          # or ChipModel("h100-sxm")
    t = chip.step_time(profile, 0.7)
    p = chip.power_w(profile, 0.7)
    e = chip.energy_j(profile, 0.7)
    m = chip.classify_mode(profile)
    f = chip.freq_for_power_cap(profile, cap_w=400.0)

The implementation lives in :mod:`repro_torch.core.power_model`. Each scalar
method is the single-element view of the chip's tensor
:class:`repro_torch.power.surface.TransferSurface` (``chip.surface()``),
which answers the same questions over whole ``(profiles…, freqs)`` grids in
one pass.
"""
from repro_torch.core.hardware import (  # noqa: F401
    CHIPS, ChipSpec, MI250X_GCD, MODES, Mode, TPU_V5E)
from repro_torch.core.power_model import (  # noqa: F401
    ChipModel, StepProfile, profile_from_roofline)

__all__ = [
    "CHIPS", "ChipSpec", "ChipModel", "MI250X_GCD", "MODES", "Mode",
    "StepProfile", "TPU_V5E", "profile_from_roofline",
]
