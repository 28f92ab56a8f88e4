"""`repro_torch.power` — the tensor surface of the power model.

surface    — :class:`TransferSurface`: the chip's transfer functions over
             broadcastable ``(profiles…, freqs)`` tensors in one pass,
             vectorized ``sweep_decisions`` / ``freq_for_power_cap``, and
             :func:`response_table` — model-derived Table III columns for
             any registered chip
objectives — the optimization-metric registry: :class:`Objective` scores
             ``(energy, time, power)`` sweeps and projection rows;
             :func:`decision_grid` evaluates all metrics x caps batched on
             the surface
"""
from repro_torch.core.power_model import ChipModel, StepProfile  # noqa: F401
from repro_torch.power.objectives import (  # noqa: F401
    OBJECTIVES, SWEEP_OBJECTIVES, GridDecisions, Objective, check_objective,
    decision_grid, get_objective, grid_argbest)
from repro_torch.power.surface import (  # noqa: F401
    BatchDecision, ProfileArray, TransferSurface, family_response_tables,
    response_table)
