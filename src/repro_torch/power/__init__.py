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
policies   — :class:`PowerPolicy` protocol + ``nominal`` / ``static`` /
             ``power-cap`` / ``energy-aware``, selected by name via
             :func:`get_policy`; each vectorizes as ``decide_batch``
session    — :class:`EnergySession`: policy + actuator + telemetry behind
             one ``observe(step, profile, wall_s)`` call (or one batched
             ``observe_many(profiles)``)
"""
from repro_torch.core.power_model import ChipModel, StepProfile  # noqa: F401
from repro_torch.power.objectives import (  # noqa: F401
    OBJECTIVES, SWEEP_OBJECTIVES, GridDecisions, Objective, check_objective,
    decision_grid, get_objective, grid_argbest)
from repro_torch.power.surface import (  # noqa: F401
    BatchDecision, ProfileArray, TransferSurface, family_response_tables,
    response_table)
from repro_torch.power.policies import (  # noqa: F401
    POLICIES, EnergyAwarePolicy, NominalPolicy, PowerCapPolicy, PowerPolicy,
    StaticFrequencyPolicy, decide_batch, get_policy)
from repro_torch.power.session import EnergySession  # noqa: F401
