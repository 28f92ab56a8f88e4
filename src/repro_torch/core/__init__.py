"""The engines of the power-management pipeline.

hardware     — chip specs + the paper's measured MI250X response tables
power_model  — ChipModel: chip-bound scalar views of the tensor transfer
               surface in repro_torch.power.surface (time/power/energy
               under DVFS and caps)
governor     — Decision + sweep_decision, the scalar frequency sweep, and
               PowerGovernor / GovernorConfig / SimulatedActuator, the
               reference's online governor
telemetry    — step samples, job records and their stores
modal        — fleet power-histogram modal decomposition (Table IV); the
               batched (jobs, samples) core is decompose_batch, the flat
               path its single-row special case
projection   — energy-savings projection engine (Tables V/VI);
               project_batch vectorizes it over per-job energies and takes
               ResponseTables (builtin_tables = measured MI250X Table III,
               repro_torch.power.surface.response_table = model-derived for
               any chip)
vai          — VAI roofline sweep over the CUDA kernel
"""
from repro_torch.core import hardware  # noqa: F401
from repro_torch.core import modal  # noqa: F401
from repro_torch.core import power_model  # noqa: F401
from repro_torch.core import projection  # noqa: F401
from repro_torch.core.governor import (  # noqa: F401
    Decision, GovernorConfig, PowerGovernor, SimulatedActuator,
    sweep_decision)
from repro_torch.core.power_model import ChipModel, StepProfile  # noqa: F401
from repro_torch.core.telemetry import (  # noqa: F401
    JobLog, JobRecord, StepSample, TelemetryStore)
