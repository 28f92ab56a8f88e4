"""`repro_torch.power` — the single public surface for power management.

The paper's core loop is: profile a step, pick a frequency/cap, record
telemetry, project fleet savings. This package exposes each stage as one
object and composes them, on ``torch`` tensors:

chip       — :class:`ChipModel`: chip-bound (time, power, energy) transfer
             functions under DVFS and power caps (scalar views of the
             surface below)
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
fleet      — :class:`FleetAnalysis`: chained telemetry -> modal ->
             projection pipeline (``from_store(ts).decompose().project(caps)``)
jobs       — job-level fleet: :class:`JobTable` (synthetic multi-job
             workload sampled from the model configs / job-tagged telemetry
             ingestion) + per-job class assignment and the per-class cap
             schedule (``FleetAnalysis.from_jobs(table).job_report()``)
stream     — out-of-core telemetry: :class:`SampleShard` sources
             (tensors, JSONL, ``.npz`` spills, job tables),
             :class:`StreamingTelemetry` accumulators bit-for-bit with the
             batch pipeline, and counterfactual :func:`replay` of a
             recorded trace under any policy x chip
broker     — the online fleet power broker: :class:`ClusterTrace`,
             :func:`simulate_cluster` (event loop, FCFS + EASY backfill,
             one facility budget) and the uniform / greedy /
             class-schedule / oracle / policy brokers
scenarios  — the declarative what-if surface: :class:`Workload`,
             :class:`Scenario`, :class:`Study` (batched grid execution) and
             :class:`StudyResult` (``compare()`` / ``best("dT<=0.5")`` /
             ``pivot()`` / ``pareto()`` / ``confidence()``); every
             ``tables=`` spelling resolves through one
             :func:`resolve_tables`

The legacy entry point ``repro_torch.core.governor.PowerGovernor`` (with
its ``GovernorConfig``) remains as a thin shim over this layer.

Typical use:

    from repro_torch.power import EnergySession, FleetAnalysis, StepProfile

    with EnergySession(policy="energy-aware") as sess:
        for step in range(n_steps):
            ...
            sess.observe(step, profile, wall_s)
    rows = sess.fleet().decompose().project([900])
"""
from repro_torch.core.governor import (  # noqa: F401
    Decision, GovernorConfig, PowerActuator, PowerGovernor,
    SimulatedActuator, sweep_decision)
from repro_torch.core.modal import (  # noqa: F401
    BatchModalDecomposition, decompose_batch)
from repro_torch.core.projection import (  # noqa: F401
    BatchProjection, ProjectionRow, ResponseTables, builtin_tables,
    domain_targeted_project, project, project_batch, validate_against_paper)
from repro_torch.core.telemetry import (  # noqa: F401
    JobLog, JobRecord, StepSample, TelemetryStore)
from repro_torch.power.chip import (  # noqa: F401
    CHIPS, ChipModel, ChipSpec, MI250X_GCD, MODES, Mode, StepProfile,
    TPU_V5E, profile_from_roofline)
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
from repro_torch.power.jobs import (  # noqa: F401
    ClassReport, FleetJobsReport, JOB_CLASSES, JobTable, JobTrace,
    class_cap_report, classify_jobs, synth_job_traces)
from repro_torch.power.fleet import FleetAnalysis  # noqa: F401
from repro_torch.power.stream import (  # noqa: F401
    ReplayReport, SampleShard, StreamingModal, StreamingTelemetry,
    iter_array, iter_jobs, iter_jsonl, iter_npz, iter_store, replay,
    write_jsonl)
from repro_torch.power.broker import (  # noqa: F401
    BROKERS, BrokerReport, BrokerView, ClassScheduleBroker, ClusterTrace,
    GreedyValueBroker, OracleBroker, PolicyBroker, UniformBroker,
    get_broker, simulate_cluster)
from repro_torch.power.scenarios import (  # noqa: F401
    CellResult, ConfidenceInterval, Scenario, Study, StudyResult, TablesLike,
    Workload, cap_label, resolve_tables)

__all__ = [
    # chip model
    "CHIPS", "ChipModel", "ChipSpec", "MI250X_GCD", "MODES", "Mode",
    "StepProfile", "TPU_V5E", "profile_from_roofline",
    # tensor transfer surface + cross-chip response tables
    "BatchDecision", "ProfileArray", "ResponseTables", "TransferSurface",
    "builtin_tables", "response_table",
    # optimization objectives (one registry behind every sweep/selection)
    "GridDecisions", "OBJECTIVES", "Objective", "SWEEP_OBJECTIVES",
    "check_objective", "decision_grid", "get_objective",
    # policies
    "POLICIES", "PowerPolicy", "NominalPolicy", "StaticFrequencyPolicy",
    "PowerCapPolicy", "EnergyAwarePolicy", "get_policy",
    # decisions / actuation / legacy governor
    "Decision", "GovernorConfig", "PowerActuator", "PowerGovernor",
    "SimulatedActuator", "sweep_decision",
    # session + telemetry
    "EnergySession", "JobLog", "JobRecord", "StepSample", "TelemetryStore",
    # fleet pipeline
    "FleetAnalysis", "ProjectionRow", "domain_targeted_project", "project",
    "validate_against_paper",
    # job-level fleet (per-job tensor core + class cap schedule)
    "BatchModalDecomposition", "BatchProjection", "ClassReport",
    "FleetJobsReport", "JOB_CLASSES", "JobTable", "JobTrace",
    "class_cap_report", "classify_jobs", "decompose_batch", "project_batch",
    "synth_job_traces",
    # streaming ingestion + counterfactual replay
    "ReplayReport", "SampleShard", "StreamingModal", "StreamingTelemetry",
    "iter_array", "iter_jobs", "iter_jsonl", "iter_npz", "iter_store",
    "replay", "write_jsonl",
    # online fleet power broker (event-driven cluster simulation)
    "BROKERS", "BrokerReport", "BrokerView", "ClassScheduleBroker",
    "ClusterTrace", "GreedyValueBroker", "OracleBroker", "PolicyBroker",
    "UniformBroker", "get_broker", "simulate_cluster",
    # declarative scenario studies (the grid surface over everything above)
    "CellResult", "ConfidenceInterval", "Scenario", "Study", "StudyResult",
    "TablesLike", "Workload", "cap_label", "resolve_tables",
    # this package's own additions: the batched decision pass, the
    # objective grid's argbest and the family response-table engine
    "decide_batch", "family_response_tables", "grid_argbest",
]
