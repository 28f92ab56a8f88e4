"""repro_torch's declarative Study surface (``power/scenarios.py``) against
the reference package, on CPU float64 tensors fed the same numpy inputs —
the projection, schedule, replay and broker cases of
``tests/test_scenarios.py`` and the confidence cases of
``tests/test_objectives.py``. ``Study(executor=/devices=)`` runs its replay
cells through the port's sharded executor, exactly as without it.

Stated tolerances: every Study cell equals the port's own standalone call
(``FleetAnalysis.project`` / ``job_report``) exactly — the Study only
groups work. Against the reference, cells, their detail objects, both CI
methods and ``best()`` picks agree to rtol 1e-12 with equal classes, caps,
``meets_dt0`` and picked cells. The bootstrap draws its count vectors from
the reference's ``np.random.default_rng(seed)`` sequence, so the intervals
are comparable number for number. Replay cells agree with the reference to
rtol 1e-12 with equal job rows (the device's sums take another order than
numpy's); broker cells have equal event counts, makespans and waits and
savings to rtol 1e-12.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest

import repro.power as rp
from repro.core.hardware import MI250X_GCD as REF_MI250X
from repro.core.modal import synth_fleet_powers
from repro.core.telemetry import StepSample as RefStepSample
from repro.core.telemetry import TelemetryStore as RefTelemetryStore
from repro_torch.core.hardware import H100_SXM, MI250X_GCD, TPU_V5E
from repro_torch.core.projection import project
from repro_torch.core.telemetry import StepSample, TelemetryStore
from repro_torch.parallel import ShardedExecutor
from repro_torch.power import (FleetAnalysis, FleetJobsReport,
                               ResponseTables, Scenario, Study, StudyResult,
                               Workload, builtin_tables, cap_label,
                               resolve_tables, response_table)

CPU = "cpu"
RTOL = 1e-12
CAP_GRID = [1500.0, 1300.0, 1100.0, 900.0, 700.0]


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=1e-300)


def _same_detail(got, want):
    g = dataclasses.asdict(got) if dataclasses.is_dataclass(got) else got
    w = dataclasses.asdict(want) if dataclasses.is_dataclass(want) else want
    if isinstance(w, dict):
        assert g.keys() == w.keys()
        for k in w:
            _same_detail(g[k], w[k])
    elif isinstance(w, (list, tuple)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _same_detail(a, b)
    elif isinstance(w, float) and not isinstance(w, bool):
        _close(g, w)
    else:
        assert g == w, (g, w)


def _same_cells(res, ref):
    """A port StudyResult against the reference's: index columns equal,
    metrics to rtol 1e-12, detail objects field by field."""
    assert len(res) == len(ref)
    for a, b in zip(res, ref):
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        for k, v in db.items():
            if isinstance(v, float) and not isinstance(v, bool):
                if math.isnan(v):
                    assert math.isnan(da[k]), k
                else:
                    _close(da[k], v)
            else:
                assert da[k] == v, (k, da[k], v)
        _same_detail(a.detail, b.detail)


# ------------------------------------------------------ paired workloads
def _store_pair(seed: int = 0, name: str = "store"):
    """The same job-tagged TelemetryStore workload in both packages."""
    out = []
    for store_cls, sample_cls in ((TelemetryStore, StepSample),
                                  (RefTelemetryStore, RefStepSample)):
        rng = np.random.default_rng(seed)
        ts = store_cls(window_s=15.0)
        t = 0.0
        for jid in ("jobA", "jobB", "jobC"):
            mu = float(rng.uniform(150, 520))
            for i in range(40):
                p = float(np.clip(rng.normal(mu, 30), 95, 600))
                ts.record(sample_cls(step=i, t=t, duration_s=15.0,
                                     power_w=p, energy_j=p * 15.0, mode=2,
                                     freq_mhz=1700, job_id=jid))
                t += 15.0
        ts.flush()
        out.append(ts)
    return (Workload.from_store(out[0], chip=MI250X_GCD, name=name,
                                device=CPU),
            rp.Workload.from_store(out[1], chip=REF_MI250X, name=name))


def _jobs_pair(n: int, seed: int, name=None, **kw):
    return (Workload.synthetic_jobs(n, seed=seed, name=name, device=CPU,
                                    **kw),
            rp.Workload.synthetic_jobs(n, seed=seed, name=name, **kw))


def _powers_pair(n: int, seed: int, name: str = "powers"):
    p = synth_fleet_powers(n, seed=seed)
    return (Workload.from_powers(p, name=name, device=CPU),
            rp.Workload.from_powers(p, name=name))


def _study_pair(pair, **axes):
    return (Study(workloads=[pair[0]], **axes).run(),
            rp.Study(workloads=[pair[1]], **axes).run())


# --------------------------------------------------------------- the resolver
def test_resolve_tables_measured_and_explicit():
    assert resolve_tables(None) is None
    assert resolve_tables("measured", kind="power") is None
    rt = response_table("tpu-v5e", kind="freq", device=CPU)
    assert resolve_tables(rt) is rt
    with pytest.raises(ValueError, match="keyed"):
        resolve_tables(rt, kind="power")
    with pytest.raises(TypeError, match="resolve response tables"):
        resolve_tables(3.14)


@pytest.mark.parametrize("kind", ["freq", "power"])
def test_resolve_tables_model_derived_is_cached(kind):
    a = resolve_tables("tpu-v5e", kind=kind, device=CPU)
    b = resolve_tables(TPU_V5E, kind=kind, device=CPU)
    assert a is b                      # lru-cached by (chip, kind, device)
    assert a.source == "model:tpu-v5e"
    ref = response_table("tpu-v5e", kind=kind, device=CPU)
    assert a.vai == ref.vai and a.mb == ref.mb
    want = rp.resolve_tables("tpu-v5e", kind=kind)
    assert a.vai.keys() == want.vai.keys()
    _close([a.vai[k] for k in want.vai], [want.vai[k] for k in want.vai])
    _close([a.mb[k] for k in want.mb], [want.mb[k] for k in want.mb])


def test_resolve_tables_auto_rule():
    assert resolve_tables("auto") is None
    assert resolve_tables("auto", chip=MI250X_GCD) is None
    rt = resolve_tables("auto", chip="tpu-v5e", kind="freq", device=CPU)
    assert rt is not None and rt.source == "model:tpu-v5e"
    assert rt is resolve_tables("tpu-v5e", device=CPU)


def test_resolve_tables_calibrated_spelling():
    """``"calibrated:<kernel>"``: a registered calibration is served as it
    is; otherwise the simulated default of this package's tuner."""
    from repro_torch.tuning import (SimulatedBackend, VaiSpace, calibrate,
                                    calibrated_tables, register_calibration,
                                    tune)
    cal_mod = importlib.import_module("repro_torch.tuning.calibrate")
    spec = dataclasses.replace(H100_SXM, name="h100-sxm-test")
    default = resolve_tables("calibrated:vai", chip=spec, device=CPU)
    assert default is calibrated_tables("vai", chip=spec, device=CPU)
    space = VaiSpace(n_elems=1 << 12, loopsizes=[0, 8, 64], chip=spec,
                     device=CPU)
    cal = register_calibration(calibrate(
        tune(space, SimulatedBackend(spec, device=CPU)).measurement))
    try:
        got = resolve_tables("calibrated:vai", chip=spec, device=CPU)
        assert got is cal.tables
        w = Workload.synthetic_jobs(40, seed=5, device=CPU)
        res = Study(scenarios=[Scenario(w, chip=spec, cap=c,
                                        tables="calibrated:vai")
                               for c in (1500.0, None)]).run()
        assert res[0].tables == cal.tables.source
        assert res[0].detail == w.fleet().project(
            [1500.0], tables=cal.tables)[0]
    finally:
        cal_mod._REGISTRY.pop(("vai", "freq", spec), None)


# ------------------------------------------------------------- cell semantics
def test_scenario_cell_shapes():
    w = Workload.paper_fleet(device=CPU)
    assert Scenario(w, cap=900).cell == "project"
    assert Scenario(w, cap=(1300, 900)).cell == "schedule"
    assert Scenario(w, cap=None).cell == "schedule"
    assert Scenario(w, policy="energy-aware").cell == "replay"
    assert Scenario(w, broker="greedy").cell == "broker"


def test_paper_fleet_workload_reproduces_table_v():
    """Scenario(paper_fleet, cap) == projection.project on the paper's
    published fleet constants — and the reference's cells."""
    res = Study(workloads=[Workload.paper_fleet(device=CPU)],
                caps=CAP_GRID).run()
    legacy = project(CAP_GRID, "freq", device=CPU)
    assert len(res) == len(legacy)
    for cell, row in zip(res, legacy):
        assert cell.savings_pct == row.savings_pct
        assert cell.dt_pct == row.dt_pct
        assert cell.savings_mwh == row.total_mwh
        assert cell.savings_dt0_pct == row.savings_dt0_pct
        assert cell.detail == row
    _same_cells(res, rp.Study(workloads=[rp.Workload.paper_fleet()],
                              caps=CAP_GRID).run())


def test_energies_only_workload_rejects_replay_and_schedule():
    w = Workload.paper_fleet(device=CPU)
    with pytest.raises(ValueError, match="energies only"):
        Scenario(w, policy="energy-aware").run()   # replay needs a stream
    with pytest.raises(ValueError, match="energies only"):
        rp.Scenario(rp.Workload.paper_fleet(), policy="energy-aware").run()
    with pytest.raises(ValueError, match="energies only"):
        Scenario(w, cap=None).run()    # schedule needs samples/jobs


def test_flat_workload_rejects_schedule_cells():
    w = _powers_pair(2000, seed=0)[0]
    with pytest.raises(ValueError, match="per-job"):
        Scenario(w, cap=tuple(CAP_GRID)).run()


def test_store_workload_is_a_frozen_snapshot():
    """Recording into the live store after Workload.from_store must not
    leak into the workload's cells."""
    w = _store_pair(seed=2)[0]
    total_before = w.fleet()._decomposition().total_energy_mwh
    live = TelemetryStore(window_s=15.0)
    t = 0.0
    for jid in ("a", "b"):
        for i in range(30):
            live.record(StepSample(step=i, t=t, duration_s=15.0,
                                   power_w=300.0, energy_j=4500.0, mode=2,
                                   freq_mhz=1700, job_id=jid))
            t += 15.0
    w2 = Workload.from_store(live, name="s", device=CPU)
    for i in range(20):
        live.record(StepSample(step=i, t=1e6 + i * 15.0, duration_s=15.0,
                               power_w=400.0, energy_j=6000.0, mode=2,
                               freq_mhz=1700, job_id="late"))
    live.flush()
    assert "late" not in w2.fleet().jobs.job_ids            # jobs frozen
    assert w2.fleet().powers.numel() == 60              # one window a step
    assert w.fleet()._decomposition().total_energy_mwh == total_before


def _same_replay(got, want):
    """Two ReplayReports: names, counts and job order equal; energies,
    times and the derived percentages to rtol 1e-12; the recorded modal
    split bit for bit."""
    assert (got.policy, got.chip, got.record_chip, got.n_samples) \
        == (want.policy, want.chip, want.record_chip, want.n_samples)
    for k in ("energy_rec_j", "energy_base_j", "energy_new_j", "time_rec_s",
              "time_new_s", "savings_pct", "dt_pct", "model_bias_pct"):
        _close(getattr(got, k), getattr(want, k))
    assert [(r.job_id, r.n_samples) for r in got.jobs] \
        == [(r.job_id, r.n_samples) for r in want.jobs]
    for a, b in zip(got.jobs, want.jobs):
        _same_detail(a, b)
    assert dataclasses.asdict(got.recorded) \
        == dataclasses.asdict(want.recorded)
    _same_detail(got.replayed, want.replayed)


def _same_broker(got, want):
    """Two BrokerReports: every discrete outcome and time equal, energies
    to rtol 1e-12."""
    for k in ("broker", "kind", "chip", "n_nodes", "n_jobs", "n_events",
              "makespan_s", "mean_wait_s", "n_scaled_events",
              "budget_exceeded", "bin_caps", "offline", "budget_mw",
              "throughput_jobs_per_h", "node_util_pct", "dt_pct"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("baseline_mwh", "savings_mwh", "savings_pct",
              "peak_alloc_w", "bin_energy_mwh", "bin_savings_mwh"):
        _close(getattr(got, k), getattr(want, k))


def _same_dynamic_cells(res, ref):
    """Replay / broker cells: the cell columns as in :func:`_same_cells`,
    the detail reports by their own comparison."""
    assert len(res) == len(ref)
    for a, b in zip(res, ref):
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        for k, v in db.items():
            if isinstance(v, float) and not isinstance(v, bool):
                assert math.isnan(da[k]) if math.isnan(v) \
                    else math.isclose(da[k], v, rel_tol=RTOL, abs_tol=0), k
            else:
                assert da[k] == v, (k, da[k], v)
        if a.cell == "replay":
            _same_replay(a.detail, b.detail)
            assert (a.projection is None) == (b.projection is None)
            for x, y in zip(a.projection or [], b.projection or []):
                _same_detail(x, y)
        else:
            _same_broker(a.detail, b.detail)


@pytest.mark.parametrize("unported", [
    "replay", "broker_axis", "broker_cell", "from_stream", "stream",
    "cluster_trace", "devices", "executor"])
def test_unported_spellings_raise_naming_their_item(unported):
    """The spellings that once raised all run now and agree with the
    reference's: the replay, broker and stream ones, and the sharded
    executor's (``devices`` / ``executor``), whose replay cells also equal
    the same Study's without an executor exactly."""
    w, ref = _jobs_pair(20, seed=1)
    if unported in ("devices", "executor"):
        knob = {"devices": {"devices": [CPU]},
                "executor": {"executor": ShardedExecutor(devices=[CPU])}}
        axes = dict(policies=["energy-aware"], caps=[900.0])
        study = Study(workloads=[w], **axes, **knob[unported])
        assert isinstance(study._executor, ShardedExecutor)
        got = study.run()
        _same_dynamic_cells(got, rp.Study(workloads=[ref], **axes).run())
        plain = Study(workloads=[w], **axes).run()
        assert len(got) == len(plain) == 1
        for a, b in zip(got, plain):
            assert dataclasses.asdict(a.detail) \
                == dataclasses.asdict(b.detail)
        assert study._executor.stats["samples"] == got[0].detail.n_samples
        return
    if unported == "replay":
        _same_dynamic_cells(
            Study(workloads=[w], policies=["energy-aware"],
                  caps=[900.0]).run(),
            rp.Study(workloads=[ref], policies=["energy-aware"],
                     caps=[900.0]).run())
    elif unported == "broker_axis":
        got = Study(workloads=[w], brokers=["greedy"], budgets_mw=[5.0])
        want = rp.Study(workloads=[ref], brokers=["greedy"],
                        budgets_mw=[5.0])
        assert [s.cell for s in got.scenarios()] == ["broker"]
        _same_dynamic_cells(got.run(), want.run())
    elif unported == "broker_cell":
        _same_dynamic_cells(
            Scenario(w, broker="greedy", budget_mw=5.0).run(),
            rp.Scenario(ref, broker="greedy", budget_mw=5.0).run())
    elif unported == "from_stream":
        got = Workload.from_stream(lambda: w.fleet().jobs.to_stream(500),
                                   device=CPU)
        want = rp.Workload.from_stream(
            lambda: ref.fleet().jobs.to_stream(500))
        assert dataclasses.asdict(got.fleet()._decomposition()) \
            == dataclasses.asdict(want.fleet()._decomposition())
        _same_detail(got.fleet().job_report(), want.fleet().job_report())
    elif unported == "stream":
        shards, ref_shards = list(w.stream()), list(ref.stream())
        assert len(shards) == len(ref_shards) >= 1
        for a, b in zip(shards, ref_shards):
            assert np.array_equal(a.power_w.numpy(), b.power_w)
            assert np.array_equal(a.time_s.numpy(), b.time_s)
            assert a.job_id.tolist() == b.job_id.tolist()
    else:                                    # cluster_trace
        ct, want = w.cluster_trace(), ref.cluster_trace()
        assert ct is w.cluster_trace()                 # cached
        assert ct.job_ids == want.job_ids
        for name in ("arrival_s", "walltime_s", "nodes", "chunk_power_w",
                     "chunk_mode", "cum_e_tot", "cum_ci_s"):
            assert np.array_equal(getattr(ct, name).numpy(),
                                  getattr(want, name)), name


# ------------------------------------------------- replay and broker cells
def test_streaming_replay_cell_parity(tmp_path):
    """The streaming-replay cell: an .npz spill stream workload replayed
    under a policy x chip pair equals the standalone chunked replay, and
    the reference's cell to rtol 1e-12."""
    from repro_torch.power.stream import iter_npz, replay
    w_store, ref_store = _store_pair(seed=5)
    spill, ref_spill = str(tmp_path / "s.npz"), str(tmp_path / "r.npz")
    w_store._store.spill_npz(spill)
    ref_store._store.spill_npz(ref_spill)
    w = Workload.from_stream(spill, name="spills", device=CPU)
    cell = Scenario(w, chip="tpu-v5e", policy="energy-aware",
                    cap=900.0).run()[0]
    rep = replay(iter_npz(spill, device=CPU), "energy-aware",
                 chip="tpu-v5e", record_chip=MI250X_GCD,
                 sample_interval_s=15.0)
    assert cell.savings_pct == rep.savings_pct
    assert cell.dt_pct == rep.dt_pct
    assert cell.projection == rep.project([900.0], "freq", tables="tpu-v5e")
    ref = rp.Scenario(rp.Workload.from_stream(ref_spill, name="spills"),
                      chip="tpu-v5e", policy="energy-aware",
                      cap=900.0).run()
    _same_dynamic_cells(StudyResult([cell]), ref)


def test_study_shares_replay_passes_across_caps(monkeypatch):
    """4 caps x 1 (policy, chip) run ONE chunked replay, not 4 — the grid
    batching contract — and the cells agree with the reference's."""
    import repro_torch.power.stream as stream_mod
    calls = []
    real = stream_mod.replay

    def counting_replay(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(stream_mod, "replay", counting_replay)
    pair = _jobs_pair(30, seed=0)
    caps = [1500.0, 1300.0, 1100.0, 900.0]
    res, ref = _study_pair(pair, policies=["energy-aware"], caps=caps)
    assert len(res) == 4
    assert len(calls) == 1
    assert len({c.savings_pct for c in res}) == 1      # shared headline
    assert [c.projection[0].cap for c in res] == caps
    _same_dynamic_cells(res, ref)


def test_replay_report_project_auto_matches_study_cell():
    """ReplayReport.project(tables="auto") resolves against the replay's
    evaluation chip — the same rows a Study replay cell attaches."""
    from repro_torch.power.stream import replay
    w, ref = _powers_pair(2000, seed=8)
    cell = Scenario(w, chip="tpu-v5e", policy="energy-aware",
                    cap=900.0).run()[0]
    rep = replay(w.stream(), "energy-aware", chip="tpu-v5e",
                 record_chip=w.chip, sample_interval_s=15.0)
    assert rep.project([900.0], tables="auto") == cell.projection
    # and differs from the measured-table spelling (it's a TPU surface)
    assert rep.project([900.0], tables=None) != cell.projection
    ref_cell = rp.Scenario(ref, chip="tpu-v5e", policy="energy-aware",
                           cap=900.0).run()
    _same_dynamic_cells(StudyResult([cell]), ref_cell)


def test_replay_projection_kwargs_shim_parity():
    """The deprecated tables=/caps= attachment warns and equals
    ReplayReport.project on the same replay, and the reference's rows."""
    from repro.power.stream import iter_array as ref_iter_array
    from repro.power.stream import replay as ref_replay
    from repro_torch.power.stream import iter_array, replay
    powers = synth_fleet_powers(3000, seed=11)
    tables = response_table("tpu-v5e", kind="freq", device=CPU)
    with pytest.warns(DeprecationWarning, match="replay"):
        old = replay(iter_array(powers, 1024, device=CPU), "energy-aware",
                     chip="tpu-v5e", record_chip=MI250X_GCD, tables=tables,
                     caps=[900.0])
    new = replay(iter_array(powers, 1024, device=CPU), "energy-aware",
                 chip="tpu-v5e", record_chip=MI250X_GCD)
    rows = new.project([900.0], "freq", tables=tables)
    assert old.projection == rows
    assert old.savings_pct == new.savings_pct
    with pytest.warns(DeprecationWarning, match="replay"):
        want = ref_replay(ref_iter_array(powers, 1024), "energy-aware",
                          chip="tpu-v5e", record_chip=REF_MI250X,
                          tables=rp.response_table("tpu-v5e", kind="freq"),
                          caps=[900.0])
    _same_replay(old, want)
    for a, b in zip(old.projection, want.projection):
        _same_detail(a, b)


# -------------------------------------------------------- randomized parity
@pytest.mark.parametrize("kind_of", ["powers", "store", "jobs"])
def test_randomized_grid_parity_all_workload_kinds(kind_of):
    """Every project / schedule cell, across workload kinds and randomized
    axes, equals the port's standalone entry-point call exactly and the
    reference's cell to rtol 1e-12."""
    rng = np.random.default_rng(7 + len(kind_of))
    pair = {"powers": lambda: _powers_pair(5000, seed=1),
            "store": lambda: _store_pair(),
            "jobs": lambda: _jobs_pair(60, seed=3, name="jobs")}[kind_of]()
    caps = [float(rng.choice(CAP_GRID))]
    if kind_of != "powers":
        caps.append(tuple(sorted(
            rng.choice(CAP_GRID, size=3, replace=False), reverse=True)))
        caps.append(None)
    axes = dict(chips=[None, "tpu-v5e"], caps=caps,
                metrics=["energy", "edp"])
    study = Study(workloads=[pair[0]], **axes)
    res = study.run()
    fa = pair[0].fleet()
    for s, cell in zip(study.scenarios(), res):
        tables = s.resolved_tables()
        if cell.cell == "project":
            ref = fa.project([float(s.cap)], s.kind, tables=tables,
                             objective=s.objective)[0]
            assert cell.detail == ref, (kind_of, s)
            assert cell.savings_pct == ref.savings_pct
            assert cell.dt_pct == ref.dt_pct
        else:
            ref = fa.job_report(s.caps_list(), s.kind, tables=tables,
                                objective=s.objective)
            assert cell.detail.to_dict() == ref.to_dict(), (kind_of, s)
            assert cell.savings_pct == ref.savings_pct
            assert cell.savings_mwh == ref.total_savings_mwh
    _same_cells(res, rp.Study(workloads=[pair[1]], **axes).run())


def test_study_shares_decomposition_across_projection_cells():
    w = _powers_pair(3000, seed=0)[0]
    Study(workloads=[w], caps=CAP_GRID).run()
    fa = w.fleet()
    assert fa.decomposition is not None        # computed once, cached
    ref = FleetAnalysis.from_powers(synth_fleet_powers(3000, seed=0),
                                    device=CPU).decompose()
    assert fa.decomposition.energy_mwh == ref.decomposition.energy_mwh
    want = rp.FleetAnalysis.from_powers(
        synth_fleet_powers(3000, seed=0)).decompose()
    assert fa.decomposition.energy_mwh == want.decomposition.energy_mwh


def test_same_named_chip_variants_are_distinct_cells():
    """Two ChipSpec variants sharing a name are different chips: distinct
    auto-resolved response surfaces and distinct projection cells
    (identity is the full frozen spec, never the name)."""
    variant = dataclasses.replace(MI250X_GCD, tdp_w=300.0)
    assert resolve_tables("auto", chip=variant, device=CPU) is not None
    assert resolve_tables("auto", chip=MI250X_GCD) is None
    w = _powers_pair(2000, seed=6)[0]
    res = Study(workloads=[w], chips=[MI250X_GCD, variant],
                caps=[900.0]).run()
    assert res[0].chip == res[1].chip == "mi250x-gcd"
    assert res[0].tables == "mi250x-table-iii"
    assert res[1].tables == "model:mi250x-gcd"
    assert res[0].savings_pct != res[1].savings_pct
    ref_variant = dataclasses.replace(REF_MI250X, tdp_w=300.0)
    ref = rp.Study(workloads=[_powers_pair(2000, seed=6)[1]],
                   chips=[REF_MI250X, ref_variant], caps=[900.0]).run()
    _same_cells(res, ref)


# ------------------------------------------------------------ StudyResult API
@pytest.fixture(scope="module")
def grid_pair():
    pair = _jobs_pair(80, seed=1)
    return _study_pair(pair, chips=["mi250x-gcd", "tpu-v5e"], caps=CAP_GRID)


def test_grid_matches_reference(grid_pair):
    _same_cells(*grid_pair)


def test_best_respects_constraint(grid_pair):
    grid_result, ref = grid_pair
    best = grid_result.best("dT<=2")
    assert best.dt_pct <= 2
    assert best.savings_pct == max(
        c.savings_pct for c in grid_result if c.dt_pct <= 2)
    unconstrained = grid_result.best()
    assert unconstrained.savings_pct >= best.savings_pct
    for spec in ("dT<=2", None, ["dT<=5", "sav>1"]):
        assert grid_result.cells.index(grid_result.best(spec)) == \
            ref.cells.index(ref.best(spec))
    with pytest.raises(ValueError, match="no cell satisfies"):
        grid_result.best("savings>=99")
    with pytest.raises(ValueError, match="cannot parse"):
        grid_result.best("dT ? 3")
    with pytest.raises(KeyError, match="unknown metric"):
        grid_result.best("frobnicate<=1")


def test_where_and_filter(grid_pair):
    grid_result, ref = grid_pair
    sub = grid_result.filter(chip="tpu-v5e")
    assert len(sub) == len(CAP_GRID)
    assert all(c.chip == "tpu-v5e" for c in sub)
    tight = grid_result.where(["dT<=2", "savings>0"])
    assert len(tight) and all(c.dt_pct <= 2 and c.savings_pct > 0
                              for c in tight)
    assert len(tight) == len(ref.where(["dT<=2", "savings>0"]))
    assert len(grid_result.filter(cap=900.0)) == 2
    assert len(grid_result.filter(policy="-")) == len(grid_result)
    with pytest.raises(KeyError, match="index columns"):
        grid_result.filter(savings_pct=1.0)


def test_compare_ranks_descending(grid_pair):
    grid_result, ref = grid_pair
    ranked = grid_result.compare()
    sav = ranked.savings_pct
    assert list(sav) == sorted(sav, reverse=True)
    assert [(c.chip, cap_label(c.cap)) for c in ranked] == \
        [(c.chip, cap_label(c.cap)) for c in ref.compare()]
    low = grid_result.compare("dt", ascending=True)
    assert list(low.dt_pct) == sorted(low.dt_pct)


def test_pivot_and_markdown(grid_pair):
    grid_result, ref = grid_pair
    rows, cols, mat = grid_result.pivot(rows="cap", cols="chip")
    assert rows == [cap_label(c) for c in CAP_GRID]
    assert cols == ["mi250x-gcd", "tpu-v5e"]
    assert mat.shape == (5, 2) and np.isfinite(mat).all()
    _close(mat, ref.pivot(rows="cap", cols="chip")[2])
    md = grid_result.to_markdown(rows="cap", cols="chip")
    assert md.count("\n") == len(CAP_GRID) + 1
    assert "| cap \\ chip | mi250x-gcd | tpu-v5e |" in md
    assert md == ref.to_markdown(rows="cap", cols="chip")
    flat = grid_result.to_markdown()
    assert flat.count("\n") == len(grid_result) + 1
    assert str(grid_result) == flat


def test_pivot_ambiguity_raises():
    w = Workload.synthetic_jobs(30, seed=2, device=CPU)
    res = Study(workloads=[w], caps=[900.0],
                metrics=["energy", "edp"]).run()
    with pytest.raises(ValueError, match="ambiguous"):
        res.pivot(rows="cap", cols="chip")
    res.filter(metric="edp").pivot(rows="cap", cols="chip")


def test_columns_and_dicts(grid_pair):
    grid_result, _ = grid_pair
    assert isinstance(grid_result.savings_pct, np.ndarray)
    assert grid_result.column("sav0") is not None
    assert grid_result.column("cap") == [cap_label(c.cap)
                                         for c in grid_result]
    d = grid_result.to_dicts()[0]
    assert d["cell"] == "project" and "detail" not in d
    with pytest.raises(AttributeError):
        grid_result.frobnicate


def test_pareto_front(grid_pair):
    grid_result, ref = grid_pair
    front = grid_result.pareto(x="savings_pct", y="dt_pct")
    assert [(c.chip, cap_label(c.cap)) for c in front] == \
        [(c.chip, cap_label(c.cap))
         for c in ref.pareto(x="savings_pct", y="dt_pct")]
    assert len(front) >= 1


def test_tuple_axis_values_are_single_cells():
    """A tuple is one axis value, never an axis: a bare cap tuple is ONE
    schedule cell and a (name, knobs) tuple is ONE policy spec."""
    w = Workload.synthetic_jobs(30, seed=3, device=CPU)
    res = Study(workloads=[w], caps=(1300.0, 900.0)).run()
    assert len(res) == 1 and res[0].cell == "schedule"
    s = Study(workloads=[w], policies=("power-cap", {"cap_w": 400.0}),
              caps=[900.0])
    assert len(s) == 1 and s.scenarios()[0].cell == "replay"
    assert len(Study(workloads=[w], caps=[1300.0, 900.0])) == 2


def test_schedule_labels_are_distinct():
    a, b = (1500.0, 1300.0, 700.0), (1500.0, 900.0, 700.0)
    assert cap_label(a) != cap_label(b)
    assert cap_label(a) == "sched(1500,1300,700)"
    assert cap_label(None) == "-" and cap_label(np.int64(900)) == "900"


def test_where_nan_never_satisfies_not_equal():
    w = Workload.synthetic_jobs(30, seed=4, device=CPU)
    res = Study(workloads=[w], caps=[900.0, None]).run()
    # project and schedule cells have NaN model_bias_pct
    assert len(res.where("bias!=123")) == 0


def test_ndarray_caps_axis_is_a_cap_sweep():
    w = _powers_pair(2000, seed=6)[0]
    res = Study(workloads=[w], caps=np.array([1300.0, 900.0])).run()
    assert len(res) == 2
    assert all(c.cell == "project" for c in res)
    res = Study(workloads=[w], caps=list(np.arange(900, 1400, 200))).run()
    assert [c.cell for c in res] == ["project"] * 3
    assert Scenario(w, cap=np.int64(900)).cell == "project"


def test_schedule_cells_share_one_report_per_group(monkeypatch):
    """Chip-axis schedule cells under ONE explicit tables object run one
    class_cap_report, not one per chip."""
    from repro_torch.power import fleet as fleet_mod
    calls = []
    real = fleet_mod.jobs_mod.class_cap_report

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fleet_mod.jobs_mod, "class_cap_report", counting)
    w = Workload.synthetic_jobs(30, seed=7, device=CPU)
    tables = response_table("tpu-v5e", kind="freq", device=CPU)
    res = Study(workloads=[w], chips=["mi250x-gcd", "tpu-v5e"],
                tables=tables, caps=(1300.0, 900.0)).run()
    assert len(res) == 2
    assert len(calls) == 1
    assert res[0].savings_pct == res[1].savings_pct


def test_scenarios_kwarg_rejects_shadowed_axes_and_knobs():
    cells = [Scenario(Workload.paper_fleet(device=CPU), cap=900.0)]
    with pytest.raises(ValueError, match="not both"):
        Study(scenarios=cells, kind="power")
    with pytest.raises(ValueError, match="not both"):
        Study(scenarios=cells, tables="tpu-v5e")


def test_readme_quickstart_snippet_runs():
    """The documented first-contact flow: grid -> project-cell pivot ->
    best -> schedule detail."""
    study = Study(
        workloads=[Workload.synthetic_jobs(60, seed=0, device=CPU)],
        chips=["mi250x-gcd", "tpu-v5e"],
        caps=[1300.0, 900.0, (1500, 1300, 1100, 900, 700)],
    )
    res = study.run()
    md = res.filter(cell="project").to_markdown(rows="cap", cols="chip")
    assert "mi250x-gcd" in md and "tpu-v5e" in md
    assert res.best("dT<=20") is not None
    assert isinstance(res.filter(cell="schedule")[0].detail,
                      FleetJobsReport)


def test_empty_axis_raises():
    w = Workload.synthetic_jobs(30, seed=5, device=CPU)
    with pytest.raises(ValueError, match="caps axis is empty"):
        Study(workloads=[w], caps=[])
    with pytest.raises(ValueError, match="chips axis is empty"):
        Study(workloads=[w], chips=[], caps=[900.0])


def test_study_axis_validation():
    with pytest.raises(ValueError, match="workloads axis"):
        Study()
    with pytest.raises(ValueError, match="kind"):
        Study(workloads=[Workload.paper_fleet(device=CPU)], kind="volts")
    with pytest.raises(ValueError, match="not both"):
        Study(workloads=[Workload.paper_fleet(device=CPU)],
              scenarios=[Scenario(Workload.paper_fleet(device=CPU),
                                  cap=900)])
    with pytest.raises(ValueError, match="exactly one"):
        Workload("w", MI250X_GCD)
    with pytest.raises(ValueError, match="unknown objective"):
        Study(workloads=[Workload.paper_fleet(device=CPU)],
              metrics=["frobnicate"])


# ------------------------------------------------------------------- shims
def test_project_domains_shim_parity():
    fa = FleetAnalysis.from_powers(synth_fleet_powers(4000, seed=0),
                                   device=CPU).decompose()
    doms = {"chm": (500.0, 2000.0), "phy": (800.0, 1500.0)}
    with pytest.warns(DeprecationWarning, match="project_domains"):
        old = fa.project_domains(doms, [1300.0, 900.0])
    e_total = fa.decomposition.total_energy_mwh
    ws = [Workload.from_energies(ci, mi, e_total, name=n, device=CPU)
          for n, (ci, mi) in doms.items()]
    res = Study(workloads=ws, caps=[1300.0, 900.0]).run()
    for name, rows in old.items():
        cells = res.filter(workload=name)
        assert [c.detail for c in cells] == rows
    ref = rp.Study(workloads=[rp.Workload.from_energies(ci, mi, e_total,
                                                        name=n)
                              for n, (ci, mi) in doms.items()],
                   caps=[1300.0, 900.0]).run()
    _same_cells(res, ref)


def test_builtin_tables_spelling_unchanged():
    rows_none = project([900.0], "freq", tables=None, device=CPU)
    rows_meas = project([900.0], "freq", tables=builtin_tables("freq"),
                        device=CPU)
    assert rows_none == rows_meas
    assert isinstance(resolve_tables("tpu-v5e", device=CPU), ResponseTables)


def test_scenario_single_cell_run_is_study_of_one():
    w = _powers_pair(2000, seed=4)[0]
    a = Scenario(w, cap=900.0).run()
    b = Study(workloads=[w], caps=[900.0]).run()
    assert isinstance(a, StudyResult) and len(a) == 1
    assert a[0].detail == b[0].detail


# ------------------------------------------------------------- confidence
@pytest.fixture(scope="module")
def jobs_pair():
    return _jobs_pair(250, seed=0)


def _same_cis(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.stat, a.method, a.n) == (b.stat, b.method, b.n)
        for f in ("value", "lo", "hi"):
            x, y = getattr(a, f), getattr(b, f)
            assert (math.isnan(x) and math.isnan(y)) or \
                math.isclose(x, y, rel_tol=RTOL), (f, x, y)


@pytest.mark.parametrize("stat", ["savings_pct", "savings_mwh",
                                  "savings_dt0_pct"])
def test_confidence_bootstrap_resamples_jobs(jobs_pair, stat):
    res, ref = _study_pair(jobs_pair, caps=[900.0, None])
    cis = res.confidence(stat, n_boot=500)
    for cell, ci in zip(res, cis):
        assert ci.n == 250
        assert ci.method == "bootstrap"
        # the contribution-vector statistic is exactly the cell's
        assert abs(ci.value - getattr(cell, stat)) \
            <= 1e-9 * max(1.0, abs(ci.value))
        assert ci.lo <= ci.value <= ci.hi
        assert ci.value in ci
    _same_cis(cis, ref.confidence(stat, n_boot=500))
    # deterministic under a fixed seed, different under another
    a = res.confidence(stat, n_boot=300, seed=1)[0]
    b = res.confidence(stat, n_boot=300, seed=1)[0]
    c = res.confidence(stat, n_boot=300, seed=2)[0]
    assert (a.lo, a.hi) == (b.lo, b.hi)
    assert (a.lo, a.hi) != (c.lo, c.hi)


@pytest.mark.parametrize("stat", ["savings_pct", "savings_mwh", "dt_pct"])
def test_confidence_of_replay_cells(stat):
    """Replay cells resample their per-job rows: both methods agree with
    the reference's to rtol 1e-12 (the bootstrap's count vectors are the
    reference's draws); a broker cell carries no per-job structure."""
    pair = _jobs_pair(60, seed=4)
    res, ref = _study_pair(pair, policies=["energy-aware"], caps=[900.0])
    for method in ("bootstrap", "jackknife"):
        got = res.confidence(stat, n_boot=300, method=method)
        assert got[0].n == 60
        _same_cis(got, ref.confidence(stat, n_boot=300, method=method))
    brk = Scenario(pair[0], broker="uniform", budget_mw=1.0,
                   kind="power").run()
    assert brk.confidence(stat)[0].n == 0


@pytest.mark.parametrize("stat", ["savings_pct", "savings_dt0_pct"])
def test_confidence_jackknife(jobs_pair, stat):
    res, ref = _study_pair(jobs_pair, caps=[1100.0, (1300.0, 900.0)])
    cis = res.confidence(stat, method="jackknife")
    for cell, ci in zip(res, cis):
        assert ci.n == 250 and ci.method == "jackknife"
        assert abs(ci.value - getattr(cell, stat)) <= 1e-9
        assert ci.lo <= ci.value <= ci.hi
    _same_cis(cis, ref.confidence(stat, method="jackknife"))
    with pytest.raises(ValueError, match="bootstrap"):
        res.confidence(method="permute")


def test_confidence_degrades_without_job_structure():
    w = Workload.from_powers(synth_fleet_powers(300, seed=0), device=CPU)
    res = Study(workloads=[w], caps=[900.0]).run()
    ci = res.confidence("savings_pct")[0]
    assert ci.n == 0
    assert np.isnan(ci.lo) and np.isnan(ci.hi)
    assert ci.value == res[0].savings_pct
    # a stat the cell does not resample degrades the same way
    jobs = Workload.synthetic_jobs(30, seed=0, device=CPU)
    ci = Study(workloads=[jobs], caps=[900.0]).run().confidence("dt_pct")[0]
    assert ci.n == 0 and np.isnan(ci.lo)


def test_headline_bootstrap_ci_matches_reference():
    """The third leg of validate_main at seed 0: the reference's interval
    [7.882, 9.064] around 8.484, n = 1500, to rtol 1e-10."""
    from repro_torch.core.projection import headline_bootstrap_ci
    from repro.power.jobs import (COMPUTE_INTENSIVE, LATENCY_BOUND,
                                  MEMORY_INTENSIVE)
    ci = headline_bootstrap_ci(device=CPU)
    w = rp.Workload.synthetic_jobs(
        1500, seed=0, class_mix={LATENCY_BOUND: 0.36, MEMORY_INTENSIVE: 0.43,
                                 COMPUTE_INTENSIVE: 0.21})
    ref = rp.Study(workloads=[w], caps=[900.0]).run().confidence(
        "savings_dt0_pct", n_boot=2000)[0]
    assert ci.n == ref.n == 1500
    for f in ("value", "lo", "hi"):
        assert math.isclose(getattr(ci, f), getattr(ref, f), rel_tol=1e-10)
    assert (round(ci.lo, 3), round(ci.hi, 3), round(ci.value, 3)) == \
        (7.882, 9.064, 8.484)
    assert 8.5 in ci
