"""repro_torch's online fleet power broker (``power/broker.py``) against the
reference package, on CPU float64 tensors fed the same inputs — the cases
of ``tests/test_broker.py``, each also held against the reference's
answer.

Stated tolerances:

* ``ClusterTrace`` columns (``from_jobs`` weighted and unweighted,
  ``from_stream``, ``synthetic``) are bit for bit the reference's: the
  chunk sums take numpy's pairwise order, the cumulative curves numpy's
  sequential ``cumsum``, and ``synthetic`` draws numpy's sequence;
* every ``simulate_cluster`` run has the reference's ``n_events``,
  ``n_scaled_events``, makespan, waits, utilisation, dT and budget audit
  exactly, and its savings, baseline and bin energies to rtol 1e-12 (the
  oracle's savings are the port's ``class_cap_report``, whose class
  aggregates sum in another order than numpy's);
* the budget invariant holds structurally for every broker, budget and
  seed; reruns are bit for bit equal.
"""
import numpy as np
import pytest
import torch
from conftest import given, settings, st  # hypothesis, or skip-stubs

from repro.power import JobTable as RefJobTable
from repro.power import broker as ref_broker
from repro.core.governor import sweep_decision as ref_sweep_decision
from repro.core.power_model import ChipModel as RefChipModel
from repro_torch.core.governor import sweep_decision
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.power import (ClusterTrace, EnergyAwarePolicy, JobTable,
                               MI250X_GCD, OracleBroker, PolicyBroker,
                               Scenario, Study, Workload, class_cap_report,
                               get_broker, simulate_cluster)
from repro_torch.power.broker import _first_fit, _greedy_deepen, _np_sum

CPU = "cpu"
RTOL = 1e-12
CAPS = (500.0, 400.0, 300.0, 200.0)
COLUMNS = ("arrival_s", "walltime_s", "nodes", "n_chunks", "chunk_power_w",
           "chunk_unit_power_w", "chunk_mode", "chunk_ci_frac",
           "chunk_dur_s", "cum_e_ci", "cum_e_mi", "cum_e_m1", "cum_e_tot",
           "cum_ci_s")


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


def _tables(n, seed):
    return (JobTable.synthetic(n, seed=seed, device=CPU),
            RefJobTable.synthetic(n, seed=seed))


def _trace_pair(seed=0, n=120, **kw):
    t, r = _tables(n, seed)
    return (ClusterTrace.from_jobs(t, **kw),
            ref_broker.ClusterTrace.from_jobs(r, **kw))


def _same_trace(got, want):
    assert got.job_ids == want.job_ids
    assert (got.chunk_samples, got.sample_interval_s) \
        == (want.chunk_samples, want.sample_interval_s)
    for name in COLUMNS:
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("hours_pct", "energy_mwh", "total_energy_mwh",
                 "n_samples"):
        assert np.array_equal(getattr(got.decomp, name).numpy(),
                              getattr(want.decomp, name)), name


def _same_report(got, want):
    for k in ("broker", "kind", "chip", "n_nodes", "n_jobs", "n_events",
              "makespan_s", "mean_wait_s", "n_scaled_events",
              "budget_exceeded", "bin_caps", "offline", "budget_mw",
              "throughput_jobs_per_h", "node_util_pct", "dt_pct",
              "peak_alloc_w"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("baseline_mwh", "savings_mwh", "savings_pct",
              "bin_energy_mwh", "bin_savings_mwh"):
        _close(getattr(got, k), getattr(want, k))


# ---------------------------------------------------------------------------
# ClusterTrace construction
# ---------------------------------------------------------------------------
def test_trace_columns_and_energy():
    t, r = _tables(60, 1)
    tr = ClusterTrace.from_jobs(t)
    assert tr.n_jobs == 60
    assert tr.arrival_s.shape == tr.walltime_s.shape == (60,)
    assert bool((torch.diff(torch.sort(tr.arrival_s).values) >= 0).all())
    w = t.nodes.to(torch.float64)
    expect = float((t.decompose().total_energy_mwh * w).sum())
    assert tr.total_energy_mwh == pytest.approx(expect, rel=1e-12)
    _close(tr.cum_e_tot[:, -1], tr.decomp.total_energy_mwh, rtol=1e-9)
    _same_trace(tr, ref_broker.ClusterTrace.from_jobs(r))
    assert tr.total_energy_mwh \
        == ref_broker.ClusterTrace.from_jobs(r).total_energy_mwh


def test_trace_unweighted_is_bitforbit_table_decompose():
    t, r = _tables(40, 2)
    tr = ClusterTrace.from_jobs(t, node_weighted=False)
    d = t.decompose()
    assert torch.equal(tr.decomp.energy_mwh, d.energy_mwh)
    assert torch.equal(tr.decomp.total_energy_mwh, d.total_energy_mwh)
    assert torch.equal(tr.chunk_power_w, tr.chunk_unit_power_w)
    _same_trace(tr, ref_broker.ClusterTrace.from_jobs(
        r, node_weighted=False))


@pytest.mark.parametrize("chunk_samples", [7, 60, 200])
def test_trace_from_jobs_chunk_widths(chunk_samples):
    """Chunk widths under 8, under 128 and over 128 (numpy's pairwise
    recursion) all give the reference's columns bit for bit."""
    tr, ref = _trace_pair(seed=4, n=30, chunk_samples=chunk_samples)
    _same_trace(tr, ref)
    with pytest.raises(ValueError, match="chunk_samples"):
        ClusterTrace.from_jobs(JobTable.synthetic(3, seed=0, device=CPU),
                               chunk_samples=0)


def test_trace_from_stream_roundtrip():
    t, r = _tables(25, 3)
    via_stream = ClusterTrace.from_stream(
        t.to_stream(), chip=t.chip, sample_interval_s=t.sample_interval_s)
    direct = ClusterTrace.from_jobs(t, node_weighted=False)
    assert via_stream.job_ids == direct.job_ids
    assert torch.allclose(via_stream.arrival_s, direct.arrival_s)
    assert via_stream.total_energy_mwh == pytest.approx(
        direct.total_energy_mwh, rel=1e-9)
    assert torch.allclose(via_stream.cum_e_tot[:, -1],
                          direct.cum_e_tot[:, -1], rtol=1e-9)
    for spp in (65536, 777):
        _same_trace(
            ClusterTrace.from_stream(t.to_stream(spp), chip=t.chip),
            ref_broker.ClusterTrace.from_stream(r.to_stream(spp),
                                                chip=r.chip))
    with pytest.raises(ValueError, match="empty stream"):
        ClusterTrace.from_stream(iter([]))


def test_trace_synthetic_vectorized_scale():
    tr = ClusterTrace.synthetic(5000, seed=0, device=CPU)
    assert tr.n_jobs == 5000
    assert tr.chunk_power_w.shape[0] == 5000
    assert bool((tr.nodes >= 1).all())
    assert tr.total_energy_mwh > 0
    _same_trace(tr, ref_broker.ClusterTrace.synthetic(5000, seed=0))
    _same_trace(ClusterTrace.synthetic(300, seed=3, arrival_gap_s=130.0,
                                       node_weighted=False, device=CPU),
                ref_broker.ClusterTrace.synthetic(300, seed=3,
                                                  arrival_gap_s=130.0,
                                                  node_weighted=False))


def test_np_sum_is_numpys_order():
    rng = np.random.default_rng(0)
    for n in (1, 5, 8, 60, 127, 128, 129, 1000):
        x = rng.normal(size=(7, n)) * 1e3
        assert np.array_equal(_np_sum(torch.from_numpy(x)).numpy(),
                              x.sum(axis=1)), n


# ---------------------------------------------------------------------------
# The brokers against the reference's simulate_cluster
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("broker", ["uniform", "greedy", "class-schedule",
                                    "oracle"])
@pytest.mark.parametrize("budget", [0.3, 1.0, None])
def test_simulate_matches_reference(broker, budget):
    tr, ref = _trace_pair(seed=8, n=150)
    got = simulate_cluster(tr, broker, budget, kind="power")
    want = ref_broker.simulate_cluster(ref, broker, budget, kind="power")
    _same_report(got, want)
    assert got.n_ticks > 0


@pytest.mark.parametrize("broker", ["uniform", "greedy", "class-schedule"])
def test_simulate_freq_kind_matches_reference(broker):
    """The frequency-capped menu (static menu clocks on the model pass)."""
    tr, ref = _trace_pair(seed=9, n=90)
    _same_report(simulate_cluster(tr, broker, 0.5, kind="freq"),
                 ref_broker.simulate_cluster(ref, broker, 0.5,
                                             kind="freq"))


# ---------------------------------------------------------------------------
# The budget invariant (structural, randomized)
# ---------------------------------------------------------------------------
def check_invariant(seed, budget_mw, broker):
    tr = ClusterTrace.from_jobs(JobTable.synthetic(80, seed=seed,
                                                   device=CPU))
    rep = simulate_cluster(tr, broker, budget_mw, n_nodes=10_000,
                           kind="power")
    assert not rep.budget_exceeded
    assert rep.peak_alloc_w <= budget_mw * 1e6 * (1.0 + 1e-6)
    assert rep.n_jobs == 80
    return rep


@pytest.mark.parametrize("broker", ["uniform", "greedy", "class-schedule"])
def test_budget_never_exceeded(broker):
    for seed in (0, 1):
        check_invariant(seed, 0.5, broker)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 50), budget=st.floats(0.05, 5.0),
       broker=st.sampled_from(["uniform", "greedy", "class-schedule"]))
def test_budget_invariant_randomized(seed, budget, broker):
    check_invariant(seed, budget, broker)


def test_overshooting_broker_is_clamped():
    class Hog:
        name = "hog"
        offline = False

        def allocate(self, view):
            return np.zeros(view.n_running, dtype=np.int64)  # all uncapped

    tr, ref = _trace_pair(seed=4, n=60)
    rep = simulate_cluster(tr, Hog(), 0.2, n_nodes=10_000, kind="power")
    assert not rep.budget_exceeded
    assert rep.n_scaled_events > 0          # the sim had to step in
    _same_report(rep, ref_broker.simulate_cluster(ref, Hog(), 0.2,
                                                  n_nodes=10_000,
                                                  kind="power"))


def test_bad_broker_shape_raises():
    class Wrong:
        name = "wrong"
        offline = False

        def allocate(self, view):
            return np.zeros(view.n_running + 3, dtype=np.int64)

    tr, _ = _trace_pair(n=40)
    with pytest.raises(ValueError, match="shape"):
        simulate_cluster(tr, Wrong(), 1.0, kind="power")
    with pytest.raises(ValueError, match="budget_mw must be positive"):
        simulate_cluster(tr, "uniform", 0.0, kind="power")
    with pytest.raises(ValueError, match="no schedule exists"):
        simulate_cluster(tr, "uniform", 1.0, n_nodes=1, kind="power")


# ---------------------------------------------------------------------------
# Determinism
# ---------------------------------------------------------------------------
def test_fixed_seed_is_deterministic():
    a = check_invariant(7, 0.4, "greedy")
    b = check_invariant(7, 0.4, "greedy")
    assert a.savings_mwh == b.savings_mwh
    assert a.makespan_s == b.makespan_s
    assert a.n_events == b.n_events
    assert a.mean_wait_s == b.mean_wait_s
    assert np.array_equal(a.bin_energy_mwh, b.bin_energy_mwh)
    assert np.array_equal(a.bin_savings_mwh, b.bin_savings_mwh)


# ---------------------------------------------------------------------------
# Oracle = offline bound, exactly
# ---------------------------------------------------------------------------
def test_oracle_reproduces_class_cap_report_exactly():
    tr, ref = _trace_pair(seed=5, n=150)
    rep = simulate_cluster(tr, "oracle", n_nodes=10_000, kind="power",
                           caps=CAPS)
    want = class_cap_report(tr.decomp, caps=CAPS, kind="power")
    assert rep.offline
    assert rep.savings_mwh == want.total_savings_mwh         # same floats
    assert rep.savings_pct == want.savings_pct
    assert [c.cap for c in rep.schedule.classes] \
        == [c.cap for c in want.classes]
    _same_report(rep, ref_broker.simulate_cluster(
        ref, "oracle", n_nodes=10_000, kind="power", caps=CAPS))


def test_oracle_parity_holds_unweighted():
    t, r = _tables(100, 6)
    tr = ClusterTrace.from_jobs(t, node_weighted=False)
    rep = simulate_cluster(tr, "oracle", n_nodes=10_000, kind="power",
                           caps=CAPS)
    want = class_cap_report(t.decompose(), caps=CAPS, kind="power")
    assert rep.savings_mwh == want.total_savings_mwh
    _close(rep.savings_mwh, ref_broker.simulate_cluster(
        ref_broker.ClusterTrace.from_jobs(r, node_weighted=False),
        "oracle", n_nodes=10_000, kind="power", caps=CAPS).savings_mwh)


@pytest.mark.parametrize("broker", ["uniform", "greedy", "class-schedule"])
def test_online_never_beats_oracle(broker):
    tr, _ = _trace_pair(seed=8, n=150)
    bound = simulate_cluster(tr, "oracle", n_nodes=10_000,
                             kind="power").savings_mwh
    for budget in (0.3, 1.0, None):
        rep = simulate_cluster(tr, broker, budget, n_nodes=10_000,
                               kind="power")
        assert rep.savings_mwh <= bound + 1e-9


# ---------------------------------------------------------------------------
# Broker resolution + PolicyBroker fallback
# ---------------------------------------------------------------------------
def test_get_broker_resolution():
    assert get_broker().name == "uniform"
    assert get_broker("greedy", objective="edp").name == "greedy-edp"
    assert get_broker("class-schedule", objective="edp").name \
        == ref_broker.get_broker("class-schedule", objective="edp").name
    o = OracleBroker()
    assert get_broker(o) is o
    with pytest.raises(KeyError, match="unknown broker"):
        get_broker("nope")
    with pytest.raises(TypeError):
        get_broker(123)


def test_first_fit_and_greedy_deepen_match_numpy():
    """The two shared passes on tensors pick what the reference's numpy
    passes pick, ties and the budget cut included."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        r, c = int(rng.integers(1, 40)), 5
        draw = np.sort(rng.uniform(100, 800, size=(r, c)), axis=1)[:, ::-1]
        draw = np.round(draw, 0)                # ties along the menu
        limit = rng.uniform(50, 900, size=r)
        got = _first_fit(torch.from_numpy(draw), torch.from_numpy(limit))
        want = ref_broker._first_fit(draw, limit)
        assert np.array_equal(got.numpy(), want)
        pen = np.round(rng.normal(size=(r, c)), 1)
        choice = rng.integers(0, c, size=r)
        budget = float(rng.uniform(0.2, 1.0) * draw[:, 0].sum())
        got = _greedy_deepen(torch.from_numpy(draw), torch.from_numpy(pen),
                             torch.from_numpy(choice), budget)
        assert np.array_equal(got.numpy(), ref_broker._greedy_deepen(
            draw, pen, choice, budget))


def test_policy_broker_third_party_scalar_fallback():
    class ThirdParty:                       # decide() only, no decide_batch
        name = "thirdparty"

        def decide(self, profile: StepProfile, chip: ChipModel):
            return sweep_decision(profile, chip, slowdown_budget=0.05)

    class RefThirdParty:
        name = "thirdparty"

        def decide(self, profile, chip):
            return ref_sweep_decision(profile, chip, slowdown_budget=0.05)

    br = get_broker(ThirdParty())
    assert isinstance(br, PolicyBroker)
    assert br.name == "policy:thirdparty"
    tr, ref = _trace_pair(seed=9, n=60)
    rep = simulate_cluster(tr, ThirdParty(), 0.5, n_nodes=10_000,
                           kind="power")
    assert rep.broker == "policy:thirdparty"
    assert not rep.budget_exceeded
    assert rep.baseline_mwh > 0
    _same_report(rep, ref_broker.simulate_cluster(
        ref, RefThirdParty(), 0.5, n_nodes=10_000, kind="power"))


def test_policy_broker_builtin_policy():
    tr, ref = _trace_pair(seed=10, n=60)
    from repro.power import EnergyAwarePolicy as RefEnergyAware
    _same_report(
        simulate_cluster(tr, EnergyAwarePolicy(slowdown_budget=0.1), 0.6,
                         kind="power"),
        ref_broker.simulate_cluster(ref, RefEnergyAware(slowdown_budget=0.1),
                                    0.6, kind="power"))


# ---------------------------------------------------------------------------
# Study wiring: broker x budget axes, pareto front
# ---------------------------------------------------------------------------
def test_study_broker_grid_and_pareto():
    import repro.power as rp
    w = Workload.synthetic_jobs(100, seed=10, device=CPU)
    res = Study(workloads=[w], brokers=["uniform", "oracle"],
                budgets_mw=[0.3, 1.0], kind="power").run()
    assert len(res) == 4
    assert all(c.cell == "broker" for c in res)
    assert set(res.column("policy")) == {"uniform", "oracle"}
    assert np.isfinite(res.column("throughput_jobs_per_h")).all()
    assert np.isfinite(res.column("budget_mw")).all()
    front = res.pareto()
    assert len(front) >= 1                  # oracle excluded by default
    assert all(c.policy != "oracle" for c in front)
    assert any(c.policy == "oracle"
               for c in res.pareto(include_offline=True))
    assert w.cluster_trace() is w.cluster_trace()
    ref = rp.Study(workloads=[rp.Workload.synthetic_jobs(100, seed=10)],
                   brokers=["uniform", "oracle"], budgets_mw=[0.3, 1.0],
                   kind="power").run()
    for a, b in zip(res, ref):
        assert (a.policy, a.budget_mw, a.cell) == (b.policy, b.budget_mw,
                                                   b.cell)
        _same_report(a.detail, b.detail)
    assert [c.policy for c in front] == [c.policy for c in ref.pareto()]
    _close(front.savings_pct, ref.pareto().savings_pct)


def test_study_broker_axis_validation():
    w = Workload.synthetic_jobs(20, seed=0, device=CPU)
    with pytest.raises(ValueError, match="different cell shapes"):
        Study(workloads=[w], brokers=["uniform"], policies=["nominal"])
    with pytest.raises(ValueError, match="workload's own chip"):
        Study(workloads=[w], brokers=["uniform"], chips=["tpu-v5e"])
    with pytest.raises(ValueError, match="no per-job structure"):
        Scenario(workload=Workload.paper_fleet(device=CPU),
                 broker="uniform", kind="power").run()


def test_broker_objective_through_scenario():
    """A metric axis re-parameterizes name-resolved brokers, and a broker
    that takes no objective knob keeps its own name."""
    w = Workload.synthetic_jobs(40, seed=2, device=CPU)
    assert Scenario(w, broker="greedy", objective="edp") \
        .resolved_broker().name == "greedy-edp"
    assert Scenario(w, broker="uniform", objective="edp") \
        .resolved_broker().name == "uniform"
    assert Scenario(w, broker=("class-schedule", {"warmup_s": 0.0}),
                    objective="edp").resolved_broker().name \
        == "class-schedule-edp"


# ---------------------------------------------------------------------------
# Satellites: default-knob parity
# ---------------------------------------------------------------------------
def test_walltime_sigma_default_bitforbit():
    a = JobTable.synthetic(50, seed=11, device=CPU)
    b = JobTable.synthetic(50, seed=11, walltime_sigma=0.6, device=CPU)
    assert torch.equal(a.powers, b.powers)
    c = JobTable.synthetic(50, seed=11, walltime_sigma=0.1, device=CPU)
    assert not torch.equal(a.lengths, c.lengths)


def test_objective_energy_is_bitforbit_default():
    chip, ref_chip = ChipModel(MI250X_GCD), RefChipModel("mi250x-gcd")
    rng = np.random.default_rng(12)
    for _ in range(20):
        c, m = float(rng.uniform(0.01, 1.0)), float(rng.uniform(0.01, 1.0))
        prof = StepProfile(compute_s=c, memory_s=m)
        d0 = sweep_decision(prof, chip, slowdown_budget=0.1)
        d1 = sweep_decision(prof, chip, slowdown_budget=0.1,
                            objective="energy")
        assert d0.freq_frac == d1.freq_frac
        assert d0.energy_j == d1.energy_j
        from repro.core.power_model import StepProfile as RefStepProfile
        want = ref_sweep_decision(RefStepProfile(compute_s=c, memory_s=m),
                                  ref_chip, slowdown_budget=0.1)
        assert d0.freq_mhz == want.freq_mhz


def test_objective_edp_diverges_and_batch_matches_scalar():
    chip = ChipModel(MI250X_GCD)
    profs = [StepProfile(compute_s=c, memory_s=m)
             for c, m in [(1.0, 0.05), (0.05, 1.0), (0.6, 0.4)]]
    pol = EnergyAwarePolicy(slowdown_budget=0.5, objective="edp")
    bd = pol.decide_batch(profs, chip, device=CPU)
    diverged = False
    for i, p in enumerate(profs):
        d = pol.decide(p, chip)
        assert float(bd.freq_frac[i]) == pytest.approx(d.freq_frac,
                                                       rel=1e-12)
        d_energy = sweep_decision(p, chip, slowdown_budget=0.5)
        diverged |= d.freq_frac != d_energy.freq_frac
    assert diverged                         # EDP actually changes a pick
    with pytest.raises(ValueError, match="objective"):
        EnergyAwarePolicy(objective="nope")
    with pytest.raises(ValueError, match="objective"):
        sweep_decision(profs[0], chip, objective="nope")


def test_greedy_objective_knob_through_study_label():
    tr, ref = _trace_pair(seed=13, n=60)
    rep = simulate_cluster(tr, "greedy", 0.5, kind="power",
                           objective="perf_per_watt")
    assert rep.broker == "greedy-perf_per_watt"
    assert not rep.budget_exceeded
    _same_report(rep, ref_broker.simulate_cluster(
        ref, "greedy", 0.5, kind="power", objective="perf_per_watt"))
