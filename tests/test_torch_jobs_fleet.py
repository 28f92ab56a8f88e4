"""repro_torch's job layer (``power/jobs.py``) and ``FleetAnalysis`` against
the reference package, on CPU float64 tensors fed the same numpy inputs —
the cases of ``tests/test_fleet_jobs.py``, each also held against the
reference's answer.

Stated tolerances:

* ``synth_job_traces`` keeps the reference's numpy draw sequence: lengths,
  job ids, arch, node counts and arrival times are equal, powers agree to
  rtol 1e-12 (the phase ceilings pass through ``f ** 2.4``, which differs
  from numpy's in the last bits);
* decompositions of equal inputs are equal bit for bit, as in
  ``tests/test_torch_modal_projection.py``;
* projections, class reports, ``job_report`` and ``summary`` agree to rtol
  1e-12 with equal classes, caps and ``meets_dt0``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import modal as ref_modal
from repro.core import projection as ref_proj
from repro.core.telemetry import StepSample as RefStepSample
from repro.core.telemetry import TelemetryStore as RefTelemetryStore
from repro.power import FleetAnalysis as RefFleetAnalysis
from repro.power import jobs as ref_jobs
from repro_torch import convert
from repro_torch.core import hardware as hw
from repro_torch.core.modal import decompose, decompose_batch
from repro_torch.core.projection import project, project_batch
from repro_torch.core.telemetry import StepSample, TelemetryStore
from repro_torch.power import (FleetAnalysis, JOB_CLASSES, JobTable,
                               JobTrace, jobs)
from repro_torch.power.jobs import (COMPUTE_INTENSIVE, LATENCY_BOUND,
                                    MEMORY_INTENSIVE, classify_jobs,
                                    job_dt_weights)

RTOL = 1e-12
CPU = "cpu"


def _close(got, want, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


def _same_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


def _same_report(got, want):
    """Two FleetJobsReports (or their dicts): discrete fields equal,
    floats to rtol 1e-12."""
    g = got if isinstance(got, dict) else got.to_dict()
    w = want if isinstance(want, dict) else want.to_dict()
    assert g.keys() == w.keys()
    for k in g:
        if k == "classes":
            assert len(g[k]) == len(w[k])
            for a, b in zip(g[k], w[k]):
                _same_report(a, b)
        elif isinstance(w[k], float) and not isinstance(w[k], bool):
            _close(g[k], w[k])
        else:
            assert g[k] == w[k], (k, g[k], w[k])


def _padded(traces):
    width = max(t.size for t in traces)
    powers = np.zeros((len(traces), width))
    mask = np.zeros_like(powers, dtype=bool)
    for j, t in enumerate(traces):
        powers[j, : t.size], mask[j, : t.size] = t, True
    return powers, mask


# ------------------------------------------------- batched core vs scalar
def test_decompose_batch_matches_scalar_per_job():
    rng = np.random.default_rng(0)
    traces = [rng.uniform(90.0, 620.0, size=n) for n in (1, 7, 50, 233)]
    powers, mask = _padded(traces)
    bd = decompose_batch(powers, 15.0, mask=mask, device=CPU)
    rbd = ref_modal.decompose_batch(powers, 15.0, mask=mask)
    _same_bits(bd.energy_mwh, rbd.energy_mwh)
    _same_bits(bd.hours_pct, rbd.hours_pct)
    for j, t in enumerate(traces):
        ref = ref_modal.decompose(t, 15.0)
        got = bd.job(j)
        assert got.hours_pct == pytest.approx(ref.hours_pct)
        assert got.energy_mwh == pytest.approx(ref.energy_mwh)
        assert got.total_energy_mwh == pytest.approx(ref.total_energy_mwh)


def test_decompose_batch_mask_excludes_padding():
    """Padding zeros contribute nothing — not hours, not energy."""
    p = np.array([[300.0, 300.0, 0.0, 0.0]])
    mask = np.array([[True, True, False, False]])
    bd = decompose_batch(p, 15.0, mask=mask, device=CPU)
    assert float(bd.hours_pct[0, 1]) == pytest.approx(100.0)   # all mode 2
    unpadded = decompose_batch(np.array([[300.0, 300.0]]), 15.0, device=CPU)
    assert torch.equal(bd.energy_mwh, unpadded.energy_mwh)
    assert torch.equal(bd.total_energy_mwh, unpadded.total_energy_mwh)
    _same_bits(bd.energy_mwh,
               ref_modal.decompose_batch(p, 15.0, mask=mask).energy_mwh)


def test_aggregate_matches_concatenated_decompose():
    """Sample-count-weighted aggregation == decomposing the concatenation,
    including hours, for unequal-length jobs; and the reference's."""
    rng = np.random.default_rng(3)
    traces = [rng.uniform(90.0, 620.0, size=n) for n in (5, 80, 311)]
    powers, mask = _padded(traces)
    agg = decompose_batch(powers, 15.0, mask=mask, device=CPU).aggregate()
    ref = decompose(np.concatenate(traces), 15.0, device=CPU)
    assert agg.hours_pct == pytest.approx(ref.hours_pct)
    assert agg.energy_mwh == pytest.approx(ref.energy_mwh)
    assert agg.total_energy_mwh == pytest.approx(ref.total_energy_mwh)
    want = ref_modal.decompose_batch(powers, 15.0, mask=mask).aggregate()
    for m in hw.MODES:
        _close(agg.energy_mwh[m.idx], want.energy_mwh[m.idx])
        _close(agg.hours_pct[m.idx], want.hours_pct[m.idx])


def test_scalar_decompose_is_single_row_special_case():
    powers = ref_modal.synth_fleet_powers(50_000, seed=7)
    ref = decompose(powers, 15.0, device=CPU)
    row = decompose_batch(powers.reshape(1, -1), 15.0, device=CPU).job(0)
    assert row.energy_mwh == ref.energy_mwh          # same engine: exact
    assert row.hours_pct == ref.hours_pct
    assert row.energy_mwh == ref_modal.decompose(powers, 15.0).energy_mwh


def test_project_batch_matches_scalar_rows():
    caps = [1500, 1300, 900, 700]
    e = np.array([[200.0, 700.0, 1500.0],
                  [10.0, 0.5, 20.0],
                  [0.0, 5.0, 9.0]])
    bp = project_batch(caps, "freq", e_ci_mwh=e[:, 0], e_mi_mwh=e[:, 1],
                       e_total_mwh=e[:, 2], device=CPU)
    for j in range(e.shape[0]):
        ref = project(caps, "freq", e_ci_mwh=e[j, 0], e_mi_mwh=e[j, 1],
                      e_total_mwh=e[j, 2], device=CPU)
        assert [r.to_dict() for r in bp.rows(j)] == \
            [r.to_dict() for r in ref]
        want = ref_proj.project(caps, "freq", e_ci_mwh=e[j, 0],
                                e_mi_mwh=e[j, 1], e_total_mwh=e[j, 2])
        assert [r.to_dict() for r in ref] == [r.to_dict() for r in want]


def test_project_batch_per_job_dt_weights():
    """dT scales with each job's own C.I. share: a pure-M.I. job projects
    zero slowdown at 900 MHz, a pure-C.I. job does not."""
    kw = dict(e_ci_mwh=np.array([0.0, 5.0]), e_mi_mwh=np.array([5.0, 0.0]),
              e_total_mwh=np.array([5.0, 5.0]),
              dt_weight=np.array([0.0, 0.695]))
    bp = project_batch([900], "freq", device=CPU, **kw)
    assert float(bp.dt_pct[0, 0]) == pytest.approx(0.0)
    assert float(bp.dt_pct[1, 0]) > 5.0
    assert float(bp.savings_dt0_pct[0, 0]) > 0.0      # M.I. savings count
    assert float(bp.savings_dt0_pct[1, 0]) == pytest.approx(0.0)
    rbp = ref_proj.project_batch([900], "freq", **kw)
    _same_bits(bp.dt_pct, rbp.dt_pct)
    _same_bits(bp.savings_dt0_pct, rbp.savings_dt0_pct)


def test_batch_projection_best_cap():
    kw = dict(e_ci_mwh=np.array([10.0, 0.0]), e_mi_mwh=np.array([0.0, 10.0]),
              e_total_mwh=np.array([10.0, 10.0]))
    bp = project_batch([1500, 1300, 900], "freq", device=CPU, **kw)
    best = bp.best_cap()
    assert float(best[0]) == 1300.0     # VAI energy minimum is at 1300 MHz
    assert float(best[1]) == 900.0      # MB energy minimum is at 900 MHz
    assert best.tolist() == \
        ref_proj.project_batch([1500, 1300, 900], "freq", **kw) \
        .best_cap().tolist()


# ------------------------------------------------------ synthetic workload
@pytest.fixture(scope="module")
def ref_table():
    return ref_jobs.JobTable.synthetic(600, seed=0)


@pytest.fixture(scope="module")
def table():
    return JobTable.synthetic(600, seed=0, device=CPU)


@pytest.fixture(scope="module")
def fleet(table):
    return FleetAnalysis.from_jobs(table)


@pytest.fixture(scope="module")
def ref_fleet(ref_table):
    return RefFleetAnalysis.from_jobs(ref_table)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_job_traces_match_reference(seed):
    mix = {LATENCY_BOUND: 0.36, MEMORY_INTENSIVE: 0.43,
           COMPUTE_INTENSIVE: 0.21} if seed == 2 else None
    got = jobs.synth_job_traces(300, seed=seed, class_mix=mix)
    want = ref_jobs.synth_job_traces(300, seed=seed, class_mix=mix)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.job_id, g.arch, g.num_nodes, g.begin_time,
                g.intent_class, g.sample_interval_s) == \
            (w.job_id, w.arch, w.num_nodes, w.begin_time, w.intent_class,
             w.sample_interval_s)
        assert g.powers.shape == w.powers.shape
        _close(g.powers, w.powers)
        assert dataclasses.asdict(g.record()) == \
            dataclasses.asdict(w.record())
        _close(g.energy_mwh, w.energy_mwh)


@pytest.mark.parametrize("chip", ["mi250x-gcd", "h100-sxm", "tpu-v5e"])
def test_class_profiles_and_ceilings_match_reference(chip):
    import repro.core.hardware as ref_hw
    got = jobs._class_profiles(hw.CHIPS[chip])
    want = ref_jobs._class_profiles(ref_hw.CHIPS[chip])
    assert {c: [(a, dataclasses.astuple(p)) for a, p in v]
            for c, v in got.items()} == \
        {c: [(a, dataclasses.astuple(p)) for a, p in v]
         for c, v in want.items()}
    ceil, rceil = (jobs._class_power_ceilings(hw.CHIPS[chip]),
                   ref_jobs._class_power_ceilings(ref_hw.CHIPS[chip]))
    assert ceil.keys() == rceil.keys()
    _close(list(ceil.values()), list(rceil.values()))


def test_jobtable_shapes_and_determinism(table, ref_table):
    assert len(table) == 600
    assert table.powers.shape == table.mask.shape
    assert int(table.mask.sum()) == int(table.lengths.sum())
    assert table.concat_powers().numel() == int(table.lengths.sum())
    assert table.powers.device.type == "cpu"
    assert table.powers.dtype == torch.float64
    again = JobTable.synthetic(600, seed=0, device=CPU)
    assert torch.equal(table.powers, again.powers)
    other = JobTable.synthetic(600, seed=1, device=CPU)
    assert not torch.equal(table.powers, other.powers)
    # the reference's table, sample for sample
    assert table.mask.numpy().tolist() == ref_table.mask.tolist()
    assert table.lengths.tolist() == ref_table.lengths.tolist()
    _close(table.powers, ref_table.powers)
    _close(table.arrival_s, ref_table.arrival_s)
    assert table.walltime_s.tolist() == ref_table.walltime_s.tolist()
    assert table.nodes.tolist() == ref_table.nodes.tolist()
    _close(table.concat_powers(), ref_table.concat_powers())


def test_converter_builds_the_reference_table(ref_table):
    tr = ref_table.traces
    got = convert.job_table_from_arrays(
        [t.powers for t in tr], [t.job_id for t in tr],
        arch=[t.arch for t in tr], num_nodes=[t.num_nodes for t in tr],
        begin_time=[t.begin_time for t in tr],
        intent_class=[t.intent_class for t in tr], device=CPU)
    _same_bits(got.powers, ref_table.powers)
    assert got.job_ids == ref_table.job_ids
    assert got.mask.numpy().tolist() == ref_table.mask.tolist()
    assert got.nodes.tolist() == ref_table.nodes.tolist()
    assert got.arrival_s.tolist() == ref_table.arrival_s.tolist()
    # equal inputs: the per-job decomposition is equal bit for bit
    bd, rbd = got.decompose(), ref_table.decompose()
    _same_bits(bd.energy_mwh, rbd.energy_mwh)
    _same_bits(bd.total_energy_mwh, rbd.total_energy_mwh)
    _same_bits(bd.hours_pct, rbd.hours_pct)
    # tensor traces are accepted too
    t2 = JobTable([JobTrace("a", torch.full((4,), 300.0)),
                   JobTrace("b", np.full(2, 480.0))], device=CPU)
    assert t2.lengths.tolist() == [4, 2]
    assert t2.traces[0].duration_s == 60.0


def test_jobtable_rejects_mixed_sample_intervals():
    a = JobTrace("a", np.full(4, 300.0), sample_interval_s=15.0)
    b = JobTrace("b", np.full(4, 300.0), sample_interval_s=1.0)
    with pytest.raises(ValueError, match="sample intervals"):
        JobTable([a, b], device=CPU)


def test_jobtable_metadata(table, ref_table):
    archs = {t.arch for t in table.traces}
    assert len(archs) >= 5                 # mixes many model configs
    recs = table.records()
    assert len(recs) == len(table)
    assert all(r.num_nodes >= 1 for r in recs)
    begins = [t.begin_time for t in table.traces]
    assert all(b2 > b1 for b1, b2 in zip(begins, begins[1:]))
    assert [(r.job_id, r.project_id, r.num_nodes, r.begin_time,
             r.science_domain, r.size_class()) for r in recs] == \
        [(r.job_id, r.project_id, r.num_nodes, r.begin_time,
          r.science_domain, r.size_class()) for r in ref_table.records()]


def test_classify_jobs_recovers_generator_intent(table, ref_table):
    cls = classify_jobs(table.decompose())
    intents = [t.intent_class for t in table.traces]
    agree = np.mean([JOB_CLASSES[c] == i
                     for c, i in zip(cls.tolist(), intents)])
    assert agree > 0.9
    assert set(JOB_CLASSES[c] for c in cls.tolist()) == set(JOB_CLASSES)
    assert cls.tolist() == \
        ref_jobs.classify_jobs(ref_table.decompose()).tolist()


def test_job_dt_weights_ordering(table, ref_table):
    bd = table.decompose()
    cls = classify_jobs(bd)
    w = job_dt_weights(bd)
    ci = w[cls == JOB_CLASSES.index(COMPUTE_INTENSIVE)]
    mi = w[cls == JOB_CLASSES.index(MEMORY_INTENSIVE)]
    assert float(ci.mean()) > 10 * max(float(mi.mean()), 1e-9)
    _close(w, ref_jobs.job_dt_weights(ref_table.decompose()))


# ----------------------------------------------- FleetAnalysis job surface
def test_from_jobs_aggregate_matches_flat_projection(fleet, ref_fleet):
    """Summing the per-job projection reproduces the flat projection to
    well under 0.5%; both views agree with the reference's."""
    flat = fleet.project([900], "freq")[0]
    per_job = fleet.project_jobs([900], "freq")
    agg = float(per_job.total_mwh.sum())
    assert agg == pytest.approx(flat.total_mwh, rel=5e-3)
    bd = fleet.per_job()
    assert float(bd.total_energy_mwh.sum()) == pytest.approx(
        fleet._decomposition().total_energy_mwh, rel=1e-9)
    assert float(bd.energy_mwh[:, 2].sum()) == pytest.approx(
        fleet._decomposition().energy_mwh[3], rel=1e-9)
    rflat = ref_fleet.project([900], "freq")[0]
    for k, v in rflat.to_dict().items():
        (_close if isinstance(v, float) else np.testing.assert_equal)(
            flat.to_dict()[k], v)
    rper = ref_fleet.project_jobs([900], "freq")
    for name in ("total_mwh", "savings_pct", "dt_pct", "savings_dt0_pct"):
        _close(getattr(per_job, name), getattr(rper, name))


@pytest.mark.parametrize("tables", [None, "tpu-v5e", "h100-sxm"])
@pytest.mark.parametrize("kind", ["freq", "power"])
def test_project_jobs_matches_reference(fleet, ref_fleet, tables, kind):
    caps = (1500, 1100, 900) if kind == "freq" else (450, 300, 200)
    got = fleet.project_jobs(caps, kind, tables=tables)
    want = ref_fleet.project_jobs(caps, kind, tables=tables)
    assert got.caps.tolist() == list(want.caps)
    for name in ("ci_mwh", "mi_mwh", "total_mwh", "savings_pct", "dt_pct",
                 "savings_dt0_pct"):
        _close(getattr(got, name), getattr(want, name))
    assert got.best_cap().tolist() == want.best_cap().tolist()
    assert got.best_cap(dt0_only=True).tolist() == \
        want.best_cap(dt0_only=True).tolist()


def test_class_report_reproduces_paper_per_class_claims(fleet, ref_fleet):
    """C.I.-class jobs peak at ~8.5% savings at the best cap; M.I.-class
    jobs take a cap that satisfies the dT=0 criterion; the whole report
    equals the reference's."""
    rep = fleet.job_report()
    by = rep.by_class()
    ci, mi, lb = (by[COMPUTE_INTENSIVE], by[MEMORY_INTENSIVE],
                  by[LATENCY_BOUND])
    assert ci.best_cap_savings_pct == pytest.approx(8.5, abs=1.0)
    assert ci.cap is not None and not ci.meets_dt0   # C.I. pays slowdown
    assert mi.cap is not None and mi.meets_dt0       # M.I.: dT=0 by policy
    assert mi.dt_pct <= 0.5
    assert mi.savings_pct > 10.0
    assert lb.cap is None and lb.savings_mwh == 0.0  # never capped
    assert rep.total_savings_mwh == pytest.approx(
        ci.savings_mwh + mi.savings_mwh, rel=1e-9)
    assert rep.dt0_savings_mwh >= mi.savings_mwh
    assert 0.0 < rep.savings_pct < 20.0
    _same_report(rep, ref_fleet.job_report())
    assert str(rep).splitlines()[0] == str(ref_fleet.job_report()) \
        .splitlines()[0]


@pytest.mark.parametrize("objective", ["energy", "edp", "ed2p",
                                       "perf_per_watt",
                                       "dt_bounded_savings"])
@pytest.mark.parametrize("caps,kind,tables", [
    (None, "freq", None), ((1300.0, 900.0), "freq", None),
    (None, "freq", "tpu-v5e"), (None, "power", None),
    ((1700.0, 1500.0, 1100.0, 700.0), "freq", "h100-sxm")])
def test_job_report_matches_reference(fleet, ref_fleet, objective, caps,
                                      kind, tables):
    got = fleet.job_report(caps, kind, tables=tables, objective=objective)
    want = ref_fleet.job_report(caps, kind, tables=tables,
                                objective=objective)
    _same_report(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_job_report_stability_across_seeds(seed):
    rep = FleetAnalysis.synthetic_jobs(600, seed=seed,
                                       device=CPU).job_report()
    ci = rep.by_class()[COMPUTE_INTENSIVE]
    assert ci.best_cap_savings_pct == pytest.approx(8.5, abs=1.5)
    assert rep.by_class()[MEMORY_INTENSIVE].meets_dt0
    _same_report(rep, RefFleetAnalysis.synthetic_jobs(
        600, seed=seed).job_report())


def test_summary_includes_job_classes(fleet, ref_fleet):
    s = fleet.summary()
    assert s["n_jobs"] == 600
    assert sum(s["job_classes"].values()) == 600
    r = ref_fleet.summary()
    assert s["job_classes"] == r["job_classes"]
    assert (s["chip"], s["samples"]) == (r["chip"], r["samples"])
    for key in ("hours_pct", "energy_pct"):
        assert s[key].keys() == r[key].keys()
        _close(list(s[key].values()), list(r[key].values()))
    _close(s["total_energy_mwh"], r["total_energy_mwh"])
    assert len(s["peaks_w"]) == len(r["peaks_w"])
    _close(s["peaks_w"], r["peaks_w"])


def test_flat_fleet_has_no_job_surface():
    """A flat fleet has no per-job view; the stream spellings next to it
    work and agree with the reference's: an empty stream, a flat
    analysis backed by a one-job stream, and a one-trace table's stream."""
    fa = FleetAnalysis.from_powers(np.full(100, 300.0), device=CPU)
    with pytest.raises(ValueError):
        fa.per_job()
    empty = FleetAnalysis.from_stream(iter([]), device=CPU)
    ref_empty = RefFleetAnalysis.from_stream(iter([]))
    assert empty.decompose().decomposition.total_energy_mwh \
        == ref_empty.decompose().decomposition.total_energy_mwh == 0.0
    from repro.power.stream import StreamingTelemetry as RefStreaming
    from repro_torch.power.stream import StreamingTelemetry, iter_array
    st = StreamingTelemetry(device=CPU).extend(iter_array(
        torch.full((100,), 300.0, dtype=torch.float64), chunk=33))
    assert fa.attach_stream(st) is fa
    ref_fa = RefFleetAnalysis.from_powers(np.full(100, 300.0))
    ref_fa.attach_stream(RefStreaming().extend([np.full(100, 300.0)]))
    assert fa.decomposition.energy_mwh == ref_fa.decomposition.energy_mwh
    with pytest.raises(ValueError):
        fa.per_job()                         # one job: still no job view
    table = JobTable([JobTrace("a", np.ones(3))], device=CPU)
    ref_table = ref_jobs.JobTable([ref_jobs.JobTrace("a", np.ones(3))])
    (got,), (want,) = list(table.to_stream()), list(ref_table.to_stream())
    _same_bits(got.power_w, want.power_w)
    _same_bits(got.time_s, want.time_s)
    assert got.job_id.tolist() == want.job_id.tolist() == ["a"] * 3


# ----------------------------------------------------- telemetry ingestion
def _tagged_store(store_cls=TelemetryStore, sample_cls=StepSample):
    ts = store_cls(window_s=15.0)
    t = 0.0
    for jid, power, n in [("jobA", 300.0, 120), ("jobB", 480.0, 60),
                          ("jobA", 310.0, 30)]:
        for i in range(n):
            ts.record(sample_cls(step=i, t=t, duration_s=1.0, power_w=power,
                                 energy_j=power, mode=2, freq_mhz=1700,
                                 job_id=jid))
            t += 1.0
    return ts


def test_jobtable_from_store_groups_by_job():
    table = JobTable.from_store(_tagged_store(), device=CPU)
    assert sorted(table.job_ids) == ["jobA", "jobB"]
    by_id = dict(zip(table.job_ids, table.traces))
    assert np.all(by_id["jobB"].powers == pytest.approx(480.0))
    # jobA got both of its segments, in order
    assert by_id["jobA"].powers.size > by_id["jobB"].powers.size
    ref = ref_jobs.JobTable.from_store(
        _tagged_store(RefTelemetryStore, RefStepSample))
    assert table.job_ids == ref.job_ids
    _same_bits(table.powers, ref.powers)


def test_from_store_multi_job_enables_job_surface():
    fa = FleetAnalysis.from_store(_tagged_store(), device=CPU)
    assert fa.jobs is not None
    cls = fa.job_classes()
    assert cls.shape == (2,)
    rep = fa.job_report()
    assert rep.total_energy_mwh > 0
    ref = RefFleetAnalysis.from_store(
        _tagged_store(RefTelemetryStore, RefStepSample))
    assert cls.tolist() == ref.job_classes().tolist()
    _same_report(rep, ref.job_report())
