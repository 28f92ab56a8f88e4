"""repro_torch's out-of-core stream (``power/stream.py``) and the ``.npz``
spill of ``core/telemetry.py`` against the reference package, on CPU
float64 tensors fed the same numpy inputs — the cases of
``tests/test_stream.py``, each also held against the reference's answer.

Stated tolerances:

* the streaming accumulators are bit for bit equal to the reference's
  ``StreamingModal`` and to the port's own ``decompose`` /
  ``decompose_batch`` of the concatenated trace, at random shard
  boundaries; per-job rows come in first-seen order, counts exact;
* the streaming histogram's integer counts and density equal the port's
  ``power_histogram`` exactly; against the reference's ``np.histogram``
  the density is held as ``tests/test_torch_modal_projection.py`` holds
  ``power_histogram`` (rtol 1e-9, atol 1e-12);
* replay energies and times agree with the reference to rtol 1e-12 (the
  port sums in another order than numpy's); job order, ``n_samples`` and
  every count are equal; replay against the port's own in-memory
  ``EnergySession`` to 1e-9, as the reference holds its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.modal import synth_fleet_powers
from repro.core.telemetry import StepSample as RefStepSample
from repro.core.telemetry import TelemetryStore as RefTelemetryStore
from repro.core.telemetry import load_spill as ref_load_spill
from repro.power import FleetAnalysis as RefFleetAnalysis
from repro.power import JobTable as RefJobTable
from repro.power import response_table as ref_response_table
from repro.power import stream as ref_stream
from repro_torch.core.hardware import MI250X_GCD, TPU_V5E
from repro_torch.core.modal import decompose, power_histogram
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.core.telemetry import (StepSample, TelemetryStore,
                                        load_spill)
from repro_torch.power import (EnergySession, FleetAnalysis, JobTable,
                               NominalPolicy, StreamingTelemetry,
                               response_table)
from repro_torch.power import stream as stream_mod
from repro_torch.parallel import ShardedExecutor
from repro_torch.power.jobs import JobTrace
from repro_torch.power.policies import decide_batch
from repro_torch.power.stream import (SampleShard, iter_array, iter_jsonl,
                                      iter_npz, iter_store, replay,
                                      write_jsonl)

CPU = "cpu"
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _random_trace(n=30_000, n_jobs=10, seed=0):
    """A fleet trace with job runs that revisit earlier job ids (so a job's
    samples arrive in several separated runs)."""
    rng = np.random.default_rng(seed)
    powers = synth_fleet_powers(n, seed=seed + 1)
    jids = np.empty(n, dtype="<U8")
    pos = 0
    while pos < n:
        run = int(rng.integers(40, 700))
        jids[pos:pos + run] = f"job{int(rng.integers(n_jobs)):03d}"
        pos += run
    return powers, jids


def _cuts(n, rng, n_cuts=29):
    """Random shard boundaries — at this density they cut mid-window and
    mid-job somewhere."""
    cuts = np.sort(rng.choice(np.arange(1, n), size=n_cuts, replace=False))
    return list(zip([0] + list(cuts), list(cuts) + [n]))


def _shard_pair(powers, jids, seed):
    bounds = _cuts(powers.size, np.random.default_rng(seed))
    port = [SampleShard.from_arrays(_t(powers[a:b]), job_id=jids[a:b])
            for a, b in bounds]
    ref = [ref_stream.SampleShard.from_arrays(powers[a:b], job_id=jids[a:b])
           for a, b in bounds]
    return port, ref


def _same_decomp(got, want):
    assert got.hours_pct == want.hours_pct
    assert got.energy_mwh == want.energy_mwh
    assert got.total_energy_mwh == want.total_energy_mwh


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_accumulators_bitexact_on_random_shards(seed):
    """Fleet scope, random boundaries: bit for bit with the reference's
    accumulators and the port's decompose of the whole trace."""
    powers, jids = _random_trace(seed=seed)
    port, ref = _shard_pair(powers, jids, seed)
    st = StreamingTelemetry(chip=MI250X_GCD, sample_interval_s=15.0)
    st.extend(port)
    rt = ref_stream.StreamingTelemetry(sample_interval_s=15.0).extend(ref)
    got = st.decomposition()
    _same_decomp(got, decompose(_t(powers), 15.0, MI250X_GCD))
    _same_decomp(got, rt.decomposition())
    assert st.n_samples == rt.n_samples == powers.size


def test_per_job_accumulators_bitexact_vs_decompose_batch():
    """Per-job scopes in first-seen order: bit for bit with the port's
    ``decompose_batch`` of the job-grouped matrix and with the
    reference's per-job accumulators."""
    powers, jids = _random_trace(seed=3)
    port, ref = _shard_pair(powers, jids, 3)
    st = StreamingTelemetry(chip=MI250X_GCD).extend(port)
    rt = ref_stream.StreamingTelemetry().extend(ref)
    order = list(dict.fromkeys(jids))
    table = JobTable([JobTrace(job_id=j, powers=powers[jids == j])
                      for j in order], chip=MI250X_GCD, device=CPU)
    want = table.decompose()
    got = st.per_job()
    assert st.job_ids() == order == rt.job_ids()
    ref_got = rt.per_job()
    for name in ("hours_pct", "energy_mwh", "total_energy_mwh",
                 "n_samples"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert np.array_equal(getattr(got, name).numpy(),
                              getattr(ref_got, name)), name


def test_per_job_fold_costs_one_gather_a_shard(monkeypatch):
    """The per-job fold's device work does not grow with the jobs in a
    shard: one segment reduction for the fleet scope and one for all the
    jobs' job-aligned segments, however many jobs the shard holds."""
    calls = []
    real = stream_mod._segment_sums

    def counting(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(stream_mod, "_segment_sums", counting)
    powers = synth_fleet_powers(20_000, seed=4)
    for n_jobs in (3, 120):
        calls.clear()
        jids = np.array([f"j{i % n_jobs}" for i in range(powers.size)])
        jids.sort(kind="stable")
        sm = stream_mod.StreamingModal()
        sm.fold(_t(powers), jids)
        assert len(calls) == 2, calls
        rt = ref_stream.StreamingModal()
        rt.fold(powers, jids)
        assert np.array_equal(sm.per_job().energy_mwh.numpy(),
                              rt.per_job().energy_mwh)


def test_streaming_histogram_bitexact():
    """Integer counts and density equal the port's ``power_histogram`` of
    the whole trace exactly; the reference's density to rtol 1e-9 /
    atol 1e-12 (its ``np.histogram`` bins edge samples its own way)."""
    powers, jids = _random_trace(seed=4)
    port, ref = _shard_pair(powers, jids, 4)
    st = StreamingTelemetry(chip=MI250X_GCD).extend(port)
    rt = ref_stream.StreamingTelemetry().extend(ref)
    c_want, h_want = power_histogram(_t(powers), bins=st.bins,
                                     max_w=st.max_w)
    c_got, h_got = st.histogram()
    assert torch.equal(c_got, c_want) and torch.equal(h_got, h_want)
    counts = torch.histc(torch.clamp(_t(powers), max=st.max_w),
                         bins=st.bins, min=0.0, max=st.max_w)
    assert torch.equal(st.hist_counts(), counts.to(torch.int64))
    assert int(st.hist_counts().sum()) == powers.size
    c_ref, h_ref = rt.histogram()
    np.testing.assert_allclose(c_got.numpy(), c_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(h_got.numpy(), h_ref, rtol=1e-9, atol=1e-12)


def test_from_stream_projection_matches_in_memory():
    powers = synth_fleet_powers(40_000, seed=5)
    fa = FleetAnalysis.from_stream(iter_array(_t(powers), chunk=4096))
    fb = FleetAnalysis.from_powers(_t(powers)).decompose()
    rows_a, rows_b = fa.project([1100, 900]), fb.project([1100, 900])
    for ra, rb in zip(rows_a, rows_b):
        assert ra.to_dict() == rb.to_dict()
    ref = RefFleetAnalysis.from_stream(ref_stream.iter_array(powers, 4096))
    for ra, rr in zip(rows_a, ref.project([1100, 900])):
        for k, v in rr.to_dict().items():
            if isinstance(v, float):
                _close(ra.to_dict()[k], v)
            else:
                assert ra.to_dict()[k] == v
    # chaining .decompose() on a streamed analysis must be a no-op refresh,
    # not a recompute over the (absent) raw tensor
    assert fa.decompose().decomposition.total_energy_mwh \
        == fb.decomposition.total_energy_mwh
    # single-job stream: no per-job view (from_store semantics); the
    # fleet-only fast path lands on the same numbers
    assert "n_jobs" not in fa.summary()
    fc = FleetAnalysis.from_stream(iter_array(_t(powers), chunk=4096),
                                   track_jobs=False)
    assert fc.decompose().decomposition.energy_mwh \
        == fb.decomposition.energy_mwh


def test_from_stream_job_report_matches_from_jobs():
    table = JobTable.synthetic(80, seed=6, device=CPU)
    fa = FleetAnalysis.from_stream(table.to_stream(samples_per_shard=777))
    fb = FleetAnalysis.from_jobs(table)
    ra, rb = fa.job_report(), fb.job_report()
    assert ra.to_dict() == rb.to_dict()
    assert torch.equal(fa.job_classes(), fb.job_classes())
    pa, pb = fa.project_jobs([900]), fb.project_jobs([900])
    assert torch.equal(pa.savings_pct, pb.savings_pct)
    ref = RefFleetAnalysis.from_stream(
        RefJobTable.synthetic(80, seed=6).to_stream(samples_per_shard=777))
    want = ref.job_report().to_dict()
    got = ra.to_dict()
    for c, w in zip(got.pop("classes"), want.pop("classes")):
        assert (c["job_class"], c["n_jobs"], c["cap"], c["meets_dt0"]) \
            == (w["job_class"], w["n_jobs"], w["cap"], w["meets_dt0"])
        _close([c[k] for k in ("energy_mwh", "savings_mwh", "savings_pct",
                               "dt_pct")],
               [w[k] for k in ("energy_mwh", "savings_mwh", "savings_pct",
                               "dt_pct")])
    assert got.keys() == want.keys()
    _close([got[k] for k in ("total_energy_mwh", "total_savings_mwh",
                             "savings_pct")],
           [want[k] for k in ("total_energy_mwh", "total_savings_mwh",
                              "savings_pct")])


def test_iter_jobs_keeps_the_reference_boundaries():
    """Jobs split mid-trace, several jobs a shard, ``time_s`` = arrival +
    offset: every shard equals the reference's."""
    table = JobTable.synthetic(25, seed=3, device=CPU)
    ref = RefJobTable.synthetic(25, seed=3)
    for spp in (1, 97, 4096):
        got = list(table.to_stream(samples_per_shard=spp))
        want = list(ref.to_stream(samples_per_shard=spp))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a.power_w.numpy(), b.power_w)
            assert np.array_equal(a.time_s.numpy(), b.time_s)
            assert np.array_equal(a.duration_s.numpy(), b.duration_s)
            assert a.job_id.tolist() == b.job_id.tolist()
    with pytest.raises(ValueError, match="samples_per_shard"):
        next(table.to_stream(samples_per_shard=0))


def test_streamed_histogram_bins_fixed_at_ingest():
    fa = FleetAnalysis.from_stream(
        iter_array(_t(synth_fleet_powers(2_000, seed=7)), chunk=512))
    centers, hist = fa.histogram()                   # ingest-time layout
    assert centers.numel() == 120
    with pytest.raises(ValueError, match="fixed at ingest"):
        fa.histogram(bins=64)
    assert len(fa.summary()["peaks_w"]) >= 1


def test_streamed_custom_bins_keep_peaks_and_summary_working():
    fa = FleetAnalysis.from_stream(
        iter_array(_t(synth_fleet_powers(2_000, seed=7)), chunk=512),
        bins=60)
    centers, _ = fa.histogram()
    assert centers.numel() == 60
    ref = RefFleetAnalysis.from_stream(
        ref_stream.iter_array(synth_fleet_powers(2_000, seed=7), 512),
        bins=60)
    np.testing.assert_allclose(fa.peaks(), ref.peaks(), rtol=1e-9)
    assert fa.summary()["samples"] == ref.summary()["samples"] == 2_000


def test_replay_empty_stream_reports_zero_deltas():
    rep = replay([], "energy-aware", chip=TPU_V5E)
    ref = ref_stream.replay([], "energy-aware", chip="tpu-v5e")
    for k in ("n_samples", "savings_pct", "dt_pct", "model_bias_pct"):
        assert getattr(rep, k) == getattr(ref, k) == 0
    assert rep.jobs == ref.jobs == []


@pytest.mark.parametrize("call", ["replay", "modal", "from_stream"])
def test_executor_raises_naming_item_5(call):
    """The three spellings that raised before the sharded executor was
    ported now run: with an executor each equals the same call without one,
    exactly, at random shard boundaries."""
    powers, jids = _random_trace(n=9_000, seed=21)
    bounds = _cuts(powers.size, np.random.default_rng(22))

    def shards():
        return (SampleShard.from_arrays(powers[a:b], job_id=jids[a:b],
                                        device=CPU) for a, b in bounds)
    ex = ShardedExecutor(devices=[CPU])
    if call == "replay":
        kw = dict(chip=TPU_V5E, record_chip=MI250X_GCD,
                  slowdown_budget=0.05)
        a = replay(shards(), "energy-aware", **kw)
        b = replay(shards(), "energy-aware", executor=ex, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert ex.stats["samples"] == powers.size
    elif call == "modal":
        a = stream_mod.StreamingModal()
        b = stream_mod.StreamingModal(executor=ex)
        for sh in shards():
            a.fold(sh.power_w, sh.job_id)
            b.fold(sh.power_w, sh.job_id)
        assert dataclasses.asdict(a.decomposition()) \
            == dataclasses.asdict(b.decomposition())
        for k in ("hours_pct", "energy_mwh", "total_energy_mwh",
                  "n_samples"):
            assert torch.equal(getattr(a.per_job(), k),
                               getattr(b.per_job(), k))
    else:
        a = FleetAnalysis.from_stream(shards(), chip=MI250X_GCD)
        b = FleetAnalysis.from_stream(shards(), chip=MI250X_GCD,
                                      executor=ex)
        assert dataclasses.asdict(a.decompose().decomposition) \
            == dataclasses.asdict(b.decompose().decomposition)
    assert ex.stats["kernel_calls"] > 0       # its segment sums ran


# ------------------------------------------------------------- sources
def _spilling_run(store_cls, sample_cls, powers, tmp_path, tag):
    spilling, keep = store_cls(window_s=15.0), store_cls(window_s=15.0)
    paths, t = [], 0.0
    for k, jid in enumerate(["a", "b", "a", "c"]):
        for i in range(700):
            p = float(powers[k * 700 + i])
            s = sample_cls(i, t, 1.0, p, p, 2, 1700, job_id=jid)
            spilling.record(s)
            keep.record(s)
            t += 1.0
        path = str(tmp_path / f"{tag}{k}.npz")
        assert spilling.spill_npz(path) > 0
        assert len(spilling.windows) == 0            # spill drops windows
        paths.append(path)
    return paths, keep


def test_npz_spill_stream_matches_store_pipeline(tmp_path):
    """Spill to .npz mid-run and stream the spills back: the never-spilled
    store's decomposition; and a spill written by either package reads in
    the other, window for window."""
    powers, _ = _random_trace(n=3_000, seed=8)
    paths, keep = _spilling_run(TelemetryStore, StepSample, powers,
                                tmp_path, "port")
    ref_paths, ref_keep = _spilling_run(RefTelemetryStore, RefStepSample,
                                        powers, tmp_path, "ref")
    st = StreamingTelemetry(chip=MI250X_GCD, sample_interval_s=15.0)
    st.extend(iter_npz(paths, device=CPU))
    want = decompose(_t(keep.powers()), 15.0, MI250X_GCD)
    _same_decomp(st.decomposition(), want)
    assert st.job_ids() == keep.job_ids()
    # cross-reading: port files in the reference, reference files here
    for mine, theirs in zip(paths, ref_paths):
        got_w, got_s = ref_load_spill(mine)
        want_w, want_s = load_spill(theirs)
        assert got_s == want_s == 15.0
        assert [dataclasses.asdict(w) for w in got_w] \
            == [dataclasses.asdict(w) for w in want_w]
    back = TelemetryStore.from_npz(ref_paths[0])
    assert back.window_s == 15.0 and len(back.windows) > 0
    ref_st = ref_stream.StreamingTelemetry().extend(
        ref_stream.iter_npz(paths))
    _same_decomp(st.decomposition(), ref_st.decomposition())


def test_iter_store_matches_from_store():
    def fill(store_cls, sample_cls):
        ts = store_cls(window_s=15.0)
        t = 0.0
        for i in range(200):
            ts.record(sample_cls(i, t, 1.0, 250.0 + i, 250.0 + i, 2, 1700,
                                 job_id="a" if i < 90 else "b"))
            t += 1.0
        return ts
    ts = fill(TelemetryStore, StepSample)
    fa = FleetAnalysis.from_stream(iter_store(ts, device=CPU),
                                   sample_interval_s=15.0)
    fb = FleetAnalysis.from_store(ts, device=CPU)
    assert fa.decompose().decomposition.energy_mwh \
        == fb.decompose().decomposition.energy_mwh
    ref = RefFleetAnalysis.from_stream(
        ref_stream.iter_store(fill(RefTelemetryStore, RefStepSample)),
        sample_interval_s=15.0)
    _same_decomp(fa.decomposition, ref.decompose().decomposition)


def test_jsonl_roundtrip(tmp_path):
    powers = synth_fleet_powers(1_500, seed=9)
    samples = [StepSample(i, float(i), 1.0, float(p), float(p), 2, 1700,
                          job_id=f"j{i % 3}")
               for i, p in enumerate(powers)]
    path = str(tmp_path / "log.jsonl")
    assert write_jsonl(samples, path) == len(samples)
    st = StreamingTelemetry(chip=MI250X_GCD, sample_interval_s=15.0)
    st.extend(iter_jsonl(path, chunk=331, device=CPU))
    want = decompose(_t(powers), 15.0, MI250X_GCD)
    assert st.decomposition().energy_mwh == want.energy_mwh
    assert st.job_ids() == ["j0", "j1", "j2"]
    # the reference reads the port's log into the same numbers
    ref = ref_stream.StreamingTelemetry().extend(
        ref_stream.iter_jsonl(path, chunk=331))
    _same_decomp(st.decomposition(), ref.decomposition())
    first = next(iter_jsonl(path, chunk=331, device=CPU))
    assert first.mode.dtype == torch.int64 and len(first) == 331


def test_shard_validation():
    with pytest.raises(ValueError, match="duration_s"):
        SampleShard.from_arrays([1.0, 2.0], duration_s=[1.0, 2.0, 3.0],
                                device=CPU)
    with pytest.raises(ValueError, match="duration_s"):
        ref_stream.SampleShard.from_arrays([1.0, 2.0],
                                           duration_s=[1.0, 2.0, 3.0])
    assert len(SampleShard.from_arrays(np.empty(0), device=CPU)) == 0
    # a tensor stays where it lies; iter_array yields views of it
    p = torch.arange(10, dtype=torch.float64)
    shards = list(iter_array(p, chunk=4))
    assert [len(s) for s in shards] == [4, 4, 2]
    assert shards[1].power_w.data_ptr() == p[4:].data_ptr()


# ------------------------------------------------------------- inversion
def test_infer_profiles_roundtrip():
    """power_w(infer_profiles(p, f, d, m), f) == p and step_time == d for
    in-band samples, at nominal and capped clocks."""
    surf = ChipModel(TPU_V5E).surface(CPU)
    rng = np.random.default_rng(10)
    T = rng.uniform(0.5, 2.0, size=64)
    r = rng.uniform(0.05, 0.4, size=64)
    profiles = [StepProfile(compute_s=t, memory_s=x * t) if i % 2 == 0
                else StepProfile(compute_s=x * t, memory_s=t)
                for i, (t, x) in enumerate(zip(T, r))]
    for f in (1.0, 0.7):
        bd = NominalPolicy().decide_batch(profiles, ChipModel(TPU_V5E),
                                          device=CPU) \
            if f == 1.0 else surf.decisions_at(profiles, f)
        inferred = surf.infer_profiles(bd.power_w, freq_frac=f,
                                       duration_s=bd.time_s,
                                       mode_idx=bd.mode_idx)
        np.testing.assert_allclose(surf.power_w(inferred, f).numpy(),
                                   bd.power_w.numpy(), rtol=1e-12)
        np.testing.assert_allclose(surf.step_time(inferred, f).numpy(),
                                   bd.time_s.numpy(), rtol=1e-12)


# --------------------------------------------------------------- replay
def _recorded_nominal(profiles, chip, jids):
    bd0 = NominalPolicy().decide_batch(profiles, chip, device=CPU)
    return SampleShard.from_arrays(
        bd0.power_w, job_id=jids, duration_s=bd0.time_s,
        energy_j=bd0.energy_j, mode=bd0.mode_idx, freq_mhz=bd0.freq_mhz)


def _split(shard, sizes, cls=SampleShard):
    prev = 0
    for k in sizes:
        sl = slice(prev, prev + k)
        yield cls.from_arrays(
            shard.power_w[sl], job_id=shard.job_id[sl],
            duration_s=shard.duration_s[sl], energy_j=shard.energy_j[sl],
            mode=shard.mode[sl], freq_mhz=shard.freq_mhz[sl])
        prev += k


def _ref_shard(shard):
    return ref_stream.SampleShard.from_arrays(
        shard.power_w.numpy(), job_id=shard.job_id,
        duration_s=shard.duration_s.numpy(),
        energy_j=shard.energy_j.numpy(), mode=shard.mode.numpy(),
        freq_mhz=shard.freq_mhz.numpy())


def _same_replay(got, want):
    assert (got.policy, got.chip, got.record_chip, got.n_samples) \
        == (want.policy, want.chip, want.record_chip, want.n_samples)
    for k in ("energy_rec_j", "energy_base_j", "energy_new_j", "time_rec_s",
              "time_new_s", "savings_pct", "dt_pct", "model_bias_pct"):
        _close(getattr(got, k), getattr(want, k))
    assert [(r.job_id, r.n_samples) for r in got.jobs] \
        == [(r.job_id, r.n_samples) for r in want.jobs]
    for a, b in zip(got.jobs, want.jobs):
        _close([a.energy_rec_j, a.energy_base_j, a.energy_new_j,
                a.time_rec_s, a.time_new_s],
               [b.energy_rec_j, b.energy_base_j, b.energy_new_j,
                b.time_rec_s, b.time_new_s])
    assert dataclasses.asdict(got.recorded) \
        == dataclasses.asdict(want.recorded)
    for k in range(1, 5):
        _close(got.replayed.energy_mwh[k], want.replayed.energy_mwh[k])
        _close(got.replayed.hours_pct[k], want.replayed.hours_pct[k])


@pytest.mark.parametrize("policy,knobs", [
    ("energy-aware", {}),
    ("energy-aware", {"slowdown_budget": 0.1}),
    ("power-cap", {"cap_w": 150.0}),
    ("static", {"freq_mhz": 1100}),
])
def test_replay_matches_observe_many(policy, knobs):
    """Replaying a recorded nominal trace under a policy == the same steps
    through the port's in-memory ``EnergySession.observe_many`` (1e-9), and
    the reference's replay of the same shards (rtol 1e-12)."""
    rng = np.random.default_rng(11)
    n = 400
    profiles = []
    for i in range(n):
        T = float(rng.uniform(0.5, 2.0))
        r = float(rng.uniform(0.05, 0.4))
        profiles.append(StepProfile(compute_s=T, memory_s=r * T)
                        if i % 2 else StepProfile(compute_s=r * T,
                                                  memory_s=T))
    chip = ChipModel(TPU_V5E)
    sess = EnergySession(policy=policy, chip=TPU_V5E, device=CPU, **knobs)
    sess.observe_many(profiles)

    jids = np.array(["a"] * (n // 2) + ["b"] * (n - n // 2))
    rec = _recorded_nominal(profiles, chip, jids)
    sizes = [137, 1, 200, n - 338]
    rep = replay(_split(rec, sizes), policy, chip=TPU_V5E, **knobs)
    assert rep.savings_pct == pytest.approx(sess.savings_pct(), abs=1e-9)
    assert rep.energy_new_j == pytest.approx(sess._energy_sum, rel=1e-9)
    assert rep.energy_rec_j == pytest.approx(sess._baseline_energy_sum,
                                             rel=1e-9)
    assert rep.n_samples == n
    assert sum(r.energy_new_j for r in rep.jobs) \
        == pytest.approx(rep.energy_new_j, rel=1e-12)
    assert {r.job_id for r in rep.jobs} == {"a", "b"}
    ref = ref_stream.replay(
        [_ref_shard(s) for s in _split(rec, sizes)], policy,
        chip="tpu-v5e", **knobs)
    _same_replay(rep, ref)


def test_replay_nominal_is_identity():
    rng = np.random.default_rng(12)
    profiles = [StepProfile(compute_s=float(t), memory_s=float(0.3 * t))
                for t in rng.uniform(0.5, 2.0, size=100)]
    chip = ChipModel(TPU_V5E)
    rec = _recorded_nominal(profiles, chip, np.array(["j"] * 100))
    rep = replay(_split(rec, [33, 33, 34]), "nominal", chip=TPU_V5E)
    assert rep.savings_pct == pytest.approx(0.0, abs=1e-9)
    assert rep.dt_pct == pytest.approx(0.0, abs=1e-9)


def test_replay_cross_chip_with_tables():
    """MI250X-measured trace replayed under a TPU-v5e energy-aware policy,
    with the model-derived response-table projection alongside — the
    reference's report to rtol 1e-12."""
    powers = synth_fleet_powers(10_000, seed=13)
    tables = response_table("tpu-v5e", kind="freq", device=CPU)
    rep = replay(iter_array(_t(powers), chunk=2048), "energy-aware",
                 chip="tpu-v5e", record_chip=MI250X_GCD)
    projection = rep.project(tables=tables)
    assert rep.record_chip == "mi250x-gcd" and rep.chip == "tpu-v5e"
    assert np.isfinite(rep.savings_pct)
    assert projection is not None and len(projection) >= 1
    want = decompose(_t(powers), 15.0, MI250X_GCD)
    assert rep.recorded.energy_mwh == want.energy_mwh
    assert "replay[energy-aware @ tpu-v5e]" in str(rep)
    rows = rep.project([900], kind="freq", tables=tables)
    assert rows[0].cap == 900
    ref = ref_stream.replay(ref_stream.iter_array(powers, chunk=2048),
                            "energy-aware", chip="tpu-v5e",
                            record_chip="mi250x-gcd")
    _same_replay(rep, ref)
    ref_rows = ref.project(tables=ref_response_table("tpu-v5e",
                                                     kind="freq"))
    assert [r.cap for r in projection] == [r.cap for r in ref_rows]
    _close([r.total_mwh for r in projection],
           [r.total_mwh for r in ref_rows])


def test_replay_job_rows_with_reappearing_jobs():
    """A shard whose jobs re-appear mid-shard takes the grouped path: job
    rows in first-seen order, sums to rtol 1e-12 of the reference's."""
    powers, jids = _random_trace(n=8_000, n_jobs=6, seed=14)
    rep = replay([SampleShard.from_arrays(_t(powers), job_id=jids)],
                 "energy-aware", chip="tpu-v5e", record_chip=MI250X_GCD)
    ref = ref_stream.replay(
        [ref_stream.SampleShard.from_arrays(powers, job_id=jids)],
        "energy-aware", chip="tpu-v5e", record_chip="mi250x-gcd")
    assert [r.job_id for r in rep.jobs] == list(dict.fromkeys(jids))
    _same_replay(rep, ref)


def test_replay_objective_knob_and_conflict():
    powers = synth_fleet_powers(3_000, seed=15)
    got = replay(iter_array(_t(powers), chunk=700), "energy-aware",
                 objective="edp", slowdown_budget=0.2)
    want = ref_stream.replay(ref_stream.iter_array(powers, chunk=700),
                             "energy-aware", objective="edp",
                             slowdown_budget=0.2)
    _same_replay(got, want)
    from repro_torch.power import EnergyAwarePolicy
    with pytest.raises(ValueError, match="objective"):
        replay([], EnergyAwarePolicy(objective="energy"), objective="edp")


def test_replay_third_party_policy_scalar_fallback():
    """A policy without decide_batch goes through the shared scalar-loop
    lift and must equal the built-in it mirrors."""
    class MirrorNominal:
        name = "mirror"

        def decide(self, profile, chip):
            return NominalPolicy().decide(profile, chip)

    profiles = [StepProfile(compute_s=1.0, memory_s=0.2),
                StepProfile(compute_s=0.1, memory_s=1.0)]
    chip = ChipModel(TPU_V5E)
    got = decide_batch(MirrorNominal(), profiles, chip, device=CPU)
    want = NominalPolicy().decide_batch(profiles, chip, device=CPU)
    np.testing.assert_allclose(got.energy_j.numpy(), want.energy_j.numpy(),
                               rtol=0)
    rec = _recorded_nominal(profiles, chip, np.array(["j", "j"]))
    rep = replay([rec], MirrorNominal(), chip=TPU_V5E)
    assert rep.savings_pct == pytest.approx(0.0, abs=1e-9)
    ref = ref_stream.replay([_ref_shard(rec)], MirrorNominal(),
                            chip="tpu-v5e")
    _same_replay(rep, ref)
