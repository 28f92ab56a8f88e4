"""repro_torch's sharded executor (``parallel/executor.py``) on CPU float64
tensors, case for case against ``tests/test_executor.py`` and
``tests/test_objectives.py``'s executor case.

The reference's ``ShardedExecutor`` does not run on the installed jax (its
``enable_x64`` import is gone), so its oracle is the reference's numpy
stream path, which the reference executor was held to bit for bit. Stated
tolerances:

* the executor against the port's own plain path on the same device is
  exact: every replay report field and job row (``_assert_reports_identical``
  of the reference's suite), every ``decide_shard`` output element, every
  segment sum;
* against the reference's numpy ``replay`` / ``infer_profiles`` +
  ``decide_batch``: rtol 1e-12 (the port's pow and sums are not numpy's),
  with job order, ``n_samples``, the recorded decomposition, every count and
  every ``mode_idx`` equal;
* ``segment_sums`` is bit for bit the reference's numpy segment sums, and
  ``devices=["cpu"] * 8`` gives the bits of ``devices=["cpu"]``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.hardware import MI250X_GCD as REF_MI250X
from repro.core.hardware import TPU_V5E as REF_TPU_V5E
from repro.core.modal import classify_power as ref_classify_power
from repro.core.modal import synth_fleet_powers
from repro.power import ChipModel as RefChipModel
from repro.power import FleetAnalysis as RefFleetAnalysis
from repro.power import stream as ref_stream
from repro.power.policies import decide_batch as ref_decide_batch
from repro.power.policies import get_policy as ref_get_policy
from repro.power.scenarios import Study as RefStudy
from repro.power.scenarios import Workload as RefWorkload
from repro_torch.core.hardware import MI250X_GCD, TPU_V5E
from repro_torch.core.modal import classify_power
from repro_torch.parallel import ShardedExecutor
from repro_torch.power import ChipModel, FleetAnalysis
from repro_torch.power.policies import decide_batch, get_policy
from repro_torch.power.scenarios import Study, Workload
from repro_torch.power.stream import SampleShard, iter_array, replay

CPU = "cpu"
RTOL = 1e-12

POLICIES = [
    ("nominal", {}),
    ("static", {"freq_mhz": 1200}),
    ("power-cap", {"cap_w": 400.0}),
    ("energy-aware", {"slowdown_budget": 0.05}),
    ("energy-aware", {"slowdown_budget": 0.03, "objective": "edp"}),
    ("energy-aware", {"slowdown_budget": 0.10,
                      "objective": "perf_per_watt", "power_cap_w": 450.0}),
]


@pytest.fixture(scope="module")
def ex():
    # one executor for the module, as the reference's suite shares one: its
    # memo is keyed on policy, chips, duration, frequency and devices, so
    # sharing it shares no result between different questions
    return ShardedExecutor(devices=[CPU])


def _quantized(n, seed=0):
    return np.round(synth_fleet_powers(n, seed=seed) * 10.0) / 10.0


def _jids(n, n_jobs=7):
    return np.repeat([f"j{i:02d}" for i in range(n_jobs)],
                     -(-n // n_jobs))[:n]


def _cuts(n, seed, n_cuts=13):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=n_cuts, replace=False))
    return [0] + list(cuts) + [n]


def _shards(powers, jids, seed, device=CPU, **cols):
    """The port's shards at the reference suite's random boundaries."""
    b = _cuts(powers.size, seed)
    for lo, hi in zip(b[:-1], b[1:]):
        yield SampleShard.from_arrays(
            powers[lo:hi], job_id=jids[lo:hi], device=device,
            **{k: v[lo:hi] for k, v in cols.items() if v is not None})


def _ref_shards(powers, jids, seed, **cols):
    b = _cuts(powers.size, seed)
    for lo, hi in zip(b[:-1], b[1:]):
        yield ref_stream.SampleShard.from_arrays(
            powers[lo:hi], job_id=jids[lo:hi],
            **{k: v[lo:hi] for k, v in cols.items() if v is not None})


def _assert_reports_identical(a, b):
    assert a.energy_new_j == b.energy_new_j
    assert a.energy_base_j == b.energy_base_j
    assert a.energy_rec_j == b.energy_rec_j
    assert a.time_new_s == b.time_new_s
    assert a.time_rec_s == b.time_rec_s
    assert a.n_samples == b.n_samples
    assert a.recorded.energy_mwh == b.recorded.energy_mwh
    assert a.recorded.hours_pct == b.recorded.hours_pct
    assert a.replayed.energy_mwh == b.replayed.energy_mwh
    assert a.replayed.hours_pct == b.replayed.hours_pct
    assert [dataclasses.astuple(r) for r in a.jobs] \
        == [dataclasses.astuple(r) for r in b.jobs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=0.0)


def _same_as_reference(got, want):
    """A port report against the reference's numpy one."""
    assert (got.policy, got.chip, got.record_chip, got.n_samples) \
        == (want.policy, want.chip, want.record_chip, want.n_samples)
    for k in ("energy_rec_j", "energy_base_j", "energy_new_j", "time_rec_s",
              "time_new_s"):
        _close(getattr(got, k), getattr(want, k))
    assert [(r.job_id, r.n_samples) for r in got.jobs] \
        == [(r.job_id, r.n_samples) for r in want.jobs]
    _close([dataclasses.astuple(r)[2:] for r in got.jobs],
           [dataclasses.astuple(r)[2:] for r in want.jobs])
    assert dataclasses.asdict(got.recorded) \
        == dataclasses.asdict(want.recorded)
    for k in range(1, 5):
        _close(got.replayed.energy_mwh[k], want.replayed.energy_mwh[k])
        _close(got.replayed.hours_pct[k], want.replayed.hours_pct[k])


# ------------------------------------------------------------ replay parity
@pytest.mark.parametrize("policy,kw", POLICIES)
def test_replay_bitexact_random_shards(policy, kw, ex):
    powers = _quantized(20_000)
    jids = _jids(powers.size)
    a = replay(_shards(powers, jids, seed=3), policy, chip="mi250x-gcd",
               **kw)
    b = replay(_shards(powers, jids, seed=3), policy, chip="mi250x-gcd",
               executor=ex, **kw)
    _assert_reports_identical(a, b)
    ref = ref_stream.replay(_ref_shards(powers, jids, seed=3), policy,
                            chip="mi250x-gcd", **kw)
    _same_as_reference(b, ref)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("with_mode", [True, False])
@pytest.mark.parametrize("with_freq", [True, False])
def test_replay_bitexact_optional_columns(quantized, with_mode, with_freq,
                                          ex):
    n = 12_000
    rng = np.random.default_rng(5)
    powers = _quantized(n, seed=2) if quantized \
        else synth_fleet_powers(n, seed=2)
    jids = _jids(n)
    mode = ref_classify_power(powers, REF_MI250X) if with_mode else None
    freq = rng.choice([1100.0, 1400.0, 1700.0], size=n) if with_freq \
        else None
    args = dict(policy="energy-aware", slowdown_budget=0.05)
    a = replay(_shards(powers, jids, seed=7, mode=mode, freq_mhz=freq),
               chip=TPU_V5E, record_chip=MI250X_GCD, **args)
    b = replay(_shards(powers, jids, seed=7, mode=mode, freq_mhz=freq),
               chip=TPU_V5E, record_chip=MI250X_GCD, executor=ex, **args)
    _assert_reports_identical(a, b)
    ref = ref_stream.replay(
        _ref_shards(powers, jids, seed=7, mode=mode, freq_mhz=freq),
        chip=REF_TPU_V5E, record_chip=REF_MI250X, **args)
    _same_as_reference(b, ref)


@pytest.mark.parametrize("dedup", ["auto", True, False])
def test_replay_bitexact_dedup_modes(dedup):
    powers = _quantized(9_000, seed=4)
    ex = ShardedExecutor(devices=[CPU], dedup=dedup)
    a = replay(iter_array(powers, 2048, device=CPU), "power-cap",
               chip="mi250x-gcd", cap_w=420.0)
    b = replay(iter_array(powers, 2048, device=CPU), "power-cap",
               chip="mi250x-gcd", executor=ex, cap_w=420.0)
    _assert_reports_identical(a, b)
    ref = ref_stream.replay(ref_stream.iter_array(powers, 2048),
                            "power-cap", chip="mi250x-gcd", cap_w=420.0)
    _same_as_reference(b, ref)
    # each route ran: the memo (and so the dedup count) only when asked
    assert ex.stats["samples"] == powers.size
    assert ex.stats["dedup_samples"] == (0 if dedup is False
                                         else powers.size)


def test_unsupported_policy_falls_back(ex):
    class WeirdPolicy:
        name = "weird"
        _inner = get_policy("nominal")

        def decide(self, profile, chip):
            return self._inner.decide(profile, chip)

        def decide_batch(self, profiles, chip, device=None):
            return self._inner.decide_batch(profiles, chip, device)

    assert not ex.supports(WeirdPolicy())
    assert all(ex.supports(get_policy(p, **kw)) for p, kw in POLICIES)
    with pytest.raises(TypeError, match="supports"):
        ex.decide_shard(WeirdPolicy(), ChipModel(MI250X_GCD),
                        ChipModel(MI250X_GCD), torch.ones(4), None, 15.0,
                        1.0)
    powers = _quantized(4_000, seed=6)
    before = dict(ex.stats)
    a = replay(iter_array(powers, 1024, device=CPU), WeirdPolicy(),
               chip="mi250x-gcd")
    b = replay(iter_array(powers, 1024, device=CPU), WeirdPolicy(),
               chip="mi250x-gcd", executor=ex)
    _assert_reports_identical(a, b)
    assert ex.stats["samples"] == before["samples"]     # no decide_shard


# ------------------------------------------------------- decision fast paths
def test_memo_reuses_decisions_across_shards(ex):
    powers = torch.from_numpy(_quantized(40_000, seed=8))
    pol = get_policy("energy-aware", slowdown_budget=0.05)
    model = ChipModel(MI250X_GCD)
    ref = None
    calls = []
    hits = ex.stats["memo_hits"]
    for _ in range(3):                       # identical shards: warm memo
        before = ex.stats["kernel_calls"]
        out = ex.decide_shard(pol, model, model, powers, None, 15.0, 1.0)
        calls.append(ex.stats["kernel_calls"] - before)
        if ref is None:
            ref = out
        for r, o in zip(ref, out):
            assert torch.equal(r, o)
    assert calls[0] == 1 and calls[1] == calls[2] == 0   # warm: gathers
    assert ex.stats["memo_hits"] - hits == 2


def test_memo_bucket_collision_falls_back_exactly():
    # 100.001 and 100.004 land in one bucket at both memo scales (0.1 W
    # and 0.01 W); every sample is compared, so whichever write won the
    # scatter, the executor sees it and still matches the plain path
    ex = ShardedExecutor(devices=[CPU])
    powers = np.tile([100.001, 100.004, 350.25, 420.5], 2_000)
    a = replay(iter_array(powers, 4096, device=CPU), "energy-aware",
               chip="mi250x-gcd", slowdown_budget=0.05)
    b = replay(iter_array(powers, 4096, device=CPU), "energy-aware",
               chip="mi250x-gcd", executor=ex, slowdown_budget=0.05)
    _assert_reports_identical(a, b)
    assert list(ex._memo.values()) == [False]     # off for good
    assert ex.stats["memo_hits"] == 0
    # dedup took over the first shard; the second (3904 samples) is under
    # dedup="auto"'s 4096 and ran whole
    assert ex.stats["dedup_samples"] == 4096
    ref = ref_stream.replay(ref_stream.iter_array(powers, 4096),
                            "energy-aware", chip="mi250x-gcd",
                            slowdown_budget=0.05)
    _same_as_reference(b, ref)


def test_memo_distinguishes_chips_and_policies(ex):
    powers = _quantized(8_192, seed=9)
    p = torch.from_numpy(powers)
    mi, tpu = ChipModel(MI250X_GCD), ChipModel(TPU_V5E)
    pol = get_policy("energy-aware", slowdown_budget=0.05)
    out_mi = ex.decide_shard(pol, mi, mi, p, None, 15.0, 1.0)
    out_tpu = ex.decide_shard(pol, tpu, mi, p, None, 15.0, 1.0)
    assert not torch.equal(out_mi[0], out_tpu[0])
    prof = mi.surface(CPU).infer_profiles(p, 1.0, 15.0,
                                          classify_power(p, MI250X_GCD))
    ref_mi, ref_tpu = RefChipModel(REF_MI250X), RefChipModel(REF_TPU_V5E)
    ref_prof = ref_mi.surface().infer_profiles(
        powers, 1.0, 15.0, ref_classify_power(powers, REF_MI250X))
    ref_pol = ref_get_policy("energy-aware", slowdown_budget=0.05)
    for model, ref_model, out in ((mi, ref_mi, out_mi),
                                  (tpu, ref_tpu, out_tpu)):
        bd = decide_batch(pol, prof, model, device=CPU)
        for got, want in zip(out, (bd.energy_j, bd.baseline_energy_j,
                                   bd.time_s, bd.mode_idx)):
            assert torch.equal(got, want)
        rbd = ref_decide_batch(ref_pol, ref_prof, ref_model)
        _close(out[0], rbd.energy_j)
        _close(out[1], rbd.baseline_energy_j)
        _close(out[2], rbd.time_s)
        assert np.array_equal(out[3].numpy(), np.asarray(rbd.mode_idx))


@pytest.mark.parametrize("dedup", ["auto", True, False])
@pytest.mark.parametrize("policy,kw", [
    ("power-cap", {"cap_w": 300.0}),
    ("energy-aware", {"slowdown_budget": 0.05, "power_cap_w": 450.0})])
def test_decide_shard_elements_bitexact_at_small_shards(dedup, policy, kw):
    """Every element of decide_shard equals the plain path's, at 37-sample
    shards whose last elements the plain path's tensor ops reach by their
    tails. On the H100's power-cap grid one frequency's pow has two
    roundings on the CPU (torch.pow's vectorised body and its libm tail),
    and only a pow that gives an element one value wherever it lies keeps
    the decisions equal."""
    powers = torch.from_numpy(_quantized(8_000, seed=15))
    rec, model = ChipModel(MI250X_GCD), ChipModel("h100-sxm")
    pol = get_policy(policy, **kw)
    ex = ShardedExecutor(devices=[CPU], dedup=dedup)
    for s in range(0, powers.numel(), 37):
        p = powers[s:s + 37]
        out = ex.decide_shard(pol, model, rec, p, None, 15.0, 1.0,
                              return_modes=True)
        modes = classify_power(p, MI250X_GCD)
        bd = decide_batch(pol, rec.surface(CPU).infer_profiles(
            p, 1.0, 15.0, modes), model, device=CPU)
        for got, want in zip(out, (bd.energy_j, bd.baseline_energy_j,
                                   bd.time_s, bd.mode_idx, modes)):
            assert torch.equal(got, want.to(got.dtype)), s


# ------------------------------------------------------------- segment sums
def test_segment_sums_matches_numpy_fold(ex):
    powers = synth_fleet_powers(128 * 37, seed=10)
    modes = ref_classify_power(powers, REF_MI250X)
    ref = ref_stream._ModalAcc._contrib(powers, modes) \
        .reshape(5, -1, 128).sum(axis=-1)
    got = ex.segment_sums(torch.from_numpy(powers),
                          classify_power(torch.from_numpy(powers),
                                         MI250X_GCD))
    assert got.shape == (5, 37)
    assert np.array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="multiple of 128"):
        ex.segment_sums(torch.ones(130, dtype=torch.float64),
                        torch.ones(130, dtype=torch.int64))


def test_from_stream_with_executor_bitexact(ex):
    powers = _quantized(16_000, seed=11)
    jids = _jids(powers.size)
    a = FleetAnalysis.from_stream(_shards(powers, jids, seed=12),
                                  chip=MI250X_GCD)
    b = FleetAnalysis.from_stream(_shards(powers, jids, seed=12),
                                  chip=MI250X_GCD, executor=ex)
    da = a.decompose().decomposition
    db = b.decompose().decomposition
    assert da.hours_pct == db.hours_pct
    assert da.energy_mwh == db.energy_mwh
    assert da.total_energy_mwh == db.total_energy_mwh
    ref = RefFleetAnalysis.from_stream(_ref_shards(powers, jids, seed=12),
                                       chip=REF_MI250X)
    assert dataclasses.asdict(db) \
        == dataclasses.asdict(ref.decompose().decomposition)


# ------------------------------------------------------------ study wiring
def test_study_devices_knob_builds_executor(monkeypatch):
    w = Workload("w", "mi250x-gcd",
                 powers=torch.from_numpy(_quantized(2_000, seed=13)))
    s = Study(workloads=[w], policies=["energy-aware"], devices=[CPU])
    assert isinstance(s._executor, ShardedExecutor)
    assert s._executor.ndev == 1 and s._executor.devices[0].type == CPU
    n_cuda = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n_cuda} present"):
        ShardedExecutor(devices=4096)
    with pytest.raises(ValueError, match=f"only {n_cuda} present"):
        Study(workloads=[w], policies=["energy-aware"], devices=4096)
    # no CUDA device and no explicit device list: it raises, never the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="does not fall back"):
        ShardedExecutor()
    with pytest.raises(ValueError, match="only 0 present"):
        ShardedExecutor(devices=1)


def test_study_results_bitexact_with_executor(ex):
    powers = _quantized(10_000, seed=14)
    w = Workload("w", "mi250x-gcd", powers=torch.from_numpy(powers))
    policies = [("energy-aware", {"slowdown_budget": 0.05}),
                ("power-cap", {"cap_w": 420.0})]
    axes = dict(workloads=[w], chips=["mi250x-gcd", "tpu-v5e"],
                policies=policies)
    ra = Study(**axes).run()
    rb = Study(**axes, executor=ex).run()
    ref = RefStudy(workloads=[RefWorkload("w", "mi250x-gcd", powers=powers)],
                   chips=["mi250x-gcd", "tpu-v5e"], policies=policies).run()
    assert len(ra) == len(rb) == len(ref) == 4
    for ca, cb, cr in zip(ra.cells, rb.cells, ref.cells):
        assert (ca.workload, ca.chip, ca.policy) == \
               (cb.workload, cb.chip, cb.policy) == \
               (cr.workload, cr.chip, cr.policy)
        assert ca.savings_pct == cb.savings_pct
        assert ca.total_energy_mwh == cb.total_energy_mwh
        _assert_reports_identical(ca.detail, cb.detail)
        _same_as_reference(cb.detail, cr.detail)


# ------------------------------------------------ eight devices, one host
def test_eight_device_split_bitexact():
    """``["cpu"] * 8`` splits every call into eight pieces, each run on its
    own and gathered back in order: the bits of one device."""
    n = 60_000
    powers = _quantized(n, seed=0)
    jids = np.repeat([f"j{i}" for i in range(5)], n // 5)
    one = ShardedExecutor(devices=[CPU])
    eight = ShardedExecutor(devices=[CPU] * 8)
    assert eight.ndev == 8 and eight._capacity(1) == 128 * 8

    def shards():
        for a in range(0, n, 7777):
            yield SampleShard.from_arrays(powers[a:a + 7777],
                                          job_id=jids[a:a + 7777],
                                          device=CPU)

    kw = dict(chip="tpu-v5e", record_chip="mi250x-gcd",
              slowdown_budget=0.05)
    a = replay(shards(), "energy-aware", executor=one, **kw)
    b = replay(shards(), "energy-aware", executor=eight, **kw)
    _assert_reports_identical(a, b)
    _assert_reports_identical(a, replay(shards(), "energy-aware", **kw))
    # the chunked route and the segment sums, split eight ways
    for e in (one, eight):
        e.dedup = False
    p = torch.from_numpy(synth_fleet_powers(5_000, seed=1))
    m = classify_power(p, MI250X_GCD)
    pol = get_policy("power-cap", cap_w=400.0)
    mi = ChipModel(MI250X_GCD)
    for x, y in zip(one.decide_shard(pol, mi, mi, p, m, 15.0, 1.0),
                    eight.decide_shard(pol, mi, mi, p, m, 15.0, 1.0)):
        assert torch.equal(x, y)
    assert torch.equal(one.segment_sums(p[:128 * 37], m[:128 * 37]),
                       eight.segment_sums(p[:128 * 37], m[:128 * 37]))


# ------------------------------------------------------------- objectives
def test_executor_replay_parity_across_objectives(ex):
    powers = _quantized(400, seed=5)
    for knobs in ({"slowdown_budget": 0.05},
                  {"slowdown_budget": 0.05, "objective": "edp"}):
        pol = get_policy("energy-aware", **knobs)
        a = replay(iter_array(powers, device=CPU), pol)
        b = replay(iter_array(powers, device=CPU), pol, executor=ex)
        _assert_reports_identical(a, b)
        _same_as_reference(b, ref_stream.replay(
            ref_stream.iter_array(powers), ref_get_policy("energy-aware",
                                                          **knobs)))


# ------------------------------------------------------------------ card
@pytest.mark.card
@pytest.mark.parametrize("policy,kw", POLICIES)
def test_replay_bitexact_random_shards_on_the_card(policy, kw):
    """The first case on the card: the executor on the card equals the
    plain path on the card bit for bit, and the host within rtol 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ex = ShardedExecutor()
    powers = _quantized(20_000)
    jids = _jids(powers.size)
    a = replay(_shards(powers, jids, seed=3, device="cuda"), policy,
               chip="mi250x-gcd", **kw)
    b = replay(_shards(powers, jids, seed=3, device="cuda"), policy,
               chip="mi250x-gcd", executor=ex, **kw)
    _assert_reports_identical(a, b)
    host = replay(_shards(powers, jids, seed=3), policy, chip="mi250x-gcd",
                  **kw)
    assert [(r.job_id, r.n_samples) for r in b.jobs] \
        == [(r.job_id, r.n_samples) for r in host.jobs]
    _close([b.energy_new_j, b.energy_base_j, b.time_new_s],
           [host.energy_new_j, host.energy_base_j, host.time_new_s])
