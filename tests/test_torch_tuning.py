"""repro_torch.tuning against the reference package on the CPU: candidate
enumeration and costs, the simulated harness, the tuner's picks, the
calibration inverter and the JSON cache, which both packages read and write.

Stated tolerances: candidate costs (flops, modeled HBM bytes, grid steps),
analytic profiles and step times are equal bit for bit; powers, energies and
everything derived from them carry the ``rtol 1e-12`` of the pow path (see
tests/test_torch_surface.py); every discrete pick (argbest cell, family
split, table keys) is equal. The pruning rules differ by design — the
reference prunes by the sublane tile and a fast-memory footprint, this
package by the thread-block step and grid size — so enumeration is compared
on the candidates both packages keep."""
import json

import numpy as np
import pytest
import torch

import repro.tuning as ref_tuning
from repro.core.power_model import ChipModel as RefChipModel
from repro_torch import convert
from repro_torch.core.hardware import CHIPS, H100_SXM, MI250X_GCD
from repro_torch.core.power_model import ChipModel
from repro_torch.tuning import (MembwSpace, PerfParams, SimulatedBackend,
                                ValidationError, VaiSpace, WallClockBackend,
                                calibrate, calibrated_tables,
                                load_calibration, register_calibration,
                                save_calibration, tune)
import importlib
calibrate_mod = importlib.import_module("repro_torch.tuning.calibrate")

RTOL = 1e-12
CHIP_NAMES = ("h100-sxm", "mi250x-gcd", "tpu-v5e")


def _ref_chip(name):
    import repro.core.hardware as ref_hw
    return ref_hw.CHIPS[name]


def _spaces(chip_name, **kw):
    args = dict(n_elems=1 << 16, loopsizes=(0, 2, 8, 32, 128, 512),
                block_rows_options=(128, 256, 512))
    args.update(kw)
    return (VaiSpace(chip=CHIPS[chip_name], device="cpu", **args),
            ref_tuning.VaiSpace(chip=_ref_chip(chip_name), **args))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


# --------------------------------------------------------------- enumeration
@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_vai_candidates_and_costs_equal(chip):
    space, ref = _spaces(chip, block_rows_options=(4, 100, 200, 128, 512))
    kept, pruned = space.enumerate_all()
    rkept, rpruned = ref.enumerate_all()
    assert [c.config for c in kept] == [c.config for c in rkept]
    for c, r in zip(kept, rkept):
        assert (c.kernel, c.flops, c.hbm_bytes, c.grid_steps) == \
            (r.kernel, r.flops, r.hbm_bytes, r.grid_steps)
        assert c.label == r.label and c.config_dict == r.config_dict
    reasons = {dict(cfg)["block_rows"]: why for cfg, why in pruned}
    assert "block-misaligned" in reasons[4]
    assert "block-misaligned" in reasons[100]
    assert "indivisible" in reasons[200]
    assert {cfg for cfg, _ in pruned} == {cfg for cfg, _ in rpruned}


def test_vai_space_rules_of_the_card():
    # registers only: no fast-memory footprint prunes a block, however tall
    space = VaiSpace(n_elems=1 << 20, loopsizes=(8,),
                     block_rows_options=(8192,), vmem_limit_bytes=1 << 20,
                     device="cpu")
    kept, pruned = space.enumerate_all()
    assert len(kept) == 1 and not pruned and kept[0].vmem_bytes == 0
    # a block taller than the input clamps to one grid step
    space = VaiSpace(n_elems=1 << 16, loopsizes=(8,),
                     block_rows_options=(1024,), device="cpu")
    assert space.candidates()[0].grid_steps == 1
    assert VaiSpace(loopsizes=(-1,), device="cpu").enumerate_all()[1][0][1] \
        == "negative-loopsize"
    c = VaiSpace(n_elems=1 << 16, loopsizes=(8,), block_rows_options=(128,),
                 device="cpu").candidates()[0]
    assert c.get("block_rows") == 128 and c.get("loopsize") == 8
    with pytest.raises(KeyError):
        c.get("nope")
    with pytest.raises(ValueError, match="positive"):
        VaiSpace(n_elems=0, device="cpu")
    assert VaiSpace(device="cpu").chip == H100_SXM


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_membw_candidates_and_costs_equal(chip):
    args = dict(total_rows=1 << 14, n_iters=16,
                n_chunks_options=(1, 3, 8, 32, 1 << 14))
    space = MembwSpace(chip=CHIPS[chip], device="cpu", **args)
    ref = ref_tuning.MembwSpace(chip=_ref_chip(chip), **args)
    kept, pruned = space.enumerate_all()
    rkept, _ = ref.enumerate_all()
    both = {c.config for c in kept} & {c.config for c in rkept}
    assert {dict(c)["n_chunks"] for c in both} == {1, 8, 32}
    by_cfg = {c.config: c for c in rkept}
    for c in kept:
        r = by_cfg[c.config]
        assert (c.flops, c.hbm_bytes, c.grid_steps) == \
            (r.flops, r.hbm_bytes, r.grid_steps)
    reasons = {dict(cfg)["n_chunks"]: why for cfg, why in pruned}
    assert "indivisible" in reasons[3]
    assert "block-misaligned" in reasons[1 << 14]      # chunk_rows == 1


def test_membw_traffic_model_keeps_the_l2_boundary():
    # 32 MiB fits the H100's 50 MiB L2, 1 GiB does not
    small = MembwSpace(total_rows=65536, n_iters=64, n_chunks_options=(1, 4),
                       device="cpu")
    big = MembwSpace(total_rows=1 << 21, n_iters=64, n_chunks_options=(1, 4),
                     device="cpu")
    assert small.vmem_limit_bytes == H100_SXM.vmem_bytes == 50 * 2 ** 20
    assert [c.hbm_bytes for c in small.candidates()] == [2.0 ** 25] * 2
    assert [c.hbm_bytes for c in big.candidates()] == \
        [2.0 ** 30 * 64, 2.0 ** 28 * 64]
    # a chunk of a gigabyte is streamed, never resident: it is kept
    assert not big.enumerate_all()[1]


# ---------------------------------------------------------------- validation
def test_validate_bit_for_bit_and_error():
    vs = VaiSpace(n_elems=1 << 14, loopsizes=(0, 1, 8, 64),
                  block_rows_options=(64, 128), device="cpu")
    assert all(err == 0.0 for err in vs.validate_all().values())
    ms = MembwSpace(total_rows=1 << 11, n_iters=8,
                    n_chunks_options=(1, 2, 4, 8), device="cpu")
    assert all(err == 0.0 for err in ms.validate_all().values())
    cand = vs.candidates()[0]
    orig = vs._reference
    vs._reference = lambda c: orig(c) + 1.0
    with pytest.raises(ValidationError, match="bit-for-bit"):
        vs.validate(cand)
    # seeded inputs: the same seed draws the same tensors
    again = VaiSpace(n_elems=1 << 14, loopsizes=(1,), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        again._get_inputs(),
        VaiSpace(n_elems=1 << 14, loopsizes=(1,), device="cpu")
        ._get_inputs()))
    again.release()
    assert again._inputs is None


# ------------------------------------------------------------------- harness
@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_simulated_backend_matches_reference(chip):
    space, ref = _spaces(chip)
    backend = SimulatedBackend(chip, device="cpu")
    meas = backend.measure(space)
    rmeas = ref_tuning.SimulatedBackend(chip).measure(ref)
    assert meas.source == rmeas.source == f"simulated:{chip}"
    assert meas.shape == rmeas.shape and meas.configs == rmeas.configs
    assert np.array_equal(meas.freq_fracs.numpy(), rmeas.freq_fracs)
    assert np.array_equal(meas.time_s.numpy(), rmeas.time_s)
    _close(meas.power_w, rmeas.power_w)
    _close(meas.energy_j, rmeas.energy_j)
    assert meas.nominal_column() == rmeas.nominal_column()
    for i, cand in enumerate(meas.candidates[::5]):
        for j, f in enumerate(meas.freq_fracs.tolist()):
            t, p = backend.measure_one(space, cand, f)
            assert t == float(meas.time_s[5 * i, j])
            _close(p, float(meas.power_w[5 * i, j]))


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_ideal_perf_reproduces_vai_profile(chip):
    model, rmodel = ChipModel(chip), RefChipModel(chip)
    space, ref = _spaces(chip, n_elems=1 << 18, loopsizes=(0, 8, 64, 1024),
                         block_rows_options=(256,))
    for cand, rcand in zip(space.candidates(), ref.candidates()):
        got = space.profile(cand, model, PerfParams.ideal())
        want = model.vai_profile(space.n_elems, cand.get("loopsize"))
        assert got == want
        rgot = ref.profile(rcand, rmodel, ref_tuning.PerfParams.ideal())
        assert (got.compute_s, got.memory_s, got.collective_s) == \
            (rgot.compute_s, rgot.memory_s, rgot.collective_s)
        perf = space.profile(cand, model, PerfParams())
        rperf = ref.profile(rcand, rmodel, ref_tuning.PerfParams())
        assert (perf.compute_s, perf.memory_s) == \
            (rperf.compute_s, rperf.memory_s)


def test_wallclock_backend_on_cpu_tensors():
    """The harness's anchored branch (no actuator): each profile is scaled
    so that its nominal step time is the measured time."""
    space = VaiSpace(n_elems=1 << 14, loopsizes=(0, 8), device="cpu",
                     block_rows_options=(128,))
    ticks = iter(range(1000))
    backend = WallClockBackend(H100_SXM, repeats=2, device="cpu",
                               timer=lambda: float(next(ticks)))
    meas = backend.measure(space, validate=True)
    assert meas.source == "wallclock:h100-sxm"
    assert meas.validation_err == (0.0, 0.0)
    assert backend.wall_s == (1.0, 1.0)
    j0 = meas.nominal_column()
    _close(meas.time_s[:, j0], [1.0, 1.0])
    with pytest.raises(ValueError, match="repeats"):
        WallClockBackend(repeats=0, device="cpu")
    # the hooks stay hooks: with both, the response is measured directly
    seen = []
    direct = WallClockBackend(H100_SXM, repeats=1, device="cpu",
                              actuator=seen.append,
                              power_sensor=lambda: 321.0,
                              timer=lambda: float(next(ticks)))
    m = direct.measure(space, freq_fracs=[1.0, 0.5])
    assert seen == [1.0, 0.5]
    assert torch.equal(m.power_w, torch.full((2, 2), 321.0,
                                             dtype=torch.float64))


# --------------------------------------------------------------------- tuner
@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_tuner_picks_match_reference(chip):
    space, ref = _spaces(chip, loopsizes=(8, 1024))
    res = tune(space, validate=False)
    rres = ref_tuning.tune(ref, validate=False)
    for objective in ("time", "energy", "edp", "ed2p", "perf_per_watt"):
        for budget in (None, 0.1):
            cell = res.best(objective, slowdown_budget=budget)
            rcell = rres.best(objective, slowdown_budget=budget)
            assert cell.index == rcell.index, (objective, budget)
            assert (cell.objective, cell.config, cell.freq_frac,
                    cell.freq_mhz, cell.time_s) == \
                (rcell.objective, rcell.config, rcell.freq_frac,
                 rcell.freq_mhz, rcell.time_s)
            _close(cell.energy_j, rcell.energy_j)
    fast, green = res.best("time"), res.best("energy")
    assert fast.index != green.index and green.energy_j < fast.energy_j
    with pytest.raises(ValueError, match="tuning objective"):
        res.best("not-a-metric")
    assert "| energy |" in res.summary()


# --------------------------------------------------------------- calibration
@pytest.mark.parametrize("chip", CHIP_NAMES)
@pytest.mark.parametrize("kind", ("freq", "power"))
def test_calibrate_matches_reference(chip, kind):
    space, ref = _spaces(chip)
    cal = calibrate(SimulatedBackend(chip, device="cpu").measure(space),
                    kind=kind)
    rcal = ref_tuning.calibrate(ref_tuning.SimulatedBackend(chip).measure(ref),
                                kind=kind)
    assert (cal.kernel, cal.source, cal.kind, cal.configs, cal.freq_fracs) \
        == (rcal.kernel, rcal.source, rcal.kind, rcal.configs,
            rcal.freq_fracs)
    np.testing.assert_allclose(cal.profiles.numpy(), rcal.profiles,
                               rtol=RTOL, atol=1e-18)
    assert (cal.tables.kind, cal.tables.source) == \
        (rcal.tables.kind, rcal.tables.source)
    for col, rcol in ((cal.tables.vai, rcal.tables.vai),
                      (cal.tables.mb, rcal.tables.mb)):
        assert list(col) == list(rcol)
        for k in col:
            _close(col[k], rcol[k], rtol=1e-11)
    _close(cal.fit_rms_pct, rcal.fit_rms_pct, rtol=1e-9)
    # the inversion pins the nominal time
    meas = SimulatedBackend(chip, device="cpu").measure(space)
    surf = ChipModel(chip).surface("cpu")
    j0 = meas.nominal_column()
    _close(surf.step_time(cal.profile_array(), float(meas.freq_fracs[j0])),
           meas.time_s[:, j0])


def test_calibrated_tables_registry_and_default_pipeline():
    assert sorted(calibrate_mod.SPACES) == ["flash_attention", "membw",
                                           "vai"]
    for kernel in ("vai", "membw"):
        tables = calibrated_tables(kernel, device="cpu")
        assert tables.kind == "freq"
        assert tables.source == f"calibrated:{kernel}:h100-sxm"
        assert tables.vai[max(tables.vai)] == pytest.approx((100.0,) * 3)
        assert calibrated_tables(kernel, device="cpu") is tables   # cached
        rtables = ref_tuning.calibrated_tables(kernel, chip="h100-sxm")
        # membw's reference space loses candidates to its own footprint
        # rule on no chip here, so the default pipelines agree
        assert list(tables.vai) == list(rtables.vai)
        for k in tables.vai:
            _close(tables.vai[k], rtables.vai[k], rtol=1e-11)
            _close(tables.mb[k], rtables.mb[k], rtol=1e-11)
    with pytest.raises(ValueError, match="unknown kernel"):
        calibrated_tables("softmax", device="cpu")
    space, _ = _spaces("mi250x-gcd")
    cal = calibrate(SimulatedBackend("mi250x-gcd", device="cpu")
                    .measure(space), kind="power")
    assert register_calibration(cal) is cal
    assert calibrated_tables("vai", kind="power", chip=MI250X_GCD,
                             device="cpu") is cal.tables
    assert calibrate_mod.registered_calibration(
        "vai", "power", "mi250x-gcd") is cal
    assert calibrate_mod.registered_calibration("vai", "power") is None


# ---------------------------------------------------- the JSON cache, crossed
def test_cache_round_trip_within_the_port(tmp_path):
    space, _ = _spaces("h100-sxm")
    cal = calibrate(SimulatedBackend(H100_SXM, device="cpu").measure(space))
    path = str(tmp_path / "cal.json")
    save_calibration(cal, path)
    cal2 = load_calibration(path, device="cpu")
    assert cal2.tables == cal.tables and cal2.configs == cal.configs
    assert cal2.freq_fracs == cal.freq_fracs and cal2.chip == cal.chip
    assert torch.equal(cal2.profiles, cal.profiles)
    first = open(path, "rb").read()
    save_calibration(cal2, path)
    assert open(path, "rb").read() == first
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": 99}')
    with pytest.raises(ValueError, match="schema"):
        load_calibration(str(bad), device="cpu")


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_cache_written_by_the_reference_loads_and_writes_back(chip,
                                                              tmp_path):
    """A file saved by the reference package loads here, and this package's
    ``save_calibration`` writes it back byte for byte; and the other way."""
    _, ref = _spaces(chip)
    rcal = ref_tuning.calibrate(ref_tuning.SimulatedBackend(chip).measure(ref))
    theirs = str(tmp_path / "theirs.json")
    ref_tuning.save_calibration(rcal, theirs)
    cal = load_calibration(theirs, device="cpu")
    assert cal.tables.vai == rcal.tables.vai and cal.tables.mb == rcal.tables.mb
    assert np.array_equal(cal.profiles.numpy(), rcal.profiles)
    assert cal.chip.name == chip and cal.configs == rcal.configs
    ours = str(tmp_path / "ours.json")
    save_calibration(cal, ours)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = ref_tuning.load_calibration(ours)
    assert back.tables == rcal.tables
    assert np.array_equal(back.profiles, rcal.profiles)
    doc = json.load(open(theirs))
    assert convert.calibration_to_doc(
        convert.calibration_from_doc(doc, device="cpu")) == doc


# ------------------------------------------------------- state carried across
@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_convert_measurement_and_tables(chip):
    """A reference Measurement, handed over as arrays, calibrates here to
    what the reference calibrates it to."""
    space, ref = _spaces(chip)
    rmeas = ref_tuning.SimulatedBackend(chip).measure(ref)
    meas = convert.measurement(rmeas.kernel, rmeas.chip.name, rmeas.configs,
                               rmeas.freq_fracs, rmeas.time_s, rmeas.power_w,
                               source=rmeas.source, space=space, device="cpu")
    assert meas.configs == rmeas.configs
    assert [c.flops for c in meas.candidates] == \
        [c.flops for c in rmeas.candidates]
    assert np.array_equal(meas.power_w.numpy(), rmeas.power_w)
    bare = convert.measurement(rmeas.kernel, rmeas.chip.name, rmeas.configs,
                               rmeas.freq_fracs, rmeas.time_s, rmeas.power_w,
                               device="cpu")
    cal, rcal = calibrate(bare), ref_tuning.calibrate(rmeas)
    for k in cal.tables.vai:
        _close(cal.tables.vai[k], rcal.tables.vai[k], rtol=1e-11)
    t = convert.response_tables(rcal.tables.vai, rcal.tables.mb,
                                kind=rcal.tables.kind,
                                source=rcal.tables.source)
    assert (t.vai, t.mb, t.kind, t.source) == \
        (dict(rcal.tables.vai), dict(rcal.tables.mb), rcal.tables.kind,
         rcal.tables.source)
    rpa = rcal.profile_array()
    pa = convert.profile_array(rpa.compute_s, rpa.memory_s, rpa.collective_s,
                               device="cpu")
    for got, want in zip(convert.profile_array_to_numpy(pa),
                         (rpa.compute_s, rpa.memory_s, rpa.collective_s)):
        assert np.array_equal(got, want)


# ------------------------------------------------------------ flash attention
def _flash_spaces(causal=True, **kw):
    from repro_torch.tuning import FlashAttentionSpace
    args = dict(batch_heads=2, seq_q=256, head_dim=64, causal=causal)
    args.update(kw)
    return (FlashAttentionSpace(chip=H100_SXM, device="cpu", **args),
            ref_tuning.FlashAttentionSpace(chip=_ref_chip("h100-sxm"),
                                           **args))


def test_flash_space_enumerates_the_reference_lattice():
    space, ref = _flash_spaces(block_q_options=(32, 64, 128, 256),
                               block_k_options=(64, 128, 256))
    assert space._raw_configs() == ref._raw_configs()
    kept = [c.config_dict for c in space.candidates()]
    assert kept == [dict(block_k=k, block_q=q) for q in (32, 64, 128)
                    for k in (64, 128)]


def test_flash_space_rules_of_the_card():
    """Tiles the kernel is not instantiated for, tiles whose shared memory
    overflows the 227 KB of a block, and tiles that do not divide the
    sequence are pruned, each with its reason."""
    from repro_torch.kernels import flash_attention as fa
    space, _ = _flash_spaces(seq_q=192, head_dim=128,
                             block_q_options=(16, 64, 128),
                             block_k_options=(64, 128, 512))
    pruned = {(dict(c)["block_q"], dict(c)["block_k"]): why
              for c, why in space.enumerate_all()[1]}
    assert "not-instantiated" in pruned[(16, 64)]
    assert "not-instantiated" in pruned[(64, 512)]
    assert "indivisible" in pruned[(128, 64)]            # 192 % 128
    assert "indivisible" in pruned[(64, 128)]            # 192 % 128 (kv)
    kept = [c.config_dict for c in space.candidates()]
    assert kept == [dict(block_k=64, block_q=64)]
    big, _ = _flash_spaces(seq_q=256, head_dim=128, block_q_options=(128,),
                           block_k_options=(128,))
    (cfg, why), = big.enumerate_all()[1]
    assert "smem-overflow" in why
    assert fa.smem_bytes(4, 128, 128, 128) > fa.SMEM_LIMIT_BYTES
    # any head dim runs at its class, so head dim 96 keeps every tile
    # that fits there, as head dim 128 does but 128 x 128
    odd, _ = _flash_spaces(head_dim=96)
    assert [c.config_dict for c in odd.candidates()] == \
        [dict(block_k=k, block_q=q) for q in (32, 64, 128) for k in (64, 128)]
    # above 256 the chunked kernel's tiles are the default options and
    # kept; the narrow kernel's tiles are pruned as not built there
    wide, _ = _flash_spaces(head_dim=264)
    assert [c.config_dict for c in wide.candidates()] == \
        [dict(block_k=32, block_q=32), dict(block_k=32, block_q=64)]
    narrow, _ = _flash_spaces(head_dim=264, block_q_options=(32, 64, 128),
                              block_k_options=(64, 128))
    assert narrow.candidates() == []
    assert all("not-instantiated" in why and "above 256" in why
               for _, why in narrow.enumerate_all()[1])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_candidate_costs(causal):
    """Non-causal: the reference's cost model exactly. Causal: only the
    (q tile, kv tile) pairs the kernel visits — the diagonal tiles in full,
    the tiles above them not at all."""
    space, ref = _flash_spaces(causal=causal, block_q_options=(128,),
                               block_k_options=(128,))
    (c,), (r,) = space.candidates(), ref.candidates()
    bh, s, d = 2, 256, 64
    if causal:
        # q tile 0 visits kv tile 0; q tile 1 visits kv tiles 0 and 1
        pairs, entries = 3, 3 * 128 * 128
        assert c.flops == 2.0 * bh * entries * (2 * d) < r.flops
        assert c.hbm_bytes == 4.0 * bh * (2 * s * d + 3 * 128 * 2 * d)
        assert c.grid_steps == bh * pairs
    else:
        assert (c.flops, c.hbm_bytes, c.grid_steps) == \
            (r.flops, r.hbm_bytes, r.grid_steps)
    from repro_torch.kernels import flash_attention as fa
    assert c.vmem_bytes == fa.smem_bytes(4, d, 128, 128)


def test_flash_tune_under_the_simulated_backend():
    """tune() validates every candidate's plain version against the oracle
    (2e-5) and picks from the simulated grid; the profiles follow the
    reference's formula on the port's costs."""
    space, _ = _flash_spaces()
    backend = SimulatedBackend(H100_SXM, device="cpu")
    result = tune(space, backend, validate=True)
    meas = result.measurement
    assert meas.kernel == "flash_attention"
    assert len(meas.validation_err) == len(space.candidates())
    assert max(meas.validation_err) <= space.tol
    fast, green = result.best("time"), result.best("energy")
    assert green.energy_j <= fast.energy_j
    model = ChipModel(H100_SXM)
    for c in space.candidates():
        prof = space.profile(c, model, PerfParams())
        eff = PerfParams().efficiency(c.get("block_q"), c.get("block_k"))
        assert prof.compute_s == (c.flops / H100_SXM.peak_flops / eff
                                  + c.grid_steps * 2e-6)
        assert prof.memory_s == c.hbm_bytes / H100_SXM.hbm_bw
    cal = calibrate(meas)
    assert set(cal.tables.vai) == set(cal.tables.mb)


@pytest.mark.parametrize("dims", [(32, 32), (96, 96), (256, 256),
                                  (192, 128)])
def test_flash_tune_at_any_head_dim_matches_the_reference(dims):
    """tune() over the tiles at head dims the kernels take only since they
    take any returns a result, as the reference's does; every kept
    candidate's output (on the CPU its plain version; chip_smoke.py runs
    the kernel) is within 2e-5 of the reference's Pallas kernel (interpret
    mode) on the same numpy inputs."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as ref_fa
    D, Dv = dims
    space, ref = _flash_spaces(head_dim=D, value_dim=Dv)
    result = tune(space, SimulatedBackend(H100_SXM, device="cpu"),
                  validate=True)
    rresult = ref_tuning.tune(ref, ref_tuning.SimulatedBackend(
        _ref_chip("h100-sxm")), validate=False)
    assert result.measurement.candidates and rresult.measurement.candidates
    assert max(result.measurement.validation_err) <= space.tol
    rng = np.random.default_rng(D + Dv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 256, D), (2, 256, D), (2, 256, Dv)))
    want = np.asarray(ref_fa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, block_q=128,
        block_k=128, interpret=True))
    space._qkv = tuple(torch.from_numpy(x) for x in (q, k, v))
    for c in result.measurement.candidates:
        got = space._run(c).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_flash_validation_catches_a_wrong_kernel(monkeypatch):
    space, _ = _flash_spaces()
    c = space.candidates()[0]
    assert space.validate(c) <= space.tol
    monkeypatch.setattr(space, "_run", lambda cand: space._reference(
        cand) + 1e-3)
    with pytest.raises(ValidationError, match="tolerance"):
        space.validate(c)


def test_spaces_registry_matches_the_reference():
    from repro_torch.tuning import SPACES
    assert set(SPACES) == set(ref_tuning.SPACES)
    space = SPACES["flash_attention"](H100_SXM, "cpu")
    assert (space.batch_heads, space.seq_q, space.head_dim) == (4, 1024, 128)
    assert [c.label for c in space.candidates()] == [
        "block_k=64,block_q=32", "block_k=128,block_q=32",
        "block_k=64,block_q=64", "block_k=128,block_q=64",
        "block_k=64,block_q=128"]
    tables = calibrated_tables("flash_attention", chip=H100_SXM,
                               device="cpu")
    assert tables.vai and tables.mb
