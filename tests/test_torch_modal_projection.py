"""repro_torch's modal decomposition, projection and VAI sweep against the
reference package, on CPU float64 tensors fed the same numpy-made samples.

Stated tolerances: ``classify_power``, ``stream_sum``, ``decompose_batch``,
``interp_response_batch`` and ``project_batch`` are equal **bit for bit** —
their sums run in one written-out order and the rest is exactly rounded
arithmetic. ``aggregate()`` sums over jobs with ``Tensor.sum`` (numpy's
pairwise order there): rtol 1e-12. The sweep's powers and energies carry the
``rtol 1e-12`` of the pow path; its loop sizes, frequencies, times and point
order are equal. ``synth_fleet_powers`` draws from a ``torch.Generator`` and
cannot give numpy's samples: it is held to the Table IV hour shares and to
the sample count."""
import numpy as np
import pytest
import torch

import repro.core.hardware as ref_hw
from repro.configs.paper_vai import VAISuiteConfig as RefVAISuiteConfig
from repro.core import modal as ref_modal
from repro.core import projection as ref_proj
from repro.core import vai as ref_vai
from repro.power.surface import response_table as ref_response_table
from repro_torch import convert
from repro_torch.configs.paper_vai import CONFIG, VAISuiteConfig
from repro_torch.core import hardware as hw
from repro_torch.core import modal, projection
from repro_torch.core import vai as vai_sweep

RTOL = 1e-12


def _powers(seed, *shape, chip=ref_hw.MI250X_GCD):
    n = int(np.prod(shape))
    return ref_modal.synth_fleet_powers(n, seed=seed, chip=chip).reshape(shape)


def _same_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


# ---------------------------------------------------------------- stream_sum
@pytest.mark.parametrize("n", [1, 7, 8, 127, 128, 129, 1000, 5760])
def test_stream_sum_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = rng.normal(300.0, 120.0, size=(9, n))
    _same_bits(modal.stream_sum(x, device="cpu"), ref_modal.stream_sum(x))
    _same_bits(modal.stream_sum(x[0], device="cpu"),
               ref_modal.stream_sum(x[0]))
    _same_bits(modal.stream_sum(x.T, axis=0, device="cpu"),
               ref_modal.stream_sum(x.T, axis=0))
    y = x * rng.integers(0, 2, size=x.shape)          # masked, as in use
    _same_bits(modal.stream_sum(torch.from_numpy(y)), ref_modal.stream_sum(y))


def test_stream_sum_bit_for_bit_past_ten_thousand_segments():
    """A row of 10,157 segments (1.3 M samples): the segment sums fold
    strictly left to right in one host pass, bit for bit with the
    reference's ``np.cumsum`` fold, rows and the flat case alike."""
    rng = np.random.default_rng(10_157)
    n = 10_157 * 128 - 77
    x = rng.normal(300.0, 120.0, size=(2, n))
    _same_bits(modal.stream_sum(x, device="cpu"), ref_modal.stream_sum(x))
    _same_bits(modal.stream_sum(x[1], device="cpu"),
               ref_modal.stream_sum(x[1]))


def test_stream_sum_is_chunk_associative():
    """The contract a streaming consumer relies on: folding segment-aligned
    shards left to right reproduces the batch sum bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).normal(300, 90, 1280))
    whole = modal.stream_sum(x)
    parts = [modal.stream_sum(x[k:k + 128]) for k in range(0, 1280, 128)]
    fold = parts[0]
    for part in parts[1:]:
        fold = fold + part
    assert torch.equal(fold, whole)


# ------------------------------------------------------------ classification
@pytest.mark.parametrize("chip", ["mi250x-gcd", "h100-sxm", "tpu-v5e"])
def test_classify_power_boundaries(chip):
    spec, rspec = hw.CHIPS[chip], ref_hw.CHIPS[chip]
    bounds = modal.scaled_mode_bounds(spec)
    rbounds = ref_modal.scaled_mode_bounds(rspec)
    assert [(m.idx, lo, hi) for m, lo, hi in bounds] == \
        [(m.idx, lo, hi) for m, lo, hi in rbounds]
    edges = [b for _, lo, hi in bounds for b in (lo, hi) if np.isfinite(b)]
    p = np.array(sorted({np.nextafter(e, d) for e in edges
                         for d in (-np.inf, np.inf)} | set(edges)
                        | {-5.0, 0.0, 1e9}))
    got = modal.classify_power(p, spec, device="cpu")
    want = ref_modal.classify_power(p, rspec)
    assert got.dtype == torch.int32
    _same_bits(got, want)
    q = _powers(1, 4, 333)
    _same_bits(modal.classify_power(torch.from_numpy(q), spec),
               ref_modal.classify_power(q, rspec))


# ------------------------------------------------------------- decomposition
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape", [(1, 5), (7, 300), (3, 5760)])
def test_decompose_batch_bit_for_bit(shape, with_mask):
    p = _powers(shape[1], *shape)
    mask = None
    if with_mask:
        lengths = np.random.default_rng(2).integers(0, shape[1] + 1, shape[0])
        mask = np.arange(shape[1])[None, :] < lengths[:, None]
    bd = modal.decompose_batch(torch.from_numpy(p), 15.0, mask=mask)
    rbd = ref_modal.decompose_batch(p, 15.0, mask=mask)
    _same_bits(bd.hours_pct, rbd.hours_pct)
    _same_bits(bd.energy_mwh, rbd.energy_mwh)
    _same_bits(bd.total_energy_mwh, rbd.total_energy_mwh)
    assert np.array_equal(bd.n_samples.numpy(), rbd.n_samples)
    _same_bits(bd.energy_pct(), rbd.energy_pct())
    _same_bits(bd.dominant_mode(), rbd.dominant_mode())
    _same_bits(bd.hours_frac(3), rbd.hours_frac(3))
    j, rj = bd.job(0), rbd.job(0)
    assert (j.hours_pct, j.energy_mwh, j.total_energy_mwh) == \
        (rj.hours_pct, rj.energy_mwh, rj.total_energy_mwh)
    agg, ragg = bd.aggregate(), rbd.aggregate()
    for k in agg.hours_pct:
        np.testing.assert_allclose(agg.hours_pct[k], ragg.hours_pct[k],
                                   rtol=RTOL)
        np.testing.assert_allclose(agg.energy_mwh[k], ragg.energy_mwh[k],
                                   rtol=RTOL)
    np.testing.assert_allclose(agg.total_energy_mwh, ragg.total_energy_mwh,
                               rtol=RTOL)
    assert agg.energy_pct().keys() == ragg.energy_pct().keys()


def test_decompose_flat_and_other_chip():
    p = _powers(4, 2000, chip=ref_hw.H100_SXM)
    d = modal.decompose(p, 15.0, hw.H100_SXM, device="cpu")
    rd = ref_modal.decompose(p, 15.0, ref_hw.H100_SXM)
    assert (d.hours_pct, d.energy_mwh, d.total_energy_mwh) == \
        (rd.hours_pct, rd.energy_mwh, rd.total_energy_mwh)


def test_histogram_and_peaks():
    p = _powers(5, 60000)
    for max_w in (None, 500.0):
        c, h = modal.power_histogram(p, bins=120, max_w=max_w, device="cpu")
        rc, rh = ref_modal.power_histogram(p, bins=120, max_w=max_w)
        np.testing.assert_allclose(c.numpy(), rc, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(h.numpy(), rh, rtol=1e-9, atol=1e-12)
        for smooth in (1, 3, 4):
            peaks = modal.detect_peaks(c, h, smooth=smooth)
            np.testing.assert_allclose(
                peaks, ref_modal.detect_peaks(rc, rh, smooth=smooth),
                rtol=1e-9)
    c, h = modal.power_histogram(np.empty(0), device="cpu")
    assert c.numel() == 0 and h.numel() == 0
    assert modal.detect_peaks(c, h) == []


@pytest.mark.parametrize("n", [0, 1, 3, 10, 999, 200_000])
def test_synth_fleet_powers_counts_and_shares(n):
    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    p = modal.synth_fleet_powers(n, generator=g, device="cpu")
    assert p.shape == (n,) and p.dtype == torch.float64
    assert bool(torch.isfinite(p).all())
    if n >= 999:
        d = modal.decompose(p)
        for m in hw.MODES:
            assert abs(d.hours_pct[m.idx] - m.gpu_hours_pct) < 0.5
    # seeded: the same seed draws the same fleet, another seed another
    a = modal.synth_fleet_powers(n, seed=1, device="cpu")
    b = modal.synth_fleet_powers(n, seed=1, device="cpu")
    assert torch.equal(a, b)
    if n >= 10:
        assert not torch.equal(
            a, modal.synth_fleet_powers(n, seed=2, device="cpu"))
    custom = modal.synth_fleet_powers(n, hours_pct={2: 60.0, 3: 40.0},
                                      device="cpu")
    assert custom.shape == (n,)


# ---------------------------------------------------------------- projection
def test_interp_response_batch_bit_for_bit():
    caps = np.array([1700.0, 1699.999, 1500.0, 1433.3, 900.0, 700.0, 650.0,
                     2000.0, 1100.0, 1000.1])
    for table in (hw.FREQ_RESPONSE_VAI, hw.FREQ_RESPONSE_MB,
                  hw.POWER_RESPONSE_VAI, {5: (1.0, 2.0, 3.0)}):
        _same_bits(projection.interp_response_batch(table, caps,
                                                    device="cpu"),
                   ref_proj.interp_response_batch(table, caps))
    for cap in caps:
        assert hw.interp_response(hw.FREQ_RESPONSE_VAI, cap) == \
            ref_hw.interp_response(ref_hw.FREQ_RESPONSE_VAI, cap)


@pytest.mark.parametrize("kind", ["freq", "power"])
def test_project_batch_bit_for_bit(kind):
    p = _powers(8, 40, 700)
    rbd = ref_modal.decompose_batch(p, 15.0)
    bd = modal.decompose_batch(torch.from_numpy(p), 15.0)
    caps = [1500, 1300, 1234.5, 900, 700] if kind == "freq" else \
        [500, 450.5, 300, 200]
    rtab = ref_response_table("h100-sxm", kind=kind)
    tab = convert.response_tables(rtab.vai, rtab.mb, kind=rtab.kind,
                                  source=rtab.source)
    h100_caps = sorted(rtab.vai)
    for tables, rtables, cs in ((None, None, caps), (tab, rtab, h100_caps)):
        bp = projection.project_batch(
            cs, kind, e_ci_mwh=bd.energy_mwh[:, 2],
            e_mi_mwh=bd.energy_mwh[:, 1], e_total_mwh=bd.total_energy_mwh,
            dt_weight=projection.DT_WEIGHT_PER_CI_HOUR * bd.hours_frac(3),
            tables=tables)
        rbp = ref_proj.project_batch(
            cs, kind, e_ci_mwh=rbd.energy_mwh[:, 2],
            e_mi_mwh=rbd.energy_mwh[:, 1], e_total_mwh=rbd.total_energy_mwh,
            dt_weight=ref_proj.DT_WEIGHT_PER_CI_HOUR * rbd.hours_frac(3),
            tables=rtables)
        for name in ("caps", "ci_mwh", "mi_mwh", "total_mwh", "savings_pct",
                     "dt_pct", "savings_dt0_pct"):
            _same_bits(getattr(bp, name), getattr(rbp, name))
        for objective in ("energy", "edp", "ed2p", "dt_bounded_savings"):
            _same_bits(bp.objective_value(objective),
                       rbp.objective_value(objective))
            _same_bits(bp.best_cap(objective=objective),
                       rbp.best_cap(objective=objective))
        _same_bits(bp.best_cap(dt0_only=True), rbp.best_cap(dt0_only=True))
        assert [r.to_dict() for r in bp.rows(3, "edp")] == \
            [r.to_dict() for r in rbp.rows(3, "edp")]
    with pytest.raises(ValueError, match="keyed"):
        projection.project_batch(caps, "power" if kind == "freq" else "freq",
                                 tables=tab, device="cpu")


def test_scalar_projections_equal_reference():
    caps = [1500, 1300, 1100, 900, 700]
    rows = projection.project(caps, device="cpu")
    assert [r.to_dict() for r in rows] == \
        [r.to_dict() for r in ref_proj.project(caps)]
    p = _powers(9, 5000)
    d = modal.decompose(p, device="cpu")
    rd = ref_modal.decompose(p)
    assert [r.to_dict() for r in projection.project_from_decomposition(
        d, caps, objective="edp", device="cpu")] == \
        [r.to_dict() for r in ref_proj.project_from_decomposition(
            rd, caps, objective="edp")]
    dom = {"chem": (100.0, 400.0), "bio": (20.0, 5.0)}
    got = projection.domain_targeted_project(dom, [1300, 900], device="cpu")
    want = ref_proj.domain_targeted_project(dom, [1300, 900])
    assert {k: [r.to_dict() for r in v] for k, v in got.items()} == \
        {k: [r.to_dict() for r in v] for k, v in want.items()}
    assert projection.builtin_tables("power").vai == \
        ref_proj.builtin_tables("power").vai
    with pytest.raises(ValueError, match="kind"):
        projection.builtin_tables("volts")


@pytest.mark.parametrize("kind", ["freq", "power"])
def test_validate_against_paper(kind):
    errs = projection.validate_against_paper(kind, device="cpu")
    assert errs == ref_proj.validate_against_paper(kind)
    for key, bound in projection.TABLE_V_BOUNDS[kind].items():
        assert errs[key] < bound


def test_validate_main_says_what_it_left_out(capsys):
    """Nothing is left out any more: all three legs run and pass."""
    assert projection.validate_main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "LEFT OUT" not in out and "not run" not in out
    assert "headline bootstrap 95% CI [7.88, 9.06]" in out
    assert "1438.25" in out and "paper validation ok" in out


# --------------------------------------------------------------------- sweep
def test_sweep_config_and_loopsizes():
    assert CONFIG.intensities == RefVAISuiteConfig().intensities
    assert CONFIG.frequencies_mhz == RefVAISuiteConfig().frequencies_mhz
    assert CONFIG.chunk_sizes == RefVAISuiteConfig().chunk_sizes
    ls = [vai_sweep._loopsize_for(ai) for ai in CONFIG.intensities]
    assert ls == [ref_vai._loopsize_for(ai) for ai in CONFIG.intensities]
    assert ls[:3] == [0, 0, 1]          # AI = 1/16 rounds half to even: 0
    assert len(ls) == 16 and ls[-1] == 8192


@pytest.mark.parametrize("chip", ["h100-sxm", "mi250x-gcd"])
def test_run_sweep_point_by_point(chip):
    cfg = VAISuiteConfig(elements=1 << 16)
    rcfg = RefVAISuiteConfig(elements=1 << 16)
    pts = vai_sweep.run_sweep(cfg, chip=hw.CHIPS[chip], execute_kernel=True,
                              device="cpu")
    rpts = ref_vai.run_sweep(rcfg, chip=ref_hw.CHIPS[chip],
                             execute_kernel=False)
    assert len(pts) == len(rpts) == 16 * 13
    for p, r in zip(pts, rpts):
        assert (p.ai, p.loopsize, p.freq_mhz, p.power_cap_w) == \
            (r.ai, r.loopsize, r.freq_mhz, r.power_cap_w)
        assert p.time_rel == r.time_rel
        assert (p.tflops, p.gbytes_s) == (r.tflops, r.gbytes_s)
        np.testing.assert_allclose(p.power_w, r.power_w, rtol=RTOL)
        np.testing.assert_allclose(p.energy_rel, r.energy_rel, rtol=RTOL)
        assert p.to_dict().keys() == r.to_dict().keys()
    for by in ("freq", "power"):
        t = vai_sweep.response_table(pts, by)
        rt = ref_vai.response_table(rpts, by)
        assert list(t) == list(rt)
        for cap in t:
            for key in ("power_pct", "runtime_pct", "energy_pct"):
                np.testing.assert_allclose(t[cap][key], rt[cap][key],
                                           rtol=RTOL)


def test_run_sweep_rejects_untileable_elements():
    cfg = VAISuiteConfig(elements=384 * 128, intensities=(0.5,))
    with pytest.raises(ValueError, match="does not tile"):
        vai_sweep.run_sweep(cfg, execute_kernel=False, device="cpu")
