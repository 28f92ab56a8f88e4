"""The slice as a whole at a small size, on the CPU: sweep -> tune ->
calibrate -> decompose_batch -> project_batch, through the same entry points
in both packages, every row held against the reference.

Tolerances as in the module tests: kernel validation, candidate costs, step
times, the modal decomposition and the projection from the measured MI250X
tables are equal bit for bit; what passes through ``f ** 2.4`` (powers,
energies, the calibrated tables and the projection that uses them) agrees
within rtol 1e-11 with every discrete pick equal."""
import numpy as np
import pytest
import torch

import repro.core.hardware as ref_hw
import repro.tuning as ref_tuning
from repro.configs.paper_vai import VAISuiteConfig as RefVAISuiteConfig
from repro.core import modal as ref_modal
from repro.core import projection as ref_proj
from repro.core import vai as ref_vai
from repro_torch.configs.paper_vai import VAISuiteConfig
from repro_torch.core import hardware as hw
from repro_torch.core import modal, projection
from repro_torch.core import vai as vai_sweep
from repro_torch.kernels import ops
from repro_torch.tuning import (MembwSpace, VaiSpace, SimulatedBackend,
                                calibrate, calibrated_tables,
                                register_calibration, tune)

RTOL = 1e-11
N_ELEMS = 1 << 16
FLEET = (48, 640)                      # (rows, samples): 5 segments a row


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=0.0)


@pytest.fixture(scope="module", params=["h100-sxm", "mi250x-gcd"])
def both(request):
    """The pipeline run once in each package, on the same inputs."""
    chip = request.param
    cfg = VAISuiteConfig(elements=N_ELEMS)
    rcfg = RefVAISuiteConfig(elements=N_ELEMS)
    loopsizes = [vai_sweep._loopsize_for(ai) for ai in cfg.intensities]
    out = {"chip": chip, "loopsizes": loopsizes}

    ops.reset_launch_counts()
    space = VaiSpace(n_elems=N_ELEMS, loopsizes=loopsizes[:9],
                     chip=hw.CHIPS[chip], device="cpu")
    out["tuned"] = tune(space, SimulatedBackend(chip, device="cpu"),
                        validate=True)
    out["mmeas"] = SimulatedBackend(chip, device="cpu").measure(
        MembwSpace(total_rows=1 << 11, n_iters=8, chip=hw.CHIPS[chip],
                   device="cpu"), validate=True)
    out["points"] = vai_sweep.run_sweep(cfg, chip=hw.CHIPS[chip],
                                        execute_kernel=True, device="cpu")
    out["cal"] = register_calibration(calibrate(out["tuned"].measurement))

    rspace = ref_tuning.VaiSpace(n_elems=N_ELEMS, loopsizes=loopsizes[:9],
                                 chip=ref_hw.CHIPS[chip])
    out["rtuned"] = ref_tuning.tune(rspace, ref_tuning.SimulatedBackend(chip),
                                    validate=True)
    out["rmmeas"] = ref_tuning.SimulatedBackend(chip).measure(
        ref_tuning.MembwSpace(total_rows=1 << 11, n_iters=8,
                              chip=ref_hw.CHIPS[chip]), validate=True)
    out["rpoints"] = ref_vai.run_sweep(rcfg, chip=ref_hw.CHIPS[chip],
                                       execute_kernel=False)
    out["rcal"] = ref_tuning.calibrate(out["rtuned"].measurement)

    powers = ref_modal.synth_fleet_powers(FLEET[0] * FLEET[1], seed=0
                                          ).reshape(FLEET)
    out["bd"] = modal.decompose_batch(torch.from_numpy(powers), 15.0)
    out["rbd"] = ref_modal.decompose_batch(powers, 15.0)
    return out


def test_benchmarks_validate_and_measure(both):
    m, r = both["tuned"].measurement, both["rtuned"].measurement
    assert m.validation_err == r.validation_err
    assert set(m.validation_err) == {0.0}
    assert m.configs == r.configs
    assert np.array_equal(m.time_s.numpy(), r.time_s)
    _close(m.power_w, r.power_w)
    mm, rm = both["mmeas"], both["rmmeas"]
    assert mm.validation_err == rm.validation_err == (0.0,) * 6
    assert np.array_equal(mm.time_s.numpy(), rm.time_s)
    # CPU tensors take the plain versions: no kernel was launched
    assert ops.launch_counts() == {"vai": 0, "membw": 0,
                                   "flash_attention": 0}


def test_sweep_rows(both):
    assert len(both["points"]) == len(both["rpoints"]) == 16 * 13
    for p, r in zip(both["points"], both["rpoints"]):
        assert (p.ai, p.loopsize, p.freq_mhz, p.power_cap_w, p.time_rel) == \
            (r.ai, r.loopsize, r.freq_mhz, r.power_cap_w, r.time_rel)
        _close((p.power_w, p.energy_rel), (r.power_w, r.energy_rel))


def test_tuned_cells(both):
    for objective in ("time", "energy"):
        cell = both["tuned"].best(objective)
        rcell = both["rtuned"].best(objective)
        assert (cell.index, cell.config, cell.freq_mhz, cell.time_s) == \
            (rcell.index, rcell.config, rcell.freq_mhz, rcell.time_s)
        _close(cell.energy_j, rcell.energy_j)


def test_calibrated_tables_rows(both):
    cal, rcal = both["cal"], both["rcal"]
    assert calibrated_tables("vai", chip=both["chip"], device="cpu") \
        is cal.tables
    assert cal.tables.source == rcal.tables.source
    for col, rcol in ((cal.tables.vai, rcal.tables.vai),
                      (cal.tables.mb, rcal.tables.mb)):
        assert list(col) == list(rcol)
        for k in col:
            _close(col[k], rcol[k])


def test_fleet_decomposition_rows(both):
    bd, rbd = both["bd"], both["rbd"]
    assert np.array_equal(bd.hours_pct.numpy(), rbd.hours_pct)
    assert np.array_equal(bd.energy_mwh.numpy(), rbd.energy_mwh)
    assert np.array_equal(bd.total_energy_mwh.numpy(), rbd.total_energy_mwh)
    agg = bd.aggregate()
    for m in hw.MODES:
        assert abs(agg.hours_pct[m.idx] - m.gpu_hours_pct) < 0.5


def test_projection_rows(both):
    bd, rbd = both["bd"], both["rbd"]
    caps = sorted(hw.PAPER_TABLE_V_FREQ, reverse=True)

    def run(mod, d, tables, cs):
        return mod.project_batch(
            cs, "freq", e_ci_mwh=d.energy_mwh[:, 2],
            e_mi_mwh=d.energy_mwh[:, 1], e_total_mwh=d.total_energy_mwh,
            dt_weight=mod.DT_WEIGHT_PER_CI_HOUR * d.hours_frac(3),
            tables=tables)

    bp, rbp = run(projection, bd, None, caps), run(ref_proj, rbd, None, caps)
    for name in ("ci_mwh", "mi_mwh", "total_mwh", "savings_pct", "dt_pct",
                 "savings_dt0_pct"):
        assert np.array_equal(getattr(bp, name).numpy(), getattr(rbp, name))
    assert np.array_equal(bp.best_cap().numpy(), rbp.best_cap())

    own_caps = sorted(both["cal"].tables.vai, reverse=True)
    bp = run(projection, bd, both["cal"].tables, own_caps)
    rbp = run(ref_proj, rbd, both["rcal"].tables, own_caps)
    for name in ("ci_mwh", "mi_mwh", "total_mwh", "savings_pct", "dt_pct",
                 "savings_dt0_pct"):
        np.testing.assert_allclose(getattr(bp, name).numpy(),
                                   getattr(rbp, name), rtol=1e-9, atol=1e-18)
    assert np.array_equal(bp.best_cap().numpy(), rbp.best_cap())
    agg, ragg = bd.aggregate(), rbd.aggregate()
    rows = projection.project_from_decomposition(agg, caps, device="cpu")
    rrows = ref_proj.project_from_decomposition(ragg, caps)
    for row, rrow in zip(rows, rrows):
        _close([row.ci_mwh, row.mi_mwh, row.savings_pct, row.dt_pct],
               [rrow.ci_mwh, rrow.mi_mwh, rrow.savings_pct, rrow.dt_pct])
