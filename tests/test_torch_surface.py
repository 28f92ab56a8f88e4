"""repro_torch's power model and transfer surface against the reference
package, on CPU float64 tensors, for ``h100-sxm``, ``mi250x-gcd`` and
``tpu-v5e``.

Stated tolerance: every continuous output agrees within ``rtol 1e-12``.
``+ * / max min`` are exactly rounded in both packages, but ``f ** 2.4``
goes through ``torch.pow`` here and numpy's pow there, and the two differ by
one ulp on some inputs (``test_pow_path_against_numpy`` measures it). Every
discrete decision — chosen frequency, mode index, cap grid point, argbest
cell — must be equal."""
import itertools

import numpy as np
import pytest
import torch
from golden_objectives import GOLDEN_DECISIONS, GOLDEN_SWEEPS

from repro.core.governor import sweep_decision as ref_sweep_decision
from repro.core.power_model import ChipModel as RefChipModel
from repro.core.power_model import StepProfile as RefStepProfile
from repro.power import objectives as ref_obj
from repro.power.surface import TransferSurface as RefSurface
from repro.power.surface import response_table as ref_response_table
from repro_torch.core.governor import sweep_decision
from repro_torch.core.hardware import CHIPS, H100_SXM
from repro_torch.core.power_model import GAMMA, ChipModel, StepProfile
from repro_torch.power import objectives as obj
from repro_torch.power.surface import (BatchDecision, ProfileArray,
                                       TransferSurface, response_table)

RTOL = 1e-12
CHIP_NAMES = ("h100-sxm", "mi250x-gcd", "tpu-v5e")
FREQS = (1.0, 0.93, 0.7, 0.5, 0.3)
GOLDEN_PROFILES = [(0.2, 1.0, 0.0), (1.0, 0.3, 0.0), (0.8, 0.8, 0.2),
                   (0.5, 0.1, 0.05), (0.05, 0.9, 0.3)]


def _profiles(seed=0, n=40):
    rng = np.random.default_rng(seed)
    arr = rng.uniform(0.0, 1.0, size=(n, 3))
    arr[:, 2] *= rng.integers(0, 2, size=n)        # half without collectives
    arr[: len(GOLDEN_PROFILES)] = GOLDEN_PROFILES
    return arr


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


def test_pow_path_against_numpy():
    """The one op that is not exactly rounded: measure torch.pow against
    numpy's array pow on a dense frequency grid (1 ulp at worst), and check
    that scalar and tensor calls of the surface take the same path."""
    f = np.linspace(0.05, 1.0, 4001)
    want = f ** GAMMA
    surf = TransferSurface(H100_SXM, device="cpu")
    got = surf._pow_gamma(f).numpy()
    ulp = np.abs(got - want) / np.spacing(want)
    assert ulp.max() <= 1.0
    _close(got, want)
    one = np.array([float(surf._pow_gamma(float(x))) for x in f[::97]])
    _close(one, got[::97])
    assert surf._pow_gamma(0.5).dtype == torch.float64


def test_registry_and_defaults():
    import repro.core.hardware as ref_hw
    import dataclasses
    assert {k: dataclasses.asdict(v) for k, v in CHIPS.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_hw.CHIPS.items()}
    assert ChipModel().spec.name == "h100-sxm"
    assert TransferSurface(device="cpu").spec.name == "h100-sxm"
    with pytest.raises(KeyError, match="unknown chip"):
        ChipModel("nope")
    m = ChipModel("mi250x-gcd")
    r = RefChipModel("mi250x-gcd")
    assert m.freq_grid(11) == r.freq_grid(11)
    assert m.freq_frac(1100) == r.freq_frac(1100)
    assert m.freq_mhz(0.5) == r.freq_mhz(0.5)
    assert m.vai_profile(1 << 20, 8).compute_s == \
        r.vai_profile(1 << 20, 8).compute_s
    for p_w in (50.0, 250.0, 500.0, 560.0):
        assert m.classify_mode_from_power(p_w).idx == \
            r.classify_mode_from_power(p_w).idx


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_scalar_chip_model_matches_reference(chip):
    m, r = ChipModel(chip), RefChipModel(chip)
    for (c, mem, n), f in itertools.product(_profiles()[:12], FREQS):
        p, rp = StepProfile(c, mem, n), RefStepProfile(c, mem, n)
        assert m.step_time(p, f) == r.step_time(rp, f)
        assert m.utilizations(p, f) == r.utilizations(rp, f)
        _close(m.power_w(p, f), r.power_w(rp, f))
        _close(m.energy_j(p, f), r.energy_j(rp, f))
        assert m.classify_mode(p, f).idx == r.classify_mode(rp, f).idx
    for c, mem, n in _profiles()[:12]:
        for cap in (0.4, 0.6, 0.9):
            cap_w = cap * m.spec.tdp_w
            assert m.freq_for_power_cap(StepProfile(c, mem, n), cap_w) == \
                r.freq_for_power_cap(RefStepProfile(c, mem, n), cap_w)


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_surface_grids_match_reference(chip):
    arr = _profiles(1)
    surf, ref = TransferSurface(chip, device="cpu"), RefSurface(chip)
    pa = ProfileArray.coerce(arr, "cpu")
    rpa = ref_surface_profiles(arr)
    fr = np.asarray(FREQS)
    assert np.array_equal(surf.step_time(pa.expand(), fr).numpy(),
                          ref.step_time(rpa.expand(), fr))
    _close(surf.power_w(pa.expand(), fr), ref.power_w(rpa.expand(), fr))
    _close(surf.energy_j(pa.expand(), fr), ref.energy_j(rpa.expand(), fr))
    assert np.array_equal(surf.classify_mode_idx(pa).numpy(),
                          ref.classify_mode_idx(rpa))
    caps = np.linspace(0.3, 1.0, 5) * surf.spec.tdp_w
    assert np.array_equal(
        surf.freq_for_power_cap(pa.expand(), caps).numpy(),
        ref.freq_for_power_cap(rpa.expand(), caps))
    # scalar calls are single-element views of the tensor path
    model = ChipModel(chip)
    t = surf.step_time(pa.expand(), fr)
    pw = surf.power_w(pa.expand(), fr)
    for i in (0, 3, 17):
        for j, f in enumerate(FREQS):
            assert model.step_time(pa.profile(i), f) == float(t[i, j])
            _close(model.power_w(pa.profile(i), f), float(pw[i, j]))


def ref_surface_profiles(arr):
    from repro.power.surface import ProfileArray as RefPA
    return RefPA.coerce(arr)


@pytest.mark.parametrize("chip", CHIP_NAMES)
@pytest.mark.parametrize("objective,budget,cap_frac", [
    ("energy", 0.0, None), ("energy", 0.1, None), ("edp", 0.25, None),
    ("ed2p", 0.25, 0.8), ("perf_per_watt", 0.05, 0.7),
    ("dt_bounded_savings", 0.15, None)])
def test_sweep_decisions_match_reference(chip, objective, budget, cap_frac):
    arr = _profiles(2)
    surf, ref = TransferSurface(chip, device="cpu"), RefSurface(chip)
    cap = None if cap_frac is None else cap_frac * surf.spec.tdp_w
    bd = surf.sweep_decisions(arr, slowdown_budget=budget, n_freqs=13,
                              power_cap_w=cap, objective=objective)
    rbd = ref.sweep_decisions(arr, slowdown_budget=budget, n_freqs=13,
                              power_cap_w=cap, objective=objective)
    assert isinstance(bd, BatchDecision) and bd.freq_mhz.dtype == torch.int64
    assert np.array_equal(bd.freq_mhz.numpy(), rbd.freq_mhz)
    assert np.array_equal(bd.freq_frac.numpy(), rbd.freq_frac)
    assert np.array_equal(bd.mode_idx.numpy(), rbd.mode_idx)
    assert np.array_equal(bd.time_s.numpy(), rbd.time_s)
    _close(bd.power_w, rbd.power_w)
    _close(bd.energy_j, rbd.energy_j)
    _close(bd.baseline_energy_j, rbd.baseline_energy_j)
    _close(bd.savings_pct, rbd.savings_pct, rtol=1e-9)
    # the batched sweep is a loop of scalar sweeps
    model, rmodel = ChipModel(chip), RefChipModel(chip)
    for i in range(8):
        d = sweep_decision(StepProfile(*arr[i]), model, budget, 13, cap,
                           objective)
        rd = ref_sweep_decision(RefStepProfile(*arr[i]), rmodel, budget, 13,
                                cap, objective)
        assert (d.freq_mhz, d.freq_frac, d.mode.idx, d.time_s) == \
            (rd.freq_mhz, rd.freq_frac, rd.mode.idx, rd.time_s)
        _close(d.energy_j, rd.energy_j)
        lifted = bd.decision(i)
        assert (lifted.freq_mhz, lifted.freq_frac, lifted.mode.idx) == \
            (d.freq_mhz, d.freq_frac, d.mode.idx)
        _close(lifted.energy_j, d.energy_j)


def test_golden_sweep_decisions():
    """The reference's golden sweeps: discrete picks equal, energies within
    the pow tolerance."""
    chip = ChipModel("mi250x-gcd")
    for (name, cap, i), want in GOLDEN_SWEEPS.items():
        d = sweep_decision(StepProfile(*GOLDEN_PROFILES[i]), chip,
                           slowdown_budget=0.15, n_freqs=13,
                           power_cap_w=cap, objective=name)
        assert (d.freq_mhz, d.freq_frac) == want[:2], (name, cap, i)
        _close(d.energy_j, want[2])


@pytest.mark.parametrize("chip", ("mi250x-gcd", "tpu-v5e"))
def test_golden_policy_decisions(chip):
    """The golden decisions of the policies whose engines this package has:
    nominal and static are ``decisions_at``, energy-aware is the sweep."""
    model = ChipModel(chip)
    surf = model.surface("cpu")
    seen = 0
    for (name, policy, knobs, i), want in GOLDEN_DECISIONS.items():
        if name != chip or policy == "power-cap":
            continue
        knobs = dict(knobs)
        prof = StepProfile(*GOLDEN_PROFILES[i])
        if policy == "nominal":
            d = surf.decisions_at([prof], 1.0).decision(0)
        elif policy == "static":
            d = surf.decisions_at(
                [prof], model.freq_frac(knobs["freq_mhz"])).decision(0)
        else:
            d = sweep_decision(prof, model, **knobs)
        assert (d.freq_mhz, d.freq_frac, d.time_s) == want[:3]
        _close((d.power_w, d.energy_j, d.baseline_energy_j), want[3:])
        seen += 1
    assert seen == 25


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_decision_grid_and_argbest_match_reference(chip):
    arr = _profiles(3, n=16)
    surf, ref = TransferSurface(chip, device="cpu"), RefSurface(chip)
    names = ("energy", "edp", "perf_per_watt")
    caps = (None, 0.75 * surf.spec.tdp_w)
    g = obj.decision_grid(surf, arr, objectives=names, power_caps=caps,
                          slowdown_budget=0.2, n_freqs=9)
    rg = ref_obj.decision_grid(ref, arr, objectives=names, power_caps=caps,
                               slowdown_budget=0.2, n_freqs=9)
    assert g.objectives == rg.objectives and g.power_caps == rg.power_caps
    assert np.array_equal(g.freq_mhz.numpy(), rg.freq_mhz)
    assert np.array_equal(g.freq_frac.numpy(), rg.freq_frac)
    _close(g.energy_j, rg.energy_j)
    _close(g.objective_value(), rg.objective_value())
    for m, c in itertools.product(range(len(names)), range(len(caps))):
        bd = surf.sweep_decisions(arr, slowdown_budget=0.2, n_freqs=9,
                                  power_cap_w=caps[c], objective=names[m])
        assert torch.equal(g.freq_frac[m, c], bd.freq_frac)
        assert torch.equal(g.energy_j[m, c], bd.energy_j)
    e = np.random.default_rng(5).uniform(1, 2, size=(6, 7))
    t = np.random.default_rng(6).uniform(1, 2, size=(6, 7))
    mask = t < 1.7
    for name in ("energy", "edp", "ed2p"):
        assert obj.grid_argbest(name, e, t, mask=mask, device="cpu") == \
            ref_obj.grid_argbest(name, e, t, mask=mask)
    assert obj.grid_argbest("perf_per_watt", e, t, e / t, device="cpu") == \
        ref_obj.grid_argbest("perf_per_watt", e, t, e / t)
    with pytest.raises(ValueError, match="admissible"):
        obj.grid_argbest("energy", e, t, mask=np.zeros_like(mask),
                         device="cpu")


def test_objective_registry_matches_reference():
    assert obj.SWEEP_OBJECTIVES == ref_obj.SWEEP_OBJECTIVES
    assert obj.check_objective("edp") == "edp"
    with pytest.raises(ValueError, match="unknown sweep objective"):
        obj.get_objective("nope", what="sweep objective")
    with pytest.raises(ValueError, match="pass power_w"):
        obj.get_objective("perf_per_watt").score(1.0, 1.0)
    sav = np.array([5.0, 8.0, -1.0])
    dt = np.array([0.1, 3.0, 0.4])
    for name in obj.SWEEP_OBJECTIVES:
        got = obj.get_objective(name).cap_score(torch.tensor(sav),
                                                torch.tensor(dt))
        want = ref_obj.get_objective(name).cap_score(sav, dt)
        assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_infer_profiles_and_decisions_at_match_reference(chip):
    surf, ref = TransferSurface(chip, device="cpu"), RefSurface(chip)
    rng = np.random.default_rng(9)
    p_w = rng.uniform(0.5 * surf.spec.idle_w, 1.05 * surf.spec.tdp_w, 200)
    f = rng.uniform(surf.chip.f_min_frac, 1.0, 200)
    dur = rng.uniform(0.5, 20.0, 200)
    for freq in (0.8, f):
        pa = surf.infer_profiles(p_w, freq, dur)
        rpa = ref.infer_profiles(p_w, freq, dur)
        # the compute weight carries f ** 2.4, so compute_s and (in the
        # compute modes) memory_s carry the pow tolerance
        np.testing.assert_allclose(pa.compute_s.numpy(), rpa.compute_s,
                                   rtol=RTOL, atol=1e-15)
        np.testing.assert_allclose(pa.memory_s.numpy(), rpa.memory_s,
                                   rtol=RTOL, atol=1e-15)
        assert np.array_equal(pa.collective_s.numpy(), rpa.collective_s)
        _close(surf.step_time(pa, freq), ref.step_time(rpa, freq))
    arr = _profiles(4)
    bd = surf.decisions_at(arr, 0.77)
    rbd = ref.decisions_at(arr, 0.77)
    assert np.array_equal(bd.freq_mhz.numpy(), rbd.freq_mhz)
    assert np.array_equal(bd.mode_idx.numpy(), rbd.mode_idx)
    _close(bd.energy_j, rbd.energy_j)
    again = BatchDecision.from_decisions(bd.decisions(), device="cpu")
    assert torch.equal(again.freq_mhz, bd.freq_mhz)
    assert torch.equal(again.energy_j, bd.energy_j)


@pytest.mark.parametrize("chip", CHIP_NAMES)
@pytest.mark.parametrize("kind", ("freq", "power"))
def test_response_table_matches_reference(chip, kind):
    """Family means are ``Tensor.mean`` here and numpy's pairwise mean
    there: rtol 1e-12, keys equal."""
    t = response_table(chip, kind=kind, device="cpu")
    r = ref_response_table(chip, kind=kind)
    assert (t.kind, t.source) == (r.kind, r.source)
    for col, rcol in ((t.vai, r.vai), (t.mb, r.mb)):
        assert list(col) == list(rcol)
        for k in col:
            _close(col[k], rcol[k])
    with pytest.raises(ValueError, match="collide"):
        response_table(chip, caps=[900.2, 900.4], device="cpu")


def test_profile_array_coercions():
    arr = _profiles(7, n=5)
    a = ProfileArray.coerce(arr, "cpu")
    b = ProfileArray.coerce([StepProfile(*row) for row in arr], "cpu")
    c = ProfileArray.coerce(a)
    assert torch.equal(a.compute_s, b.compute_s)
    assert c.compute_s.device.type == "cpu" and len(a) == 5
    assert a.expand().shape == (5, 1)
    assert a.profile(2) == StepProfile(*arr[2])
    with pytest.raises(ValueError, match="triples"):
        ProfileArray.coerce(np.zeros((4, 2)), "cpu")
