"""The ``repro_torch.power`` public surface against the reference's: the
fleet and session cases of ``tests/test_power_api.py`` (the chained
``FleetAnalysis`` pipeline, ``EnergySession.fleet()``), the package's
``__all__``, and ``validate_main`` with its three legs — each fed the same
numpy inputs in both packages, on CPU float64 tensors.

Stated tolerances: decompositions of equal inputs are equal bit for bit,
and so is the projection from the measured MI250X tables
(``tests/test_torch_modal_projection.py``); what passes through the chip
model's ``f ** 2.4`` (session powers, model-derived tables) agrees to rtol
1e-12. ``validate_main``'s bootstrap interval equals the reference's to
rtol 1e-10.
"""
import inspect
import math
import re

import numpy as np
import pytest

import repro.core.projection as ref_projection
import repro.power as rp
from repro.core.modal import synth_fleet_powers
from repro.core.telemetry import StepSample as RefStepSample
from repro.core.telemetry import TelemetryStore as RefTelemetryStore
from repro_torch.core import projection
from repro_torch.core.modal import decompose
from repro_torch.core.projection import project_from_decomposition
from repro_torch.core.telemetry import StepSample, TelemetryStore
from repro_torch.power import (EnergySession, FleetAnalysis, StepProfile,
                               Study, TPU_V5E, Workload,
                               validate_against_paper)

CPU = "cpu"
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


# --------------------------------------------------------- fleet pipeline
def test_fleet_analysis_matches_hand_wired_pipeline():
    powers = synth_fleet_powers(100_000, seed=4)
    expect = project_from_decomposition(decompose(powers, 15.0, device=CPU),
                                        [900, 700], "freq", device=CPU)
    rows = FleetAnalysis.from_powers(powers, device=CPU).decompose() \
        .project([900, 700])
    assert [r.to_dict() for r in rows] == [r.to_dict() for r in expect]
    want = rp.FleetAnalysis.from_powers(powers).decompose().project([900,
                                                                     700])
    assert [r.to_dict() for r in rows] == [r.to_dict() for r in want]


def _session_pair():
    sess = EnergySession(policy="energy-aware", chip=TPU_V5E, device=CPU)
    ref = rp.EnergySession(policy="energy-aware", chip=rp.TPU_V5E)
    for step in range(50):
        sess.observe(step, StepProfile(compute_s=0.2, memory_s=1.0))
        ref.observe(step, rp.StepProfile(compute_s=0.2, memory_s=1.0))
    return sess, ref


def test_session_fleet_uses_session_chip():
    """sess.fleet() classifies telemetry against the session's own chip
    envelope, on the session's device; the raw from_store default (MI250X
    bands) files TPU-v5e decode power into mode 1."""
    sess, ref = _session_pair()
    fleet = sess.fleet()
    assert fleet.chip is TPU_V5E
    assert fleet.device.type == "cpu"
    d = fleet.decompose().decomposition
    assert d.hours_pct[2] == pytest.approx(100.0)    # memory-intensive
    row = fleet.project([900])[0]
    assert row.savings_pct > 0
    wrong = FleetAnalysis.from_store(sess.telemetry, device=CPU).decompose()
    assert wrong.decomposition.hours_pct[1] == pytest.approx(100.0)
    rfleet = ref.fleet()
    rd = rfleet.decompose().decomposition
    assert d.hours_pct == rd.hours_pct
    _close(list(d.energy_mwh.values()), list(rd.energy_mwh.values()))
    rrow = rfleet.project([900])[0]
    for k, v in rrow.to_dict().items():
        if isinstance(v, float):
            _close(row.to_dict()[k], v)
        else:
            assert row.to_dict()[k] == v


def test_fleet_analysis_from_store():
    stores = []
    for store_cls, sample_cls in ((TelemetryStore, StepSample),
                                  (RefTelemetryStore, RefStepSample)):
        ts = store_cls(window_s=15.0)
        for i in range(200):
            ts.record(sample_cls(step=i, t=i * 1.0, duration_s=1.0,
                                 power_w=300.0, energy_j=300.0, mode=2,
                                 freq_mhz=1700))
        stores.append(ts)
    fleet = FleetAnalysis.from_store(stores[0], device=CPU)
    assert fleet.sample_interval_s == stores[0].window_s
    assert fleet.jobs is None
    d = fleet.decompose().decomposition
    assert d.hours_pct[2] == pytest.approx(100.0)
    assert d.total_energy_mwh > 0
    rd = rp.FleetAnalysis.from_store(stores[1]).decompose().decomposition
    assert (d.hours_pct, d.energy_mwh, d.total_energy_mwh) == \
        (rd.hours_pct, rd.energy_mwh, rd.total_energy_mwh)


def test_fleet_analysis_end_to_end_vs_paper_validation():
    """The chained pipeline rides on the engine that reproduces Table V;
    the port's synthetic fleet (a torch.Generator draw) projects the same
    band, and on the reference's samples the summary is the reference's."""
    errs = validate_against_paper("freq", device=CPU)
    assert errs["sav"] < 0.15 and errs["sav0"] < 0.15
    fleet = FleetAnalysis.synthetic(300_000, seed=0, device=CPU).decompose()
    rows = fleet.project([900], "freq")
    assert 4.0 < rows[0].savings_pct < 15.0
    assert len(fleet.peaks()) >= 2
    assert set(fleet.summary()["hours_pct"]) == {1, 2, 3, 4}
    powers = synth_fleet_powers(300_000, seed=0)
    s = FleetAnalysis.from_powers(powers, device=CPU).summary()
    r = rp.FleetAnalysis.from_powers(powers).summary()
    assert s.keys() == r.keys()
    assert (s["chip"], s["samples"], s["hours_pct"],
            s["total_energy_mwh"]) == (r["chip"], r["samples"],
                                       r["hours_pct"], r["total_energy_mwh"])
    _close(list(s["energy_pct"].values()), list(r["energy_pct"].values()))
    _close(s["peaks_w"], r["peaks_w"])


def test_fleet_analysis_domain_targeting():
    """Domain-targeted capping (Table VI): one Study over per-domain
    energy workloads."""
    fleet = FleetAnalysis.from_powers(synth_fleet_powers(100_000, seed=1),
                                      device=CPU).decompose()
    e_ci = fleet.decomposition.energy_mwh[3]
    e_mi = fleet.decomposition.energy_mwh[2]
    e_total = fleet.decomposition.total_energy_mwh
    out = Study(workloads=[Workload.from_energies(e_ci / 2, e_mi / 2,
                                                  e_total, name="chm",
                                                  device=CPU)],
                caps=[900.0]).run()
    full = fleet.project([900])[0].total_mwh
    assert out[0].savings_mwh == pytest.approx(full / 2, rel=1e-9)
    ref = rp.Study(workloads=[rp.Workload.from_energies(
        e_ci / 2, e_mi / 2, e_total, name="chm")], caps=[900.0]).run()
    assert out[0].detail.to_dict() == ref[0].detail.to_dict()


def test_fleet_histogram_and_peaks_match_reference():
    powers = synth_fleet_powers(20_000, seed=3)
    fa = FleetAnalysis.from_powers(powers, device=CPU)
    ra = rp.FleetAnalysis.from_powers(powers)
    for bins, max_w in ((None, None), (60, 700.0)):
        c, h = fa.histogram(bins=bins, max_w=max_w)
        rc, rh = ra.histogram(bins=bins, max_w=max_w)
        _close(c.numpy(), rc)
        _close(h.numpy(), rh, rtol=1e-9)
    assert fa.peaks() == pytest.approx(ra.peaks(), rel=RTOL)


# ------------------------------------------------------- the public surface
def test_public_surface_matches_all():
    """``repro_torch.power.__all__`` is exactly what the package exports,
    and holds every name of the reference's ``__all__`` except those whose
    modules are still to port (listed in tests/test_torch_imports.py)."""
    import repro_torch.power as tp
    from test_torch_imports import STILL_MISSING
    exported = {n for n in vars(tp)
                if not n.startswith("_")
                and not inspect.ismodule(getattr(tp, n))}
    assert exported == set(tp.__all__)
    for name in tp.__all__:
        assert getattr(tp, name) is not None
    missing = set(rp.__all__) - set(tp.__all__)
    assert missing == set(STILL_MISSING["repro.power"])


def test_module_map_lists_every_power_module():
    """The package docstring's module map names every submodule of
    ``repro_torch.power``."""
    import pkgutil

    import repro_torch.power as tp
    mapped = set(re.findall(r"^(\w+)\s+—", tp.__doc__, flags=re.MULTILINE))
    actual = {name for _, name, _ in pkgutil.iter_modules(tp.__path__)}
    assert mapped == actual


# ---------------------------------------------------------- validate_main
def test_validate_main_runs_all_three_legs(capsys):
    """``validate_main(device="cpu")`` returns 0, prints Table V, the
    headline and the bootstrap interval — the reference's [7.882, 9.064]
    around 8.484 over 1500 jobs, equal to rtol 1e-10."""
    assert projection.validate_main(device=CPU) == 0
    out = capsys.readouterr().out
    assert ref_projection.validate_main() == 0
    ref_out = capsys.readouterr().out
    line = [l for l in out.splitlines() if "bootstrap 95% CI" in l]
    assert line == [l for l in ref_out.splitlines()
                    if "bootstrap 95% CI" in l]
    assert line == ["headline bootstrap 95% CI [7.88, 9.06] (point 8.48, "
                    "n=1500 jobs)  brackets 8.5  ok"]
    assert out.count("  ok") == ref_out.count("  ok") == 13
    assert "LEFT OUT" not in out
    ci = projection.headline_bootstrap_ci(device=CPU)
    for got, want in ((ci.lo, 7.882424999032451),
                      (ci.hi, 9.063787830984879),
                      (ci.value, 8.484124251644447)):
        assert math.isclose(got, want, rel_tol=1e-10)
