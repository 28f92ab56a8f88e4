#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the two CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the port's main
path once at full size through the entry points a user would call:

    VAI / membw kernels timed by the wall-clock harness
      -> tune -> calibrate -> "calibrated:<kernel>" response tables
      -> one day of Frontier-sized fleet telemetry decomposed on the card
      -> fleet projection (paper Table V and the 8.5 % / 1438 MWh headline)

Run it with no arguments from the root of the checkout:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; without a card it prints a reason to
stderr and exits 2. Every phase prints one JSON line; any failed check
raises and the run exits non-zero. The last line of a good run is
``{"ok": true, "device": {...}}``.

``--rehearse-cpu`` walks the same phases at toy sizes on CPU tensors (the
kernels' plain versions) to check shapes and control flow where there is no
card. It measures nothing, never prints the ok line, and exits 3.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM datasheet
FP32_FMA_FLOPS = 66.9e12       # 132 SMs x 128 lanes x 2 x 1.98 GHz
FP32_ADD_OPS = FP32_FMA_FLOPS / 2
L2_BYTES = 50e6

VAI_CHECK_LOOPSIZES = (0, 1, 8, 64, 1024)
VAI_TOL = 2e-4                 # FMA rounds once, mul-then-add twice
MEMBW_RTOL, MEMBW_ATOL = 1e-5, 1e-4     # the order of the sum differs
MEMBW_TOL_SHAPES = ((4, 64, 9), (8, 32, 16), (2, 256, 5))


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Timer:
    """Median milliseconds of ``fn`` on the device (CUDA events around each
    of ``reps`` runs after a warm-up, one synchronise at the end); on the
    CPU rehearsal the host clock, which measures nothing worth keeping."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, fn, reps: int = 5) -> float:
        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


def clocks_under_load(fn, launches: int = 8) -> str:
    """The card's SM clock and power draw, read while ``launches`` runs of
    ``fn`` are queued on it."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    torch.cuda.synchronize()
    check(out.returncode == 0, f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 3
def vai_bound_ms(n_elems: int, loopsize: int):
    from repro_torch.kernels import vai_flops_bytes
    flops, byts = vai_flops_bytes(n_elems, loopsize)
    by_bytes = byts / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FMA_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), flops, byts


def check_vai(device, n_elems: int, timer: Timer, time_loopsizes) -> dict:
    """The vai kernel against its plain version at the main path's shape."""
    from repro_torch.kernels import vai as vai_mod
    rows = n_elems // 128
    g = torch.Generator(device=device)
    g.manual_seed(11)
    ints = [torch.randint(0, 5, (rows, 128), generator=g, device=device,
                          dtype=torch.float32) for _ in range(3)]
    normal = [torch.randn((rows, 128), generator=g, device=device,
                          dtype=torch.float32) for _ in range(3)]
    worst = 0.0
    for L in VAI_CHECK_LOOPSIZES:
        got = vai_mod.vai(*ints, loopsize=L)
        want = vai_mod.vai_plain(*ints, loopsize=L)
        check(torch.equal(got, want),
              f"vai(loopsize={L}) differs from its plain version on "
              f"integer inputs")
        a, b, c = normal
        got = vai_mod.vai(a, b, c, loopsize=L)
        closed = b if L == 0 else c + float(L) * (a * b)
        check(torch.allclose(got, closed, rtol=VAI_TOL, atol=VAI_TOL),
              f"vai(loopsize={L}) outside rtol=atol={VAI_TOL} of "
              f"c + loopsize*a*b on normal inputs")
        plain = vai_mod.vai_plain(a, b, c, loopsize=L)
        worst = max(worst, float((got - plain).abs().max()))
        del got, want, closed, plain
    a, b, c = normal
    cases = []
    for L in time_loopsizes:
        bound, by, flops, byts = vai_bound_ms(n_elems, L)
        ms = timer(lambda: vai_mod.vai(a, b, c, loopsize=L))
        plain_ms = timer(lambda: vai_mod.vai_plain(a, b, c, loopsize=L),
                         reps=3) if L <= 64 else None
        lib_ms = timer((lambda: b.clone()) if L == 0 else
                       (lambda: torch.addcmul(c, a, b, value=float(L))))
        cases.append({
            "loopsize": L, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "gbytes_s": byts / ms / 1e6, "tflops": flops / ms / 1e9})
    main = next(c for c in cases if c["loopsize"] == 8)
    # where the kernel is bound by operations: is the clock what holds it?
    heavy = max(time_loopsizes)
    under_load = clocks_under_load(
        lambda: vai_mod.vai(a, b, c, loopsize=heavy)) \
        if device.type == "cuda" else None
    return {
        "name": "vai", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vai.cu",
        "replaces": "src/repro/kernels/vai.py:42",
        "shape": f"a,b,c [{rows},128] f32, loopsize 8, block_rows 256",
        "max_abs_err": worst, "exact_on_integer_inputs": True,
        "tolerance": f"rtol=atol={VAI_TOL} vs c+loopsize*a*b "
                     f"(loopsizes {list(VAI_CHECK_LOOPSIZES)})",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.addcmul(c, a, b, value=loopsize); b.clone() at 0",
        "clocks_under_load": {"loopsize": heavy, "sm_clock_power": under_load},
        "cases": cases}


def check_membw(device, small_rows: int, big_rows: int, n_iters: int,
                timer: Timer) -> dict:
    """The membw kernel against its plain version on both sides of the L2
    boundary."""
    from repro_torch.kernels import membw as mb
    g = torch.Generator(device=device)
    g.manual_seed(12)
    # the tolerance on normal inputs is stated for the shapes of the
    # reference's own kernel test; beyond them only the error is reported
    worst = 0.0
    for n_chunks, chunk_rows, iters in MEMBW_TOL_SHAPES:
        x = torch.randn((n_chunks * chunk_rows, 128), generator=g,
                        device=device, dtype=torch.float32)
        got = mb.membw(x, n_chunks=n_chunks, n_iters=iters)
        want = mb.membw_plain(x, n_chunks=n_chunks, n_iters=iters)
        check(torch.allclose(got, want, rtol=MEMBW_RTOL, atol=MEMBW_ATOL),
              f"membw{(n_chunks, chunk_rows, iters)} outside rtol "
              f"{MEMBW_RTOL} atol {MEMBW_ATOL} on normal inputs")
        worst = max(worst, float((got - want).abs().max()))
    cases = []
    for rows in (small_rows, big_rows):
        x = torch.randint(0, 4, (rows, 128), generator=g, device=device,
                          dtype=torch.float32)
        working_set = rows * 512
        for n_chunks in (1, 4, 32):
            got = mb.membw(x, n_chunks=n_chunks, n_iters=n_iters)
            want = mb.membw_plain(x, n_chunks=n_chunks, n_iters=n_iters)
            check(torch.equal(got, want),
                  f"membw(rows={rows}, n_chunks={n_chunks}) differs from "
                  f"its plain version on integer inputs")
            chunk_rows = rows // n_chunks
            read = mb.membw_bytes(chunk_rows * 512, n_iters)
            ms = timer(lambda: mb.membw(x, n_chunks=n_chunks,
                                        n_iters=n_iters))
            plain_ms = timer(lambda: mb.membw_plain(
                x, n_chunks=n_chunks, n_iters=n_iters))
            lib_ms = timer(lambda: x.view(n_chunks, chunk_rows, 128).sum(1))
            in_l2 = working_set <= L2_BYTES
            cases.append({
                "working_set_bytes": working_set, "n_chunks": n_chunks,
                "n_iters": n_iters, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                "bound_ms": None if in_l2 else
                (read + n_iters * 512) / HBM_BYTES_PER_S * 1e3,
                "bound": "HBM bound n/a (L2-resident)" if in_l2 else
                "chunk_bytes * n_iters over the HBM rate",
                "gbytes_s": read / ms / 1e6})
        del x
    main = next(c for c in cases
                if c["working_set_bytes"] == big_rows * 512
                and c["n_chunks"] == 1)
    return {
        "name": "membw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/membw.cu",
        "replaces": "src/repro/kernels/membw.py:24",
        "shape": f"x [{big_rows},128] f32, n_chunks 1, n_iters {n_iters}",
        "max_abs_err": worst, "exact_on_integer_inputs": True,
        "tolerance": f"rtol {MEMBW_RTOL} atol {MEMBW_ATOL} on normal inputs "
                     f"at (n_chunks, chunk_rows, n_iters) in "
                     f"{list(MEMBW_TOL_SHAPES)}",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bound_note": "the probe's work is n_iters reads of the chunk, so "
                      "the bound counts every one of them; reading x once "
                      "would take "
                      f"{big_rows * 512 / HBM_BYTES_PER_S * 1e3:.4f} ms",
        "library_ms": main["library_ms"],
        "library": "x.view(n_chunks, chunk_rows, 128).sum(1) (the chunk "
                   "sums once, not n_iters times)",
        "cases": cases}


# --------------------------------------------------------------- phase 4
def main_path(device, sizes: dict) -> dict:
    """The port's main path, through its public entry points."""
    import repro_torch.core.hardware as hw
    from repro_torch.configs.paper_vai import VAISuiteConfig
    from repro_torch.core import modal, projection
    from repro_torch.core.vai import _loopsize_for, response_table, run_sweep
    from repro_torch.tuning import (MembwSpace, PerfParams, VaiSpace,
                                    WallClockBackend, calibrate,
                                    calibrated_tables, register_calibration,
                                    tune)
    chip = hw.H100_SXM
    report = {}
    t_start = time.perf_counter()

    # -- the two benchmarks through the wall-clock harness ----------------
    cfg = VAISuiteConfig(elements=sizes["vai_elems"])
    loopsizes = [_loopsize_for(ai) for ai in cfg.intensities]
    # the measured time already holds every overhead, so the profile that is
    # anchored to it takes its shape from the bare roofline
    backend = WallClockBackend(chip, perf=PerfParams.ideal(), repeats=3,
                               device=device)
    vspace = VaiSpace(n_elems=cfg.elements, loopsizes=loopsizes, chip=chip,
                      device=device)
    result = tune(vspace, backend=backend, validate=True)
    vmeas = result.measurement
    check(all(e == 0.0 for e in vmeas.validation_err),
          "a vai candidate is not bit-for-bit equal to kernels.ref")
    check(bool(torch.isfinite(vmeas.time_s).all())
          and bool((vmeas.time_s > 0).all()), "vai times not finite")
    fast, green = result.best("time"), result.best("energy")
    report["vai"] = {
        "n_elems": cfg.elements, "loopsizes": loopsizes,
        "candidates": len(vmeas.candidates),
        "wall_ms": {c.label: w * 1e3
                    for c, w in zip(vmeas.candidates, backend.wall_s)},
        "best_time": repr(fast), "best_energy": repr(green)}
    check(green.energy_j <= fast.energy_j, "energy pick costs more energy")
    vspace.release()

    report["membw"] = {}
    mmeas = {}
    for tag, rows in (("l2", sizes["membw_small_rows"]),
                      ("hbm", sizes["membw_big_rows"])):
        mspace = MembwSpace(total_rows=rows, n_iters=sizes["membw_iters"],
                            chip=chip, device=device)
        m = backend.measure(mspace, validate=True)
        check(all(e == 0.0 for e in m.validation_err),
              f"a membw[{tag}] candidate is not bit-for-bit equal to "
              f"kernels.ref")
        mmeas[tag] = m
        report["membw"][tag] = {
            "working_set_bytes": rows * 512,
            "wall_ms": {c.label: w * 1e3
                        for c, w in zip(m.candidates, backend.wall_s)},
            "gbytes_s": {c.label: (rows // c.get("n_chunks")) * 512
                         * sizes["membw_iters"] / w / 1e9
                         for c, w in zip(m.candidates, backend.wall_s)}}
        mspace.release()

    # -- the paper's sweep, its Table III format --------------------------
    points = run_sweep(cfg, chip=chip, execute_kernel=True, device=device)
    check(len(points) == len(cfg.intensities) * 13, "sweep lost points")
    by_freq = response_table(points, "freq")
    by_power = response_table(points, "power")
    check(abs(by_freq[max(by_freq)]["runtime_pct"] - 100.0) < 1e-9,
          "uncapped sweep column is not 100 %")
    report["sweep"] = {"points": len(points),
                       "freq": {str(k): v for k, v in by_freq.items()},
                       "power": {str(k): v for k, v in by_power.items()}}

    # -- calibrate: measured grids become response tables -----------------
    cal = register_calibration(calibrate(vmeas, kind="freq"))
    check(calibrated_tables("vai", device=device) is cal.tables,
          "registered calibration not served")
    cal_power = calibrate(vmeas, kind="power")
    cal_mb = register_calibration(calibrate(mmeas["hbm"], kind="freq"))
    report["calibration"] = {
        "vai_fit_rms_pct": cal.fit_rms_pct,
        "membw_fit_rms_pct": cal_mb.fit_rms_pct,
        "vai_tables": {str(k): v for k, v in cal.tables.vai.items()},
        "mb_tables": {str(k): v for k, v in cal.tables.mb.items()},
        "power_caps": sorted(cal_power.tables.vai)}

    # -- one day of the fleet on the device --------------------------------
    n_rows, n_cols = sizes["fleet_rows"], sizes["fleet_samples"]
    t0 = time.perf_counter()
    powers = modal.synth_fleet_powers(n_rows * n_cols, seed=0,
                                      device=device).reshape(n_rows, n_cols)
    check(powers.shape == (n_rows, n_cols) and powers.dtype == torch.float64
          and powers.device.type == device.type, "fleet matrix misplaced")
    bd = modal.decompose_batch(powers, sample_interval_s=15.0)
    agg = bd.aggregate()
    if device.type == "cuda":
        torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    for m in hw.MODES:
        check(abs(agg.hours_pct[m.idx] - m.gpu_hours_pct) < 0.5,
              f"mode {m.idx} hours {agg.hours_pct[m.idx]:.3f} % is not "
              f"within 0.5 of Table IV's {m.gpu_hours_pct}")
    # the same rows decomposed on the host must give the same numbers
    head = min(n_rows, 64)
    host = modal.decompose_batch(powers[:head].cpu(), sample_interval_s=15.0)
    card_vs_host = max(
        float((bd.energy_mwh[:head].cpu() - host.energy_mwh).abs().max()),
        float((bd.total_energy_mwh[:head].cpu()
               - host.total_energy_mwh).abs().max()),
        float((bd.hours_pct[:head].cpu() - host.hours_pct).abs().max()))
    check(card_vs_host <= 1e-12 * float(host.total_energy_mwh.max()),
          f"decompose_batch on the card differs from the host by "
          f"{card_vs_host}")
    centers, hist = modal.power_histogram(powers)
    peaks = modal.detect_peaks(centers, hist)

    caps = sorted(hw.PAPER_TABLE_V_FREQ, reverse=True)
    rows = projection.project_from_decomposition(agg, caps, device=device)
    per_row = projection.project_batch(
        caps, e_ci_mwh=bd.energy_mwh[:, 2], e_mi_mwh=bd.energy_mwh[:, 1],
        e_total_mwh=bd.total_energy_mwh,
        dt_weight=projection.DT_WEIGHT_PER_CI_HOUR * bd.hours_frac(3))
    check(per_row.savings_pct.shape == (n_rows, len(caps))
          and bool(torch.isfinite(per_row.savings_pct).all()),
          "per-row projection not finite")
    h100_caps = sorted(cal.tables.vai, reverse=True)
    rows_h100 = projection.project_from_decomposition(
        agg, h100_caps, tables=calibrated_tables("vai", device=device),
        device=device)
    check(all(abs(r.savings_pct) < 100.0 for r in rows + rows_h100),
          "fleet projection out of range")
    report["fleet"] = {
        "shape": [n_rows, n_cols], "bytes": powers.numel() * 8,
        "seconds_synth_decompose": fleet_s,
        "hours_pct": agg.hours_pct, "energy_mwh": agg.energy_mwh,
        "total_energy_mwh": agg.total_energy_mwh,
        "card_vs_host_max_abs": card_vs_host, "histogram_peaks_w": peaks,
        "mi250x_table_iii": [r.to_dict() for r in rows],
        "calibrated_h100": [r.to_dict() for r in rows_h100]}
    del powers, bd, per_row

    # -- Table V and the headline ------------------------------------------
    errs = {}
    for kind, bounds in projection.TABLE_V_BOUNDS.items():
        errs[kind] = projection.validate_against_paper(kind, device=device)
        for key, bound in bounds.items():
            check(errs[kind][key] < bound,
                  f"Table V[{kind}] {key} error {errs[kind][key]:.3f} "
                  f">= {bound}")
    head_row = projection.project([900], "freq", device=device)[0]
    for name, want, tol in projection.HEADLINE_900MHZ:
        got = getattr(head_row, name)
        check(abs(got - want) < tol,
              f"headline {name} = {got:.3f}, paper {want} +- {tol}")
    check(projection.validate_main(device=device) == 0,
          "validate_main failed")
    report["table_v_max_abs_err"] = errs
    report["headline_900mhz"] = head_row.to_dict()
    report["seconds"] = time.perf_counter() - t_start
    return report


FULL = dict(vai_elems=2 ** 28, membw_small_rows=65536,       # 32 MiB
            membw_big_rows=2 ** 21, membw_iters=64,          # 1 GiB
            fleet_rows=9408 * 8, fleet_samples=5760)
TOY = dict(vai_elems=2 ** 16, membw_small_rows=256, membw_big_rows=2048,
           membw_iters=8, fleet_rows=64, fleet_samples=300)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="toy sizes on CPU tensors; measures nothing, "
                         "exits 3")
    args = ap.parse_args()
    if args.rehearse_cpu:
        device, sizes = torch.device("cpu"), TOY
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device: the port's main path runs "
                  "on the card and does not fall back to the CPU",
                  file=sys.stderr)
            return 2
        device, sizes = torch.device("cuda", 0), FULL

    from repro_torch.kernels import build, ops

    smi = None
    if device.type == "cuda":
        smi = nvidia_smi_line()
        emit(phase="device", nvidia_smi=smi,
             kind=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda, python=sys.version.split()[0])
        t0 = time.perf_counter()
        build.load_library()
        ffma = None
        try:
            text = build.sass("vai_fma_kernel")
            ffma = text.count("FFMA")
            (build.build_dir() / "vai_fma_kernel.sass").write_text(text)
        except (OSError, subprocess.CalledProcessError) as exc:
            print(f"chip_smoke: cuobjdump not usable: {exc}", file=sys.stderr)
        print(build.build_log(), file=sys.stderr)
        emit(phase="build", setup_seconds=time.perf_counter() - t0,
             nvcc_seconds=build.build_seconds,
             library=os.path.relpath(build.library_path(), HERE),
             vai_fma_kernel_ffma_in_sass=ffma)

    timer = Timer(device)
    kernels = [
        check_vai(device, sizes["vai_elems"], timer,
                  time_loopsizes=(0, 8, 1024, 8192)
                  if device.type == "cuda" else (0, 8)),
        check_membw(device, sizes["membw_small_rows"],
                    sizes["membw_big_rows"], sizes["membw_iters"], timer)]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ops.reset_launch_counts()
    report = main_path(device, sizes)
    counts = ops.launch_counts()
    emit(phase="main_path", **report)
    emit(phase="launches", **counts)
    for k in kernels:
        k["launches"] = counts[k["name"]]

    if device.type != "cuda":
        emit(ok=False, rehearsal=True, note="CPU rehearsal: nothing measured")
        return 3
    for name, n in counts.items():
        check(n > 0, f"the main path never launched the {name} kernel")
    torch.cuda.synchronize()
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
