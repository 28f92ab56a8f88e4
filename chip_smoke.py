#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the four CUDA kernels from the sources in this checkout (vai, membw,
and flash attention in f32 and in bf16), holds each against its plain
PyTorch version on the card, tunes the f32 flash-attention tiles and runs
the model's f32 prefill route through the f32 kernel, then drives the
port's two paths once at full size through the entry points a user would
call:

    the paper's pipeline: VAI / membw kernels timed by the wall-clock
      harness -> tune -> calibrate -> "calibrated:<kernel>" response tables
      -> one day of Frontier-sized fleet telemetry decomposed on the card
      -> fleet projection (paper Table V and the 8.5 % / 1438 MWh headline)
    the serving path: qwen2.5-14b at full width and depth in bf16 (random
      weights from a seeded generator) -> ServeEngine.generate on 4 greedy
      requests -> serve() on 8 Poisson-arriving requests through a slot pool
      metered by an energy-aware EnergySession -> ServeEngine.generate on 4
      sampled requests (the lock-step route, one prefill at a 1000-token
      prompt); prefill attention runs the flash kernel, and the same prompt
      served through the plain attention route must give the same greedy
      tokens wherever the logits' top-2 margin exceeds the difference
      between the two routes

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
import re
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
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core peak
TF32_TENSOR_FLOPS = 495e12     # dense TF32 tensor-core peak
L2_BYTES = 50e6

VAI_CHECK_LOOPSIZES = (0, 1, 8, 64, 1024)
VAI_TOL = 2e-4                 # FMA rounds once, mul-then-add twice
#: loopsizes at which the vai kernel is timed, each in turns with the
#: library call for VAI_ROUNDS rounds: the copy, the main case, and the
#: operations-bound end
VAI_TIME_LOOPSIZES = (0, 8, 256, 1024, 8192)
VAI_ROUNDS = 3
#: the vai FMA kernel's instantiations (threads x float4s a thread): the
#: bytes end and the operations end
VAI_SHAPES = ("1024x4", "512x2")
MEMBW_RTOL, MEMBW_ATOL = 1e-5, 1e-4     # the order of the sum differs
MEMBW_TOL_SHAPES = ((4, 64, 9), (8, 32, 16), (2, 256, 5))
#: (atol, rtol) of a flash kernel against its plain version, which rounds
#: p to bf16 for p.v as the kernels do: f32 differs in the order of its
#: sums; bf16 also by one bf16 step of the output (at most 2**-7 of it)
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-3, 1e-2)}
#: about 25 ms at the card's clock: time for the host to queue a timed run
QUEUE_SLEEP_CYCLES = 50_000_000
SERVE_ARCH = "qwen2.5-14b"     # the reference serve CLI's default --arch
SAMPLED_TEMPERATURE = 0.7


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Timer:
    """Median milliseconds of ``fn`` on the device (CUDA events around each
    of ``reps`` runs after a warm-up, one synchronise at the end); on the
    CPU rehearsal the host clock, which measures nothing worth keeping.

    ``queued=True`` first parks the device on a sleep kernel long enough for
    the host to enqueue every run behind it, so that a kernel shorter than
    its wrapper's host work is timed alone, not with the idle gap before
    it."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, fn, reps: int = 5, queued: bool = False) -> float:
        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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
def vai_sass_banks(build) -> dict:
    """``build.ffma_bank_counts`` of each instantiation of the vai FMA
    kernel, keyed by its shape (threads x float4s a thread)."""
    shapes = {}
    for chunk in build.sass("vai_fma_kernel").split("Function : ")[1:]:
        m = re.search(r"vai_fma_kernelILi(\d+)ELi(\d+)E", chunk)
        shapes[f"{m.group(1)}x{m.group(2)}" if m else "?"] = (
            build.ffma_bank_counts(chunk))
    return shapes


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
        sides = {"kernel": lambda: vai_mod.vai(a, b, c, loopsize=L),
                 "library": (lambda: b.clone()) if L == 0 else
                 (lambda: torch.addcmul(c, a, b, value=float(L)))}
        turns = {"kernel": [], "library": []}
        for r in range(VAI_ROUNDS):
            for side in (("kernel", "library") if r % 2 == 0
                         else ("library", "kernel")):
                turns[side].append(timer(sides[side]))
        ms = statistics.median(turns["kernel"])
        plain_ms = timer(lambda: vai_mod.vai_plain(a, b, c, loopsize=L),
                         reps=3) if L <= 64 else None
        cases.append({
            "loopsize": L, "ms": ms,
            "ms_min_max": [min(turns["kernel"]), max(turns["kernel"])],
            "plain_ms": plain_ms,
            "library_ms": statistics.median(turns["library"]),
            "library_ms_min_max": [min(turns["library"]),
                                   max(turns["library"])],
            "bound_ms": bound, "bound_by": by,
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
        "timing": f"median of {VAI_ROUNDS} rounds in turns with the library "
                  f"call (each round the median of 5 launches)",
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
            xv = x.view(n_chunks, chunk_rows, 128)
            lib_ms = timer(lambda: [xv[i % n_chunks].sum(0)
                                    for i in range(n_iters)])
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
        "library": "x.view(n_chunks, chunk_rows, 128)[i % n_chunks].sum(0) "
                   "for i < n_iters: the probe's n_iters chunk reads, one "
                   "torch.sum each",
        "cases": cases}


def vai_main_path_loss(wall_ms: dict, launches_by_shape: dict,
                       n_elems: int) -> dict:
    """What the vai launches of the main path cost beyond their bound, by
    loopsize: ``launches_by_shape`` maps ``(loopsize, block_rows)`` to the
    wrapper's launch count, ``wall_ms`` the harness's label
    ``"block_rows=B,loopsize=L"`` to its measured milliseconds."""
    by_l = {}
    for (L, br), n in sorted(launches_by_shape.items()):
        ms = wall_ms[f"block_rows={br},loopsize={L}"]
        bound = vai_bound_ms(n_elems, L)[0]
        row = by_l.setdefault(str(L), {"launches": 0, "ms_total": 0.0,
                                       "loss_ms": 0.0})
        row["launches"] += n
        row["ms_total"] += n * ms
        row["loss_ms"] += n * (ms - bound)
    return {"by_loopsize": by_l,
            "launches": sum(r["launches"] for r in by_l.values()),
            "seconds": sum(r["ms_total"] for r in by_l.values()) / 1e3,
            "loss_seconds": sum(r["loss_ms"] for r in by_l.values()) / 1e3}


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


# ------------------------------------------------------- flash attention
def attention_entries(Sq: int, Skv: int, causal: bool) -> int:
    """Score entries one (batch, head) of attention needs: every (q, kv)
    pair, or under the top-left causal mask the keys 0..qpos of each query
    row, sum of min(qpos + 1, Skv)."""
    if not causal:
        return Sq * Skv
    if Sq <= Skv:
        return Sq * (Sq + 1) // 2
    return Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, itemsize, causal):
    """Least time for one call: bytes (q, k, v read once, o written once)
    over the HBM rate against the flops the function needs (2 D for q.k and
    2 D for p.v per unmasked score entry) over the rate of the tensor-core
    products the kernel does them with: bf16 at the bf16 peak; f32 as
    3xTF32, three TF32 products for each f32 one, at the TF32 peak."""
    flops = 2.0 * B * Hq * attention_entries(Sq, Skv, causal) * (2 * D)
    byts = itemsize * D * (2 * B * Sq * Hq + 2 * B * Skv * Hkv)
    by_bytes = byts / HBM_BYTES_PER_S * 1e3
    by_ops = (3 * flops / TF32_TENSOR_FLOPS if itemsize == 4 else
              flops / BF16_TENSOR_FLOPS) * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", flops, byts)


def ptxas_facts(log: str, kernel: str) -> dict:
    """Registers and spill bytes ``ptxas -v`` gave each instantiation of
    ``kernel`` (a template over head dim, block_q and block_k), keyed
    ``D<d>_<block_q>x<block_k>``."""
    import re
    facts, name = {}, None
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            name = f"D{m[1]}_{m[2]}x{m[3]}" if m else None
            if name:
                facts[name] = {}
        elif name and "spill stores" in line:
            st = re.search(r"(\d+) bytes spill stores", line)
            ld = re.search(r"(\d+) bytes spill loads", line)
            facts[name].update(spill_stores=int(st[1]), spill_loads=int(ld[1]))
        elif name and "Used" in line and "registers" in line:
            facts[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            name = None
    return facts


def flash_error(got: torch.Tensor, want: torch.Tensor):
    """``(max abs error, worst share of the limit)`` of a flash kernel's
    output against its plain version's, the limit ``atol + rtol * |want|``
    of :data:`FLASH_TOL` for their dtype: a share above 1 fails."""
    atol, rtol = FLASH_TOL[want.dtype]
    diff = (got.float() - want.float()).abs()
    share = diff / (atol + rtol * want.float().abs())
    return float(diff.max()), float(share.max())


def flash_tolerance(dtype: torch.dtype) -> str:
    atol, rtol = FLASH_TOL[dtype]
    return f"|err| <= {atol} + {rtol} * |plain|"


def check_flash(device, timer: Timer, sizes: dict) -> dict:
    """The flash-attention kernels against their plain version on the card:
    f32 (3xTF32 on mma.sync) at the tuning space's shape, with Sq != Skv
    both ways (causal, top-left aligned), non-causal, at head dims 64 and
    160 (whole and ragged), at the ragged length 1000 (two tiles) and at a
    prompt shorter than one tile; bf16 (wgmma) at the served model's
    prefill shape (GQA), at the lock-step route's ragged prompt length, at
    a prompt shorter than one tile, with Sq != Skv both ways, non-causal
    over a ragged kv length, with K zero (P.V alone), and at head dims 64
    and 160 (whole and ragged). Every instantiated tile is checked and
    timed at the two timed shapes. Returns the kernels-line entries of the
    bf16 and the f32 kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    g = torch.Generator(device=device)
    g.manual_seed(13)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    bh, seq, hd = sizes["flash_space"]
    mseq, mhq, mhkv, mhd = sizes["flash_model"]
    ragged = sizes["flash_ragged"]
    tiles = attn.flash_tiles(bf16)
    tiles_f32 = attn.flash_tiles(f32)
    # (name, B, Sq, Skv, Hq, Hkv, D, dtype, causal, block_q, block_k)
    cases = [
        ("space_f32", bh, seq, seq, 1, 1, hd, f32, True, *tiles_f32),
        ("model_prefill_bf16", 1, mseq, mseq, mhq, mhkv, mhd, bf16, True,
         *tiles),
        ("sq_ne_skv_f32", 2, seq // 4, seq // 2, 8, 2, hd, f32, True, 64,
         128),
        # an odd number of q tiles: non-causal, the last cluster has a
        # spare block; causal (Sq > Skv), the middle tile is split between
        # the two blocks of its cluster
        ("noncausal_f32", 2, seq // 2 - 40, seq // 2, 4, 4, hd // 2, f32,
         False, 32, 64),
        ("sq_gt_skv_f32", 1, ragged // 3, ragged // 5, 4, 2, hd, f32, True,
         32, 64),
        # the only f32 tile of 128 x 128 rows that fits: head dim 64
        ("head_dim_64_f32", 1, seq // 4, seq // 4, 4, 1, 64, f32, True, 128,
         128),
        ("head_dim_160_f32", 1, seq // 4, seq // 4, 4, 1, 160, f32, True,
         32, 128),
        # the lock-step route's longest prompt: no tile divides it
        ("ragged_f32", 1, ragged, ragged, 5, 1, hd, f32, True, *tiles_f32),
        ("ragged_64x128_f32", 1, ragged, ragged, mhq, mhkv, mhd, f32, True,
         64, 128),
        ("head_dim_160_ragged_f32", 1, 250, 250, 2, 2, 160, f32, True, 64,
         64),
        # a prompt shorter than one tile: the copies past the sequence are
        # zero-filled
        ("short_prompt_f32", 1, 16, 16, 4, 4, hd, f32, True, *tiles_f32),
        # stablelm-12b's head dim
        ("head_dim_160_bf16", 1, seq // 4, seq // 4, 4, 1, 160, bf16, True,
         128, 128),
        # the lock-step route's longest prompt: no tile divides it
        ("model_prefill_ragged_bf16", 1, ragged, ragged, mhq, mhkv, mhd,
         bf16, True, *tiles),
        ("sq_lt_skv_bf16", 2, seq // 4, seq // 2, 8, 2, hd, bf16, True,
         *tiles),
        ("sq_gt_skv_bf16", 1, ragged // 3, ragged // 5, 4, 2, hd, bf16,
         True, *tiles),
        ("noncausal_bf16", 2, seq // 2, seq // 2 - 40, 4, 4, hd, bf16,
         False, *tiles),
        ("head_dim_64_bf16", 1, seq // 4, seq // 4, 4, 1, 64, bf16, True,
         64, 64),
        ("head_dim_160_ragged_bf16", 1, 250, 250, 2, 2, 160, bf16, True,
         *tiles),
        # a served prompt shorter than one tile: TMA boxes longer than the
        # sequence, zero-filled past it
        ("short_prompt_bf16", 1, 16, 16, mhq, mhkv, mhd, bf16, True,
         *tiles),
        # K = 0: every score is 0, so the output is the mean of V's rows
        # and P.V is checked alone
        ("zero_k_bf16", 1, 128, 128, 2, 1, mhd, bf16, False, *tiles),
    ]
    rows = []
    for name, B, Sq, Skv, Hq, Hkv, D, dt, causal, bq, bk in cases:
        q = rnd((B, Sq, Hq, D), dt)
        k = rnd((B, Skv, Hkv, D), dt)
        v = rnd((B, Skv, Hkv, D), dt)
        if name == "zero_k_bf16":
            k.zero_()
        got = fa.flash_attention_bshd(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        block_q=bq, block_k=bk, round_p=True)
        err, share = flash_error(got, want)
        check(share <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention[{name}] differs from its plain version by "
              f"{err}, {share} of the limit {flash_tolerance(dt)}")
        row = {"case": name, "q": list(q.shape), "kv": list(k.shape),
               "dtype": str(dt).replace("torch.", ""), "causal": causal,
               "blocks": [bq, bk], "max_abs_err": err,
               "share_of_limit": share, "tolerance": flash_tolerance(dt)}
        if name in ("space_f32", "model_prefill_bf16"):
            bound, by, flops, byts = flash_bound_ms(
                B, Hq, Hkv, Sq, Skv, D, q.element_size(), causal)
            ms = timer(lambda: fa.flash_attention_bshd(
                q, k, v, causal=causal, block_q=bq, block_k=bk), reps=10,
                queued=True)
            plain_ms = timer(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, block_q=bq, block_k=bk,
                round_p=True), reps=3)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv),
                reps=10, queued=True)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=by, tflops=flops / ms / 1e9,
                       gbytes_s=byts / ms / 1e6)
            # every instantiated tile that fits, at this shape, each held
            # against the plain version: what the model's FLASH_TILES are
            # chosen from
            q_opts, k_opts = fa.tile_options(q.element_size())
            by_tile, err_by_tile, share_by_tile = {}, {}, {}
            for tq in q_opts:
                for tk in k_opts:
                    if fa.unsupported(q.element_size(), D, D, tq, tk):
                        continue
                    out = fa.flash_attention_bshd(q, k, v, causal=causal,
                                                  block_q=tq, block_k=tk)
                    # p is rounded relative to the running max, which
                    # moves tile by tile: the plain version takes the tiles
                    want_t = want if (tq, tk) == (bq, bk) else \
                        fa.flash_attention_plain(
                            q, k, v, causal=causal, block_q=tq, block_k=tk,
                            round_p=True)
                    e, share = flash_error(out, want_t)
                    check(share <= 1.0, f"flash_attention[{name}] at tiles "
                          f"{tq}x{tk} differs from its plain version by {e}, "
                          f"{share} of the limit {flash_tolerance(dt)}")
                    err_by_tile[f"{tq}x{tk}"] = e
                    share_by_tile[f"{tq}x{tk}"] = share
                    by_tile[f"{tq}x{tk}"] = timer(
                        lambda: fa.flash_attention_bshd(
                            q, k, v, causal=causal, block_q=tq, block_k=tk),
                        reps=10, queued=True)
            row.update(ms_by_tile=by_tile, max_abs_err_by_tile=err_by_tile,
                       share_of_limit_by_tile=share_by_tile)
        rows.append(row)
        del q, k, v, got, want
    library = ("F.scaled_dot_product_attention(is_causal, enable_gqa) on "
               "[B, H, S, D] copies (yardstick only)")
    timing = ("CUDA events around each launch, queued behind a sleep kernel "
              "so the wrapper's host work is not timed")
    entries = []
    for dt, source in ((bf16, "flash_attention_sm90.cu"),
                       (f32, "flash_attention.cu")):
        mine = [r for r in rows if r["dtype"] == str(dt).replace("torch.",
                                                                 "")]
        main = next(r for r in mine if "ms" in r)
        entry = {
            "name": "flash_attention" if dt == bf16 else
                    "flash_attention_f32",
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:60",
            "shape": f"q {main['q']}, k/v {main['kv']} "
                     f"{main['dtype']}, causal, blocks {main['blocks']} "
                     + ("(the served model's prefill)" if dt == bf16 else
                        "(the tuning space's shape, the model's f32 tiles)"),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "share_of_limit": max(r["share_of_limit"] for r in mine),
            "tolerance": f"{flash_tolerance(dt)} against the plain version"
                         + (" (p rounded to bf16 for p.v, as in the kernel)"
                            if dt == bf16 else ""),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": library,
            "timing": timing}
        if dt == f32:
            entry.update(
                bound="max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s): "
                      "the products run as 3xTF32 on the tensor cores",
                ms_best_tile=min(main["ms_by_tile"].values()))
        entries.append(entry)
    entries[0]["cases"] = rows
    return entries


def tune_flash(device, sizes: dict) -> dict:
    """tune() over the flash-attention tiles with the wall-clock harness,
    every candidate validated against the oracle, then calibrate()."""
    import repro_torch.core.hardware as hw
    from repro_torch.tuning import (SPACES, FlashAttentionSpace, PerfParams,
                                    WallClockBackend, calibrate, tune)
    chip = hw.H100_SXM
    if device.type == "cuda":
        space = SPACES["flash_attention"](chip, device)
    else:
        bh, seq, hd = sizes["flash_space"]
        space = FlashAttentionSpace(batch_heads=bh, seq_q=seq, head_dim=hd,
                                    chip=chip, device=device)
    backend = WallClockBackend(chip, perf=PerfParams.ideal(), repeats=5,
                               device=device)
    result = tune(space, backend=backend, validate=True)
    meas = result.measurement
    check(max(meas.validation_err) <= space.tol,
          "a flash_attention candidate is outside 2e-5 of kernels.ref")
    cal = calibrate(meas, kind="freq")
    fast, green = result.best("time"), result.best("energy")
    space.release()
    return {
        "shape": [space.batch_heads, space.seq_q, space.head_dim],
        "candidates": [c.label for c in meas.candidates],
        "pruned": [[dict(c), why] for c, why in space.enumerate_all()[1]],
        "wall_ms": {c.label: w * 1e3
                    for c, w in zip(meas.candidates, backend.wall_s)},
        "validation_max_abs_err": max(meas.validation_err),
        "best_time": repr(fast), "best_energy": repr(green),
        "calibration_fit_rms_pct": cal.fit_rms_pct}


def model_prefill_f32(device, sizes: dict) -> dict:
    """The model's f32 prefill route: a causal f32 ``chunked_attention`` at
    the served model's heads and the lock-step route's longest prompt. On
    the card it goes to the f32 kernel at the model's f32 tiles; its output
    is held against the plain route's."""
    from repro_torch.models import attention as attn
    seq, hq, hkv, hd = sizes["flash_model"]
    S = sizes["flash_ragged"]
    g = torch.Generator(device=device)
    g.manual_seed(14)
    q = torch.randn((1, S, hq, hd), generator=g, device=device)
    k = torch.randn((1, S, hkv, hd), generator=g, device=device)
    v = torch.randn((1, S, hkv, hd), generator=g, device=device)
    got = attn.chunked_attention(q, k, v)
    want = attn.chunked_attention(q, k, v, impl="plain")
    err, share = flash_error(got, want)
    check(share <= 1.0, f"chunked_attention f32 kernel route differs from "
          f"the plain route by {err}")
    return {"q": list(q.shape), "kv": list(k.shape), "dtype": "float32",
            "causal": True, "blocks": list(attn.flash_tiles(torch.float32)),
            "max_abs_err": err, "share_of_limit": share,
            "tolerance": flash_tolerance(torch.float32)}


# ---------------------------------------------------------- serving path
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_path(device, sizes: dict):
    """The serving path at full width and depth; returns the report, the
    config and the parameters (for the end-to-end check)."""
    import dataclasses

    import numpy as np

    import repro_torch.core.hardware as hw
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.power import EnergySession
    from repro_torch.serving import (ContinuousEngine, Request, ServeEngine,
                                     poisson_arrivals, serve)
    cfg = get_config(SERVE_ARCH)
    if sizes["serve_reduced"]:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    rt = Runtime()
    max_len, new = sizes["serve_max_len"], sizes["serve_new_tokens"]
    lo, hi = sizes["serve_prompt_lens"]
    report = {"arch": cfg.name, "dtype": cfg.dtype,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
              "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "max_len": max_len, "new_tokens": new}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, rt, gen, device=device)
    _sync(device)
    report["init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    report["params"] = n_params
    report["param_count_config"] = cfg.param_count()
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    def requests(n):
        return [Request(rng.integers(0, V, int(L), dtype=np.int32),
                        max_new_tokens=new)
                for L in rng.integers(lo, hi + 1, n)]

    ops.reset_launch_counts()
    # -- ServeEngine.generate: 4 greedy requests (the continuous route) ----
    gen_sess = EnergySession(policy="energy-aware", chip=hw.H100_SXM,
                             device=device)
    engine = ServeEngine(cfg, rt, params, max_len=max_len, session=gen_sess)
    reqs4 = requests(4)
    t0 = time.perf_counter()
    outs = engine.generate(reqs4)
    _sync(device)
    report["generate"] = {
        "prompt_lens": [len(r.prompt) for r in reqs4],
        "wall_s": time.perf_counter() - t0,
        "tokens": [o.tolist()[:8] for o in outs],
        "session": gen_sess.summary()}
    check(all(o.shape == (new,) and o.min() >= 0 and o.max() < V
              for o in outs), "generate returned malformed tokens")
    del engine
    # -- serve(): 8 Poisson-arriving requests through a 4-slot pool -------
    sess = EnergySession(policy="energy-aware", chip=hw.H100_SXM,
                         device=device)
    ceng = ContinuousEngine(cfg, rt, params, max_slots=4, max_len=max_len,
                            session=sess)
    reqs8 = requests(8)
    arrivals = poisson_arrivals(8, rate_per_step=0.25, seed=0)
    rep = serve(ceng, reqs8, arrivals=arrivals)
    _sync(device)
    check(len(rep.outputs) == 8 and all(
        o.shape == (new,) and o.min() >= 0 and o.max() < V
        for o in rep.outputs), "serve() returned malformed outputs")
    check(rep.n_prefills == 8, "serve() did not prefill every request")
    counts = ops.launch_counts()
    report["serve"] = {
        "prompt_lens": [len(r.prompt) for r in reqs8],
        "arrivals": [float(a) for a in arrivals],
        "wall_s": rep.wall_s, "decode_steps": rep.n_steps,
        "tokens_out": rep.tokens_out, "tokens_per_s": rep.tokens_per_s,
        "occupancy_mean": rep.occupancy_mean, "queue_peak": rep.queue_peak,
        "session": sess.summary(), "phase_report": sess.phase_report()}

    # -- per-phase timing on the warm pool: prefill of the longest prompt,
    #    then decode steps with every slot busy ---------------------------
    long_req = Request(rng.integers(0, V, hi, dtype=np.int32),
                       max_new_tokens=new)
    times, pfs = [], []
    for _ in range(4):
        _sync(device)
        t0 = time.perf_counter()
        pfs.append(ceng.prefill(long_req))
        _sync(device)
        times.append(time.perf_counter() - t0)
    prefill_s = statistics.median(times)
    for slot, pf in enumerate(pfs):
        ceng.insert(pf, slot)
    n_steps = sizes["serve_decode_steps"]
    ceng.generate_step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ceng.generate_step()
    _sync(device)
    decode_s = (time.perf_counter() - t0) / n_steps
    report["timing"] = {
        "prefill_tokens": hi, "prefill_page": ceng._bucket(hi),
        "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": hi / prefill_s,
        "decode_slots": ceng.max_slots, "decode_ms_per_step": decode_s * 1e3,
        "decode_tokens_per_s": ceng.max_slots / decode_s}
    if device.type == "cuda":
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del ceng, pfs

    # -- ServeEngine.generate, sampled: the lock-step route, one
    #    right-padded prefill at the longest prompt, which no tile divides;
    #    its launches are counted on their own ------------------------------
    lens = [hi] + [int(L) for L in rng.integers(lo, hi, 3)]
    sreqs = [Request(rng.integers(0, V, L, dtype=np.int32),
                     max_new_tokens=new) for L in lens]
    seng = ServeEngine(cfg, rt, params, max_len=max_len)
    ops.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    souts = seng.generate(sreqs, temperature=SAMPLED_TEMPERATURE, seed=5)
    _sync(device)
    sampled_launches = ops.launch_counts()["flash_attention"]
    report["generate_sampled"] = {
        "prompt_lens": lens, "temperature": SAMPLED_TEMPERATURE,
        "route": "lock-step (generate_blocking)",
        "wall_s": time.perf_counter() - t0,
        "flash_launches": sampled_launches,
        "tokens": [o.tolist()[:8] for o in souts]}
    check(all(o.shape == (new,) and o.min() >= 0 and o.max() < V
              for o in souts), "sampled generate returned malformed tokens")
    check(sampled_launches == (cfg.n_layers if device.type == "cuda" else 0),
          f"the sampled generate's prefill made {sampled_launches} flash "
          f"launches for {cfg.n_layers} layers")
    del seng
    return report, counts, sampled_launches, cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def end_to_end_check(device, cfg, params, sizes: dict) -> dict:
    """One prompt through prefill + greedy decode on both attention routes.
    Both routes decode alike; they differ in prefill attention, kernel or
    plain. Tokens must agree at every step whose plain-route top-2 margin
    exceeds the routes' logit difference, up to the first step where it
    does not (after that the two contexts may part)."""
    import numpy as np

    from repro_torch.models import decode as decode_mod
    from repro_torch.models.transformer import Runtime
    rng = np.random.default_rng(7)
    S, steps = sizes["e2e_prompt_len"], sizes["e2e_steps"]
    V = cfg.vocab_size
    toks = torch.from_numpy(rng.integers(0, V, (1, S), dtype=np.int32)).to(
        device)
    runs = {}
    for impl in ("kernel", "plain"):
        rt = Runtime(attn_impl=impl)
        logits, state = decode_mod.prefill(cfg, rt, params,
                                           {"tokens": toks}, S + steps)
        seq_logits, seq_toks = [], []
        for i in range(steps):
            lg = logits[0, 0, :V].float()
            tok = int(torch.argmax(lg))
            seq_logits.append(lg)
            seq_toks.append(tok)
            logits, state = decode_mod.decode_step(
                cfg, rt, params,
                torch.tensor([[tok]], dtype=torch.int32, device=device),
                torch.tensor(S + i, dtype=torch.int32, device=device),
                state)
        runs[impl] = (seq_logits, seq_toks)
        del state
    (lk, tk), (lp, tp) = runs["kernel"], runs["plain"]
    diffs, margins, compared = [], [], 0
    for i in range(steps):
        diff = float((lk[i] - lp[i]).abs().max())
        top2 = torch.topk(lp[i], 2).values
        margin = float(top2[0] - top2[1])
        diffs.append(diff)
        margins.append(margin)
        if margin <= diff:
            break
        check(tk[i] == tp[i],
              f"greedy token {i} differs between the kernel and the plain "
              f"route ({tk[i]} vs {tp[i]}) though the margin {margin} "
              f"exceeds the logit difference {diff}")
        compared += 1
    return {"prompt_len": S, "steps": steps,
            "prefill_logits_max_abs_diff": diffs[0],
            "step_logit_diffs": diffs, "plain_top2_margins": margins,
            "tokens_compared": compared, "kernel_tokens": tk,
            "plain_tokens": tp}


FULL = dict(vai_elems=2 ** 28, membw_small_rows=65536,       # 32 MiB
            membw_big_rows=2 ** 21, membw_iters=64,          # 1 GiB
            fleet_rows=9408 * 8, fleet_samples=5760,
            # flash: (batch*heads, seq, head dim) of SPACES; the served
            # model's prefill (seq, q heads, kv heads, head dim)
            flash_space=(4, 1024, 128), flash_model=(1024, 40, 8, 128),
            flash_ragged=1000,
            serve_reduced=False,
            serve_max_len=2048, serve_new_tokens=32,
            serve_prompt_lens=(100, 1000), serve_decode_steps=16,
            e2e_prompt_len=512, e2e_steps=8)
TOY = dict(vai_elems=2 ** 16, membw_small_rows=256, membw_big_rows=2048,
           membw_iters=8, fleet_rows=64, fleet_samples=300,
           flash_space=(2, 128, 64), flash_model=(64, 4, 2, 64),
           flash_ragged=61,
           serve_reduced=True,
           serve_max_len=256, serve_new_tokens=6,
           serve_prompt_lens=(10, 100), serve_decode_steps=2,
           e2e_prompt_len=32, e2e_steps=3)


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
    from repro_torch.kernels import vai as vai_mod

    smi = None
    if device.type == "cuda":
        smi = nvidia_smi_line()
        emit(phase="device", nvidia_smi=smi,
             kind=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda, python=sys.version.split()[0])
        t0 = time.perf_counter()
        build.load_library()
        # what the compiler made of three loops: the vai kernel's FMAs, the
        # f32 flash kernel's TF32 tensor-core products (HMMA), and the bf16
        # flash kernel's tensor-core products (HGMMA) and TMA loads
        # (UTMALDG)
        counts = {"vai_fma_kernel_ffma_in_sass": ("vai_fma_kernel",
                                                  "FFMA"),
                  "flash_f32_hmma_in_sass": ("flash_fwd_f32", "HMMA"),
                  "flash_bf16_hgmma_in_sass": ("flash_fwd_sm90", "HGMMA"),
                  "flash_bf16_utmaldg_in_sass": ("flash_fwd_sm90",
                                                 "UTMALDG")}
        in_sass = dict.fromkeys(counts)
        vai_banks = {}
        try:
            for key, (kernel, op) in counts.items():
                text = build.sass(kernel)
                in_sass[key] = text.count(op)
                (build.build_dir() / f"{kernel}.sass").write_text(text)
            vai_banks = vai_sass_banks(build)
        except (OSError, subprocess.CalledProcessError) as exc:
            print(f"chip_smoke: cuobjdump not usable: {exc}", file=sys.stderr)
        print(build.build_log(), file=sys.stderr)
        emit(phase="build", setup_seconds=time.perf_counter() - t0,
             nvcc_seconds=build.build_seconds,
             library=os.path.relpath(build.library_path(), HERE), **in_sass,
             vai_fma_kernel_sass=vai_banks,
             flash_f32_ptxas=ptxas_facts(build.build_log(),
                                         "flash_fwd_f32_kernel"))
        check(bool(in_sass["flash_bf16_hgmma_in_sass"])
              and bool(in_sass["flash_bf16_utmaldg_in_sass"]),
              f"the bf16 flash kernel shows no HGMMA or UTMALDG: {in_sass}")
        check(bool(in_sass["flash_f32_hmma_in_sass"]),
              f"the f32 flash kernel shows no HMMA: {in_sass}")
        check(set(vai_banks) == set(VAI_SHAPES) and all(
            v["ffma"] > 0 and v["fmul"] == v["fadd"] == 0
            for v in vai_banks.values()),
              f"a vai FMA kernel shows no FFMA, or FMUL / FADD (a folded "
              f"chain): {vai_banks}")

    timer = Timer(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [
        check_vai(device, sizes["vai_elems"], timer,
                  time_loopsizes=VAI_TIME_LOOPSIZES
                  if device.type == "cuda" else (0, 8)),
        check_membw(device, sizes["membw_small_rows"],
                    sizes["membw_big_rows"], sizes["membw_iters"], timer)]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kernels.extend(check_flash(device, timer, sizes))
    emit(phase="flash_attention_check", cases=kernels[-2]["cases"])

    # each path runs with the counts set to 0 just before it and read just
    # after; launches made by the checks above do not count. The f32
    # kernel's path: tune() + calibrate() over its tiles, then the model's
    # f32 prefill (the plain route it is held against launches nothing)
    ops.reset_launch_counts()
    tuning = tune_flash(device, sizes)
    tuning_launches = ops.launch_counts()["flash_attention"]
    emit(phase="flash_attention_tuning", **tuning, launches=tuning_launches)
    ops.reset_launch_counts()
    dispatch = model_prefill_f32(device, sizes)
    dispatch_f32 = ops.launch_counts()["flash_attention"]
    emit(phase="model_dispatch_f32", **dispatch, launches=dispatch_f32)

    ops.reset_launch_counts()
    report = main_path(device, sizes)
    counts = ops.launch_counts()
    report["vai"]["main_path_cost"] = vai_main_path_loss(
        report["vai"]["wall_ms"], vai_mod.LAUNCHES_BY_SHAPE,
        sizes["vai_elems"])
    emit(phase="main_path", **report)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    serve_report, serve_counts, sampled_launches, cfg, params = serve_path(
        device, sizes)
    emit(phase="serve", **serve_report)
    e2e = end_to_end_check(device, cfg, params, sizes)
    emit(phase="serve_kernel_vs_plain", **e2e)
    del params

    launches = {"vai": counts["vai"], "membw": counts["membw"],
                "flash_attention": serve_counts["flash_attention"],
                "flash_attention_f32": tuning_launches + dispatch_f32}
    emit(phase="launches", **launches,
         flash_attention_sampled_generate=sampled_launches,
         flash_attention_f32_tuning=tuning_launches,
         flash_attention_f32_model_dispatch=dispatch_f32)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    if device.type != "cuda":
        emit(ok=False, rehearsal=True, note="CPU rehearsal: nothing measured")
        return 3
    check(counts["vai"] > 0 and counts["membw"] > 0,
          f"the main path did not launch both of its kernels: {counts}")
    check(serve_counts["flash_attention"] > 0,
          "the serving path never launched the flash_attention kernel")
    check(tuning_launches > 0 and dispatch_f32 == 1,
          f"the f32 path launched the f32 flash kernel {tuning_launches} "
          f"times in tuning and {dispatch_f32} in the model's dispatch")
    torch.cuda.synchronize()
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
