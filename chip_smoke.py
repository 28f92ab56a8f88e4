#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the four CUDA kernels from the sources in this checkout (vai, membw,
and flash attention in f32 and in bf16, the bf16 one also at MLA's head
dims (192, 128) and RecurrentGemma's (256, 256), and non-causal at the
VLM's and enc-dec's shapes), holds each against its
plain PyTorch version on the card, tunes the f32 flash-attention tiles and runs
the model's f32 prefill route through the f32 kernel, then drives the
port's paths once at full size through the entry points a user would
call:

    the paper's pipeline: VAI / membw kernels timed by the wall-clock
      harness -> tune -> calibrate -> "calibrated:<kernel>" response tables
      -> one day of Frontier-sized fleet telemetry decomposed on the card
      -> fleet projection (paper Table V and the 8.5 % / 1438 MWh headline)
      -> 1500 synthetic jobs on the card: a Study over three response
      surfaces ("measured", "calibrated:vai", "h100-sxm") on Table V's caps
      and the per-class schedule, bootstrap and jackknife intervals on every
      cell, and validate_main's bootstrap leg; the same Study on CPU tensors
      must agree within rtol 1e-12
    the stream and the broker: the same day of fleet telemetry streamed in
      2**22-sample shards through StreamingTelemetry (bit for bit with
      decompose, histogram counts exact), the 1500-job table as a stream
      (bit for bit with decompose_batch), four counterfactual replays of it
      and replay at 2**23 / 2**24 samples (peak memory flat in the trace
      length); the 12-cell broker x budget Study of 1500 jobs and the
      50k-job greedy broker run; each replay and the broker Study again on
      CPU tensors, within rtol 1e-12
    the serving path: qwen2.5-14b at full width and depth in bf16 (random
      weights from a seeded generator) -> ServeEngine.generate on 4 greedy
      requests -> serve() on 8 Poisson-arriving requests through a slot pool
      metered by an energy-aware EnergySession -> ServeEngine.generate on 4
      sampled requests (the lock-step route, one prefill at a 1000-token
      prompt); prefill attention runs the flash kernel, and the same prompt
      served through the plain attention route must give the same greedy
      tokens wherever the logits' top-2 margin exceeds the difference
      between the two routes
    the MoE models, one after the other: dbrx-132b (8 of 40 layers) and
      deepseek-v3-671b (MLA attention; 2 of 61 layers, no multi-token
      prediction head) at full width in bf16, freed before the next is
      built -> ServeEngine.generate on 4 greedy requests -> serve() on the
      same Poisson arrivals; their prefill attention runs the bf16 flash
      kernel at head dims (128, 128) and (192, 128). DBRX's layer 0 in f32
      holds the MoE local path against the dense oracle; each model's
      prompt through the plain attention route must give the same greedy
      tokens by the margin rule, and layer 0 must route the prompt's tokens
      alike on the kernel route and on routes that compute the same
      attention, and not on the kernel route with a wrong softmax scale
    the recurrent models, one after the other, at full width and depth in
      bf16: mamba2-2.7b (64 SSD layers) and recurrentgemma-2b (18 RG-LRU
      and 8 local-attention layers) -> ServeEngine.generate on 4 greedy
      requests of 1024 tokens (the lock-step route); recurrentgemma's
      local-attention prefill runs the bf16 flash kernel at head dims
      (256, 256), and its prompt through the plain attention route must
      give the same greedy tokens by the margin rule. One layer of each
      in f32 holds the chunked SSD and the doubling RG-LRU scan against
      their one-token decode steps
    the VLM and the enc-dec, one after the other, at full width and depth
      in bf16: llama-3.2-vision-11b (40 self layers, 8 gated cross blocks
      over 1600 image patches; its tanh gates, zeros at init, drawn
      non-zero) and seamless-m4t-large-v2 (24 encoder layers over 4096
      audio frames, 24 decoder layers) -> ServeEngine.generate on 4 greedy
      requests (1024 / 256 tokens) with a frontend in extra_batch (the
      lock-step route). The bf16 flash kernel runs their causal
      self-attention at prefill and their non-causal calls (the encoder,
      cross-attention at prefill and at every decode step, Sq = 1), each
      launch count held; the first cross-attention layer's output, its
      inputs alike on every route, must lie within the flash tolerance of
      the plain route's with p rounded and outside it on a kernel with a
      wrong softmax scale, and a second frontend must move the logits by
      more than the two attention routes differ
    training: the attention's gradients under autograd (the FlashAttention
      Function, plain f32, no kernel) against autograd through dense f64
      attention on the card, causal at stablelm-12b's head dims and MLA's
      (192, 128), non-causal at the enc-dec's cross shape, bf16 and f32;
      stablelm-12b and dbrx-132b reduced in f32, three make_train_step
      steps on the card against the same on CPU tensors from one state;
      restart from a checkpoint on the card; then stablelm-12b at full width
      in bf16 with f32 AdamW moments (4 of 40 layers) -> Trainer.run() for
      4 steps of 2 x 4096 tokens under an energy-aware EnergySession. No
      kernel launches in training, as the reference's training never
      reaches its Pallas kernel

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
import contextlib
import functools
import json
import math
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
#: the MoE models served at full width and cut depth, freed one before the
#: next is built: (arch, the config's cuts, why)
MOE_SERVE = (
    ("dbrx-132b", {"n_layers": 8},
     "memory: a layer holds 3.26 B parameters (6.52 GB in bf16), the "
     "untied embeddings 2.47 GB; 40 layers would need ~263 GB of one "
     "card's 80 GB"),
    ("deepseek-v3-671b", {"n_layers": 2, "mtp_depth": 0},
     "memory: a layer holds ~11.5 B parameters (23.0 GB in bf16), the "
     "embeddings 3.71 GB; the multi-token-prediction head is one more MoE "
     "block (23 GB) that only training reads"),
)
#: q/k and v head dims of MLA's prefill attention (deepseek-v3-671b)
MLA_HEAD_DIMS = (192, 128)
#: q/k and v head dims of RecurrentGemma's local attention
RG_HEAD_DIMS = (256, 256)
#: the flash cases timed (every tile, beside the plain version and SDPA)
TIMED_FLASH_CASES = ("space_f32", "model_prefill_bf16", "mla_prefill_bf16",
                     "rg_local_prefill_served_bf16", "rg_local_prefill_bf16",
                     "vlm_self_prefill_bf16", "vlm_cross_prefill_bf16",
                     "vlm_cross_decode_bf16", "encdec_encoder_bf16",
                     "encdec_self_prefill_bf16", "encdec_cross_prefill_bf16",
                     "encdec_cross_decode_bf16")
#: the recurrent models, served at full width and depth one after the other,
#: each on this many requests of one length (``rec_prompt_len``) in one
#: lock-step prefill
RECURRENT_SERVE = ("mamba2-2.7b", "recurrentgemma-2b")
REC_REQUESTS = 4
#: the VLM and the enc-dec, served at full width and depth one after the
#: other, each on this many requests of one length (``cross_serve``: prompt
#: length and max_len by arch) with a frontend in ``extra_batch``
CROSS_SERVE = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
CROSS_REQUESTS = 4
#: the scale of the frontends drawn here (standard normal times this): a
#: vision or speech encoder's output enters the decoder at the residual
#: stream's own scale. The serve CLI's stub (0.02, as the reference's) puts
#: the VLM's cross-attention scores near 0.02 (q of unit scale, k of the
#: frontend's) and its outputs near 5e-4, below the bf16 flash limit's
#: atol: neither the image nor a broken kernel would show
FRONTEND_SCALE = 1.0
#: the kernels-line rows of the flash kernel's calls on the VLM and enc-dec
#: paths, each at the shape serve_cross gives it: (kernels-line name,
#: check_flash case, the arch whose generate() launches it, what)
CROSS_FLASH_ROWS = (
    ("flash_attention_vlm_self_prefill", "vlm_self_prefill_bf16",
     "llama-3.2-vision-11b",
     "(llama-3.2-vision-11b's causal self-attention at prefill)"),
    ("flash_attention_vlm_cross_prefill", "vlm_cross_prefill_bf16",
     "llama-3.2-vision-11b",
     "(llama-3.2-vision-11b's cross-attention at prefill, 1600 patches)"),
    ("flash_attention_vlm_cross_decode", "vlm_cross_decode_bf16",
     "llama-3.2-vision-11b",
     "(llama-3.2-vision-11b's cross-attention at a decode step, Sq = 1)"),
    ("flash_attention_encdec_encoder", "encdec_encoder_bf16",
     "seamless-m4t-large-v2",
     "(seamless-m4t-large-v2's encoder self-attention, 4096 frames)"),
    ("flash_attention_encdec_self_prefill", "encdec_self_prefill_bf16",
     "seamless-m4t-large-v2",
     "(seamless-m4t-large-v2's causal decoder self-attention at prefill)"),
    ("flash_attention_encdec_cross_prefill", "encdec_cross_prefill_bf16",
     "seamless-m4t-large-v2",
     "(seamless-m4t-large-v2's cross-attention at prefill, 4096 frames)"),
    ("flash_attention_encdec_cross_decode", "encdec_cross_decode_bf16",
     "seamless-m4t-large-v2",
     "(seamless-m4t-large-v2's cross-attention at a decode step, Sq = 1)"))
#: the chunked SSD and the doubling RG-LRU scan against their one-token
#: decode steps, one layer at full width in f32: |err| <= atol + rtol *
#: |step|. Both sides sum the same terms in another order; the SSD's
#: cumulative log decay over a chunk reaches O(100), where one f32 step is
#: ~1e-5, and exp(seg_i - seg_j) carries that as a relative error
SCAN_TOL = (1e-4, 1e-4)
#: a second draw of the SSD block with dt in Mamba2's trained range:
#: ``dt_bias`` -4 (softplus gives ~0.02 a token) and ``A_log`` 0 (A = -1),
#: so a chunk's decay exp(seg_L) is a few hundredths and the state each
#: chunk carries into the next holds weight (at the initial ``dt_bias`` of
#: 0 it is ~exp(-100), and a dropped carry would not show)
SSD_TRAINED_DT = {"dt_bias": -4.0, "A_log": 0.0}
#: the MoE local path against the dense oracle: DBRX layer 0 in f32 on this
#: many tokens, within the reference test's tolerance (tests/test_moe.py)
MOE_CHECK_TOKENS = 64
MOE_TOL = 2e-4
#: the least share of a prompt's tokens that layer 0 of an MoE model must
#: route to the same experts as the kernel route, on the plain attention
#: route, on the plain route with p rounded as in the kernel and on a second
#: run of the kernel route; the kernel route with its softmax scale off by
#: MOE_BROKEN_SCALE must route fewer tokens alike (PERF.md §7 has the
#: readings this limit lies between)
MOE_ROUTING_AGREEMENT = 0.9
#: the broken witness: the scale a kernel would take from Dv in place of D
#: at MLA's head dims, 1/sqrt(128) for 1/sqrt(192); the hybrid's witness
#: takes the same factor
MOE_BROKEN_SCALE = math.sqrt(MLA_HEAD_DIMS[0] / MLA_HEAD_DIMS[1])
#: the job leg: the response surfaces of its Study, its bootstrap count and
#: the tolerance of the card against the host
JOB_TABLES = ("measured", "calibrated:vai", "h100-sxm")
JOB_N_BOOT = 2000
JOB_RTOL = 1e-12
SAMPLED_TEMPERATURE = 0.7
#: the stream leg: the replays of examples/streaming_replay.py (label,
#: evaluation chip, policy, knobs), all recorded on the MI250X GCD; the
#: tolerance of their card run against the host's
REPLAY_SCENARIOS = (
    ("energy-aware", "mi250x-gcd", "energy-aware", {}),
    ("energy-aware dT<=10%", "mi250x-gcd", "energy-aware",
     {"slowdown_budget": 0.10}),
    ("power-cap 400 W", "mi250x-gcd", "power-cap", {"cap_w": 400.0}),
    ("energy-aware dT<=10% on tpu-v5e", "tpu-v5e", "energy-aware",
     {"slowdown_budget": 0.10}),
)
STREAM_RTOL = 1e-12
#: the broker leg: the grid of examples/power_broker.py and the run of
#: benchmarks/bench_broker.py
BROKERS = ("uniform", "greedy", "class-schedule", "oracle")
BROKER_BUDGETS_MW = (0.6, 1.0, 1.6)
BROKER_N_NODES = 10_000
BROKER_BENCH = dict(budget_mw=2.0, arrival_gap_s=130.0)


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` is ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


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
    ci = projection.headline_bootstrap_ci(device=device)
    check(ci.n == 1500 and 8.5 in ci,
          f"the headline bootstrap interval misses 8.5: {ci}")
    report["table_v_max_abs_err"] = errs
    report["headline_900mhz"] = head_row.to_dict()
    report["headline_bootstrap_ci"] = {"lo": ci.lo, "hi": ci.hi,
                                       "point": ci.value, "n": ci.n}

    # -- the job layer: 1500 jobs through Study and its intervals ---------
    jobs_report, jobs_raw = jobs_study(device, sizes["jobs"], cal)
    report["jobs"] = jobs_report
    report["seconds"] = time.perf_counter() - t_start
    return report, jobs_raw


def jobs_study(device, n_jobs: int, cal):
    """The job layer at the headline leg's class mix: ``n_jobs`` synthetic
    jobs on ``device``, one Study over :data:`JOB_TABLES` on Table V's caps
    plus the per-class schedule (``cap=None``), bootstrap and jackknife
    intervals of ``savings_dt0_pct`` on every cell, and the fleet's job
    report. The ``"calibrated:vai"`` cells evaluate on the H100 and must
    resolve to ``cal``, the calibration this run registered from its own
    vai launches. Returns the report and the raw results."""
    import numpy as np

    import repro_torch.core.hardware as hw
    from repro_torch.power import (FleetAnalysis, Scenario, Study, Workload,
                                   resolve_tables)
    from repro_torch.power.jobs import HEADLINE_CLASS_MIX
    check(resolve_tables("calibrated:vai", chip=hw.H100_SXM, device=device)
          is cal.tables, "calibrated:vai does not resolve to this run's "
          "registered calibration")
    secs = {}
    t0 = time.perf_counter()
    w = Workload.synthetic_jobs(n_jobs, seed=0, class_mix=HEADLINE_CLASS_MIX,
                                device=device)
    _sync(device)
    secs["synthesis_host"] = time.perf_counter() - t0
    table = w.fleet().jobs
    check(table.powers.device.type == device.type
          and table.powers.dtype == torch.float64
          and table.mask.device.type == device.type, "job table misplaced")

    t0 = time.perf_counter()
    w.fleet().per_job()
    w.fleet().decompose()
    _sync(device)
    secs["decompose"] = time.perf_counter() - t0

    caps = sorted(hw.PAPER_TABLE_V_FREQ, reverse=True) + [None]
    cells = [Scenario(w, cap=c, tables=t,
                      chip=hw.H100_SXM if t.startswith("calibrated") else None)
             for t in JOB_TABLES for c in caps]
    t0 = time.perf_counter()
    res = Study(scenarios=cells).run()
    _sync(device)
    secs["study"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    boot = res.confidence("savings_dt0_pct", n_boot=JOB_N_BOOT)
    _sync(device)
    secs["bootstrap"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jack = res.confidence("savings_dt0_pct", method="jackknife")
    _sync(device)
    secs["jackknife"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = FleetAnalysis.from_jobs(table).job_report()
    secs["job_report"] = time.perf_counter() - t0
    # one bootstrap draw alone (host numpy): the part of a cell's interval
    # that never reaches the card
    t0 = time.perf_counter()
    np.random.default_rng(0).multinomial(n_jobs, np.full(n_jobs, 1.0 / n_jobs),
                                         size=JOB_N_BOOT)
    secs["one_bootstrap_draw_host"] = time.perf_counter() - t0

    check(len(res) == len(JOB_TABLES) * len(caps), "Study lost cells")
    for c, b, j in zip(res, boot, jack):
        check(all(math.isfinite(getattr(c, k)) for k in
                  ("savings_pct", "dt_pct", "savings_dt0_pct")),
              f"a job cell is not finite: {c.to_dict()}")
        for ci in (b, j):
            check(ci.n == n_jobs and ci.lo <= ci.value <= ci.hi
                  and abs(ci.value - c.savings_dt0_pct)
                  <= 1e-9 * max(1.0, abs(ci.value)),
                  f"a job cell's interval is off: {ci} for {c.to_dict()}")
    cal_cells = res.filter(tables=cal.tables.source)
    check(len(cal_cells) == len(caps)
          and all(c.chip == hw.H100_SXM.name for c in cal_cells),
          "the calibrated cells did not evaluate on the H100's tables")
    sched = res.filter(tables="mi250x-table-iii", cell="schedule")[0]
    check(sched.detail.to_dict() == rep.to_dict(),
          "the Study's schedule cell differs from FleetAnalysis.job_report")

    report = {
        "n_jobs": n_jobs, "table_shape": list(table.powers.shape),
        "table_bytes": table.powers.numel() * 8 + table.mask.numel(),
        "samples": int(table.lengths.sum()), "seconds": secs,
        "cells": [{"tables": c.tables, "chip": c.chip,
                   "cap": c.to_dict()["cap"], "cell": c.cell,
                   "savings_pct": c.savings_pct, "dt_pct": c.dt_pct,
                   "savings_dt0_pct": c.savings_dt0_pct,
                   "bootstrap_ci": [b.lo, b.hi], "jackknife_ci": [j.lo, j.hi],
                   "class_caps": None if c.cell != "schedule" else
                   {r.job_class: r.cap for r in c.detail.classes}}
                  for c, b, j in zip(res, boot, jack)],
        "job_report": rep.to_dict()}
    return report, {"cells": res, "bootstrap": boot, "jackknife": jack,
                    "cal": cal, "table": table}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def jobs_card_vs_host(card: dict, n_jobs: int, cal) -> dict:
    """The job leg's Study run again on CPU tensors: every cell's savings,
    dT and both intervals within :data:`JOB_RTOL` of the card's, with equal
    class picks, caps and dT=0 verdicts."""
    _, host = jobs_study(torch.device("cpu"), n_jobs, cal)
    worst = 0.0
    for c, h in zip(card["cells"], host["cells"]):
        check((c.tables, c.chip, c.cap, c.cell) == (h.tables, h.chip, h.cap,
                                                    h.cell),
              "card and host cells are not the same grid")
        for k in ("savings_pct", "dt_pct", "savings_dt0_pct", "savings_mwh"):
            worst = max(worst, _rel(getattr(c, k), getattr(h, k)))
        if c.cell == "schedule":
            check([(r.job_class, r.n_jobs, r.cap, r.meets_dt0)
                   for r in c.detail.classes]
                  == [(r.job_class, r.n_jobs, r.cap, r.meets_dt0)
                      for r in h.detail.classes],
                  f"class picks differ between card and host: "
                  f"{c.detail.to_dict()} / {h.detail.to_dict()}")
    for key in ("bootstrap", "jackknife"):
        for c, h in zip(card[key], host[key]):
            check(c.n == h.n, f"{key} resampled different job counts")
            for k in ("value", "lo", "hi"):
                worst = max(worst, _rel(getattr(c, k), getattr(h, k)))
    check(worst <= JOB_RTOL,
          f"the job Study on the card differs from the host by rtol {worst}")
    return {"cells": len(card["cells"]), "max_rel_diff": worst,
            "rtol": JOB_RTOL}


# ------------------------------------------------------- stream / broker
def _measured(device, fn):
    """``fn()`` timed on the host clock around a synchronise, with the
    device's peak allocation over the call (absolute, and above what was
    allocated before it); no memory figures on the CPU rehearsal."""
    _sync(device)
    base = peak = None
    if device.type == "cuda":
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    secs = time.perf_counter() - t0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
    return out, {"seconds": secs,
                 "peak_bytes": peak,
                 "peak_above_start_bytes": None if peak is None
                 else peak - base}


def _replay_rows(rep) -> list:
    return [(r.job_id, r.n_samples, r.energy_rec_j, r.energy_base_j,
             r.energy_new_j, r.time_rec_s, r.time_new_s) for r in rep.jobs]


def stream_phase(device, sizes: dict, table) -> dict:
    """The out-of-core stream and counterfactual replay on the card: the
    Frontier-day fleet folded shard by shard against the one-shot
    decomposition (bit for bit, histogram counts exact), the job table's
    stream against its batch decomposition and job report, the replays of
    examples/streaming_replay.py against the same replays on CPU tensors,
    and replay at scale with its peak memory."""
    from repro_torch.core import modal
    from repro_torch.power import (FleetAnalysis, JobTable,
                                   StreamingTelemetry, iter_array, replay)
    report = {}
    n_rows, n_cols = sizes["fleet_rows"], sizes["fleet_samples"]
    flat = modal.synth_fleet_powers(n_rows * n_cols, seed=0, device=device)
    _sync(device)
    shard = sizes["stream_shard"]

    # -- fleet scope at the Frontier-day size ------------------------------
    st, fold = _measured(device, lambda: StreamingTelemetry(
        track_jobs=False).extend(iter_array(flat, chunk=shard)))
    got = st.decomposition()
    want, one_shot = _measured(device, lambda: modal.decompose(flat))
    check(st.n_samples == flat.numel(), "the stream lost samples")
    for key in ("hours_pct", "energy_mwh", "total_energy_mwh"):
        check(getattr(got, key) == getattr(want, key),
              f"streamed {key} differs from decompose: "
              f"{getattr(got, key)} / {getattr(want, key)}")
    (c_want, h_want), hist = _measured(device, lambda: modal.power_histogram(
        flat, bins=st.bins, max_w=st.max_w))
    counts = torch.histc(torch.clamp(flat, max=st.max_w), bins=st.bins,
                         min=0.0, max=st.max_w).to(torch.int64)
    c_got, h_got = st.histogram()
    check(torch.equal(st.hist_counts(), counts)
          and int(counts.sum()) == flat.numel(),
          "streamed histogram counts differ from power_histogram's")
    check(torch.equal(h_got, h_want) and torch.equal(c_got, c_want),
          "streamed histogram density differs from power_histogram's")
    report["fleet"] = {
        "samples": flat.numel(), "bytes": flat.numel() * 8,
        "shard_samples": shard, "shards": -(-flat.numel() // shard),
        "stream": fold, "decompose": one_shot, "power_histogram": hist,
        "bit_for_bit": True, "histogram_counts_equal": True,
        "total_energy_mwh": got.total_energy_mwh}

    # -- per-job scope: the job leg's table as a stream --------------------
    jshard = sizes["stream_job_shard"]
    fa, per_job = _measured(device, lambda: FleetAnalysis.from_stream(
        table.to_stream(samples_per_shard=jshard)))
    batch = table.decompose()
    streamed = fa.per_job()
    for key in ("hours_pct", "energy_mwh", "total_energy_mwh", "n_samples"):
        check(torch.equal(getattr(streamed, key), getattr(batch, key)),
              f"streamed per-job {key} differs from decompose_batch")
    check(fa.job_report().to_dict()
          == FleetAnalysis.from_jobs(table).job_report().to_dict(),
          "the streamed job report differs from the in-memory one")
    n_samples = int(table.lengths.sum())
    report["jobs"] = {"n_jobs": len(table), "samples": n_samples,
                      "shard_samples": jshard,
                      "shards": -(-n_samples // jshard),
                      "from_stream": per_job, "bit_for_bit": True,
                      "job_report_equal": True}

    # -- replay, card against host -----------------------------------------
    host_table = JobTable(table.traces, chip=table.chip,
                          sample_interval_s=table.sample_interval_s,
                          device="cpu")
    worst = 0.0
    scenarios = []
    for label, target, policy, knobs in REPLAY_SCENARIOS:
        rep, timing = _measured(device, lambda: replay(
            table.to_stream(samples_per_shard=jshard), policy, chip=target,
            record_chip="mi250x-gcd", **knobs))
        host, host_timing = _measured(torch.device("cpu"), lambda: replay(
            host_table.to_stream(samples_per_shard=jshard), policy,
            chip=target, record_chip="mi250x-gcd", **knobs))
        check(rep.n_samples == host.n_samples == n_samples,
              f"replay {label}: sample counts differ")
        a, b = _replay_rows(rep), _replay_rows(host)
        check([r[:2] for r in a] == [r[:2] for r in b],
              f"replay {label}: job order or n_samples differ")
        for k in ("energy_rec_j", "energy_base_j", "energy_new_j",
                  "time_rec_s", "time_new_s"):
            worst = max(worst, _rel(getattr(rep, k), getattr(host, k)))
        for ra, rb in zip(a, b):
            worst = max([worst] + [_rel(x, y) for x, y in
                                   zip(ra[2:], rb[2:])])
        scenarios.append({
            "scenario": label, "chip": target, "savings_pct":
            rep.savings_pct, "dt_pct": rep.dt_pct,
            "model_bias_pct": rep.model_bias_pct,
            "card": timing, "host_seconds": host_timing["seconds"]})
    check(worst <= STREAM_RTOL,
          f"replay on the card differs from the host by rtol {worst}")
    report["replay"] = {"scenarios": scenarios, "max_rel_diff": worst,
                        "rtol": STREAM_RTOL}

    # -- replay at scale: time and the O(shard) memory contract -------------
    rshard = sizes["replay_shard"]
    scale = []
    for n in (rshard,) + tuple(sizes["replay_sizes"]):
        rep, m = _measured(device, lambda: replay(
            iter_array(flat[:n], chunk=rshard), "energy-aware",
            chip="mi250x-gcd"))
        check(rep.n_samples == n and math.isfinite(rep.savings_pct),
              f"replay of {n} samples is off: {rep.n_samples}")
        scale.append({"samples": n, **m,
                      "samples_per_s": n / m["seconds"],
                      "savings_pct": rep.savings_pct})
    if device.type == "cuda":
        one, small, big = (r["peak_above_start_bytes"] for r in scale)
        check(big - small <= one,
              f"replay memory grows with the trace: {small} B at "
              f"{scale[1]['samples']} samples, {big} B at "
              f"{scale[2]['samples']}, one shard {one} B")
    report["replay_at_scale"] = {"shard_samples": rshard, "runs": scale}
    del flat, st, fa
    return report


def _broker_outcome(rep) -> tuple:
    return (rep.broker, rep.budget_mw, rep.n_events, rep.n_scaled_events,
            rep.makespan_s, rep.throughput_jobs_per_h, rep.mean_wait_s,
            rep.budget_exceeded)


def broker_phase(device, sizes: dict) -> dict:
    """The online broker on the card: the Study grid of
    examples/power_broker.py against the same Study on CPU tensors, and the
    run of benchmarks/bench_broker.py at its size on the card and on the
    host, side by side."""
    from repro_torch.power import (ClusterTrace, Study, Workload,
                                   class_cap_report, simulate_cluster)
    from repro_torch.power.jobs import default_caps
    report = {}
    results, secs = {}, {}
    for dev in (device, torch.device("cpu")):
        w = Workload.synthetic_jobs(sizes["broker_jobs"], seed=0,
                                    device=dev)
        study = Study(workloads=[w], brokers=list(BROKERS),
                      budgets_mw=list(BROKER_BUDGETS_MW),
                      n_nodes=BROKER_N_NODES, kind="power")
        results[dev.type], m = _measured(dev, study.run)
        secs[dev.type] = m["seconds"]
    card, host = results[device.type], results["cpu"]
    check(len(card) == len(BROKERS) * len(BROKER_BUDGETS_MW),
          "the broker Study lost cells")
    worst = 0.0
    for c, h in zip(card, host):
        check(_broker_outcome(c.detail) == _broker_outcome(h.detail),
              f"broker cell differs between card and host: "
              f"{_broker_outcome(c.detail)} / {_broker_outcome(h.detail)}")
        check(c.detail.offline or not c.detail.budget_exceeded,
              f"an online broker exceeded its budget: {c.detail}")
        for k in ("savings_pct", "savings_mwh"):
            worst = max(worst, _rel(getattr(c.detail, k),
                                    getattr(h.detail, k)))
        worst = max([worst] + [_rel(a, b) for a, b in zip(
            c.detail.bin_energy_mwh, h.detail.bin_energy_mwh)])
    check(worst <= STREAM_RTOL,
          f"the broker Study on the card differs from the host by rtol "
          f"{worst}")
    trace = card[0].scenario.workload.cluster_trace()
    bound = class_cap_report(trace.decomp, caps=default_caps("power"),
                             kind="power")
    for c in card.filter(policy="oracle"):
        check(c.detail.savings_mwh == bound.total_savings_mwh,
              "the oracle's savings differ from class_cap_report's")
    front = card.pareto()
    report["study"] = {
        "n_jobs": sizes["broker_jobs"], "cells": len(card),
        "seconds": secs, "max_rel_diff": worst, "rtol": STREAM_RTOL,
        "class_cap_report_savings_mwh": bound.total_savings_mwh,
        "cells_detail": [{
            "broker": c.policy, "budget_mw": c.budget_mw,
            "n_events": c.detail.n_events, "n_ticks": c.detail.n_ticks,
            "makespan_s": c.detail.makespan_s,
            "throughput_jobs_per_h": c.throughput_jobs_per_h,
            "mean_wait_s": c.detail.mean_wait_s,
            "savings_pct": c.savings_pct,
            "budget_exceeded": c.detail.budget_exceeded}
            for c in card],
        "pareto": [{"broker": c.policy, "budget_mw": c.budget_mw,
                    "throughput_jobs_per_h": c.throughput_jobs_per_h,
                    "savings_pct": c.savings_pct} for c in front]}

    bench = {}
    for dev in (device, torch.device("cpu")):
        trace, built = _measured(dev, lambda: ClusterTrace.synthetic(
            sizes["broker_bench_jobs"], seed=0,
            arrival_gap_s=BROKER_BENCH["arrival_gap_s"], device=dev))
        rep, m = _measured(dev, lambda: simulate_cluster(
            trace, "greedy", BROKER_BENCH["budget_mw"],
            n_nodes=BROKER_N_NODES, kind="power"))
        check(rep.n_jobs == sizes["broker_bench_jobs"]
              and not rep.budget_exceeded,
              f"the bench_broker run on {dev.type} is off: {rep}")
        bench[dev.type] = {
            "trace_seconds": built["seconds"], "seconds": m["seconds"],
            "n_events": rep.n_events, "n_ticks": rep.n_ticks,
            "seconds_per_tick": m["seconds"] / max(rep.n_ticks, 1),
            "savings_pct": rep.savings_pct,
            "makespan_s": rep.makespan_s,
            "peak_alloc_mw": rep.peak_alloc_w / 1e6,
            "budget_exceeded": rep.budget_exceeded,
            "peak_bytes": m["peak_bytes"]}
    a, b = bench[device.type], bench["cpu"]
    check((a["n_events"], a["n_ticks"], a["makespan_s"])
          == (b["n_events"], b["n_ticks"], b["makespan_s"]),
          "the bench_broker run differs between card and host")
    bench["faster_side"] = device.type if a["seconds"] < b["seconds"] \
        else "cpu"
    report["bench_broker"] = {"n_jobs": sizes["broker_bench_jobs"],
                              "broker": "greedy", **BROKER_BENCH,
                              "n_nodes": BROKER_N_NODES, **bench}
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


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, itemsize, causal, Dv=None):
    """Least time for one call: bytes (q and k of head dim D, v and o of
    Dv, each read or written once) over the HBM rate against the flops the
    function needs (2 D for q.k and 2 Dv for p.v per unmasked score entry)
    over the rate of the tensor-core products the kernel does them with:
    bf16 at the bf16 peak; f32 as 3xTF32, three TF32 products for each f32
    one, at the TF32 peak. As kernels/flash_attention.py's
    flash_attention_work counts them."""
    Dv = D if Dv is None else Dv
    flops = 2.0 * B * Hq * attention_entries(Sq, Skv, causal) * (D + Dv)
    byts = itemsize * (B * Sq * Hq * (D + Dv) + B * Skv * Hkv * (D + Dv))
    by_bytes = byts / HBM_BYTES_PER_S * 1e3
    by_ops = (3 * flops / TF32_TENSOR_FLOPS if itemsize == 4 else
              flops / BF16_TENSOR_FLOPS) * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", flops, byts)


def ptxas_facts(log: str, kernel: str) -> dict:
    """Registers and spill bytes ``ptxas -v`` gave each instantiation of
    ``kernel`` (a template over head dim, block_q and block_k, keyed
    ``D<d>_<block_q>x<block_k>``; or over head dims D and Dv, block_q and
    block_k, keyed ``D<d>_<dv>_<block_q>x<block_k>``)."""
    import re
    facts, name = {}, None
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELi(\d+)E(?:Li(\d+)E)?",
                      line)
        if "Compiling entry function" in line:
            if m and m[4]:
                name = f"D{m[1]}_{m[2]}_{m[3]}x{m[4]}"
            else:
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
    over a ragged kv length, with K zero (P.V alone), at head dims 64
    and 160 (whole and ragged), and at MLA's prefill (q/k of head dim 192,
    v of 128, 128 heads; whole and ragged). Every instantiated tile is
    checked and timed at the timed shapes; and bf16 at RecurrentGemma's
    local-attention prefill (head dims (256, 256), 10 q heads over one kv
    head; at the served batch of REC_REQUESTS prompts, at one prompt, and
    ragged); and bf16 at every shape the VLM and enc-dec paths give it:
    llama-3.2-vision-11b's causal self-attention at prefill and its
    cross-attention at prefill and at a decode step (Sq = 1),
    seamless-m4t-large-v2's encoder, its causal decoder self-attention at
    prefill and its cross-attention at prefill and at a decode step, each
    at the model's tiles. Returns the kernels-line entries of
    the bf16 kernel at D = Dv = 128, at (192, 128) and at (256, 256), and
    of the f32 kernel, each from the first timed case at its head dims
    (the rows of the VLM and enc-dec paths apart), then one entry for each
    of those rows (CROSS_FLASH_ROWS)."""
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
    mla_seq, mla_heads = sizes["flash_mla"]
    rg_seq, rg_heads, rg_kv = sizes["flash_rg"]
    rec_seq = sizes["rec_prompt_len"]
    vb, vs, vf, vhq, vhkv, vhd = sizes["flash_vlm"]
    eb, es, ef, eh, ehd = sizes["flash_encdec"]
    tiles = attn.flash_tiles(bf16)
    tiles_f32 = attn.flash_tiles(f32)
    tiles_rg = attn.flash_tiles(bf16, RG_HEAD_DIMS)
    # (name, B, Sq, Skv, Hq, Hkv, D or (D, Dv), dtype, causal, block_q,
    #  block_k)
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
        # MLA prefill (deepseek-v3-671b): q/k of qk_nope + qk_rope = 192, v
        # of v_head_dim = 128, one kv head a q head; the lock-step route's
        # ragged prompt too
        ("mla_prefill_bf16", 1, mla_seq, mla_seq, mla_heads, mla_heads,
         MLA_HEAD_DIMS, bf16, True, *tiles),
        ("mla_prefill_ragged_bf16", 1, ragged, ragged, mla_heads, mla_heads,
         MLA_HEAD_DIMS, bf16, True, *tiles),
        # RecurrentGemma's local-attention prefill (recurrentgemma-2b): 10 q
        # heads over one kv head of 256, the window masking no key; at the
        # shape serve_recurrent gives it (REC_REQUESTS prompts of
        # rec_prompt_len in one prefill: its kernels row), at one prompt,
        # and at the lock-step route's ragged prompt
        ("rg_local_prefill_served_bf16", REC_REQUESTS, rec_seq, rec_seq,
         rg_heads, rg_kv, RG_HEAD_DIMS, bf16, True, *tiles_rg),
        ("rg_local_prefill_bf16", 1, rg_seq, rg_seq, rg_heads, rg_kv,
         RG_HEAD_DIMS, bf16, True, *tiles_rg),
        ("rg_local_prefill_ragged_bf16", 1, ragged, ragged, rg_heads, rg_kv,
         RG_HEAD_DIMS, bf16, True, *tiles_rg),
        # the calls of the VLM and enc-dec paths, at the shapes and tiles
        # serve_cross gives them (CROSS_REQUESTS prompts in one prefill):
        # llama-3.2-vision-11b's causal self-attention, its cross-attention
        # over the 1600 patches at prefill and at a decode step (one query
        # row of a 64-row tile); seamless-m4t-large-v2's encoder over its
        # 4096 frames, its causal decoder self-attention (head dim 64), its
        # cross-attention at prefill and at a decode step
        ("vlm_self_prefill_bf16", vb, vs, vs, vhq, vhkv, vhd, bf16, True,
         *attn.flash_tiles(bf16, (vhd, vhd), True, vs)),
        ("vlm_cross_prefill_bf16", vb, vs, vf, vhq, vhkv, vhd, bf16, False,
         *attn.flash_tiles(bf16, (vhd, vhd), False, vs)),
        ("vlm_cross_decode_bf16", vb, 1, vf, vhq, vhkv, vhd, bf16, False,
         *attn.flash_tiles(bf16, (vhd, vhd), False, 1)),
        ("encdec_encoder_bf16", eb, ef, ef, eh, eh, ehd, bf16, False,
         *attn.flash_tiles(bf16, (ehd, ehd), False, ef)),
        ("encdec_self_prefill_bf16", eb, es, es, eh, eh, ehd, bf16, True,
         *attn.flash_tiles(bf16, (ehd, ehd), True, es)),
        ("encdec_cross_prefill_bf16", eb, es, ef, eh, eh, ehd, bf16, False,
         *attn.flash_tiles(bf16, (ehd, ehd), False, es)),
        ("encdec_cross_decode_bf16", eb, 1, ef, eh, eh, ehd, bf16, False,
         *attn.flash_tiles(bf16, (ehd, ehd), False, 1)),
    ]
    rows = []
    for name, B, Sq, Skv, Hq, Hkv, D, dt, causal, bq, bk in cases:
        D, Dv = (D, D) if isinstance(D, int) else D
        q = rnd((B, Sq, Hq, D), dt)
        k = rnd((B, Skv, Hkv, D), dt)
        v = rnd((B, Skv, Hkv, Dv), dt)
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
               "v": list(v.shape), "head_dims": [D, Dv],
               "dtype": str(dt).replace("torch.", ""), "causal": causal,
               "blocks": [bq, bk], "max_abs_err": err,
               "share_of_limit": share, "tolerance": flash_tolerance(dt)}
        if name in TIMED_FLASH_CASES:
            bound, by, flops, byts = flash_bound_ms(
                B, Hq, Hkv, Sq, Skv, D, q.element_size(), causal, Dv)
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
            del qt, kt, vt
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
                    if fa.unsupported(q.element_size(), D, Dv, tq, tk):
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
    def entry(name, dt, main, mine, source, what):
        return {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:60",
            "shape": f"q {main['q']}, k {main['kv']}, v {main['v']} "
                     f"{main['dtype']}, "
                     f"{'causal' if main['causal'] else 'non-causal'}, "
                     f"blocks {main['blocks']} " + what,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "share_of_limit": max(r["share_of_limit"] for r in mine),
            "tolerance": f"{flash_tolerance(dt)} against the plain version"
                         + (" (p rounded to bf16 for p.v, as in the kernel)"
                            if dt == bf16 else ""),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": library,
            "timing": timing}

    entries = []
    other_dims = (list(MLA_HEAD_DIMS), list(RG_HEAD_DIMS))
    cross_cases = {case for _, case, _, _ in CROSS_FLASH_ROWS}
    for name, dt, dims, source, what in (
            ("flash_attention", bf16, None, "flash_attention_sm90.cu",
             "(the served model's prefill)"),
            ("flash_attention_192x128", bf16, MLA_HEAD_DIMS,
             "flash_attention_sm90.cu",
             "(deepseek-v3-671b's MLA prefill, q/k head dim 192, v 128)"),
            ("flash_attention_256x256", bf16, RG_HEAD_DIMS,
             "flash_attention_sm90.cu",
             "(recurrentgemma-2b's local-attention prefill as served, "
             "head dim 256)"),
            ("flash_attention_f32", f32, None, "flash_attention.cu",
             "(the tuning space's shape, the model's f32 tiles)")):
        mine = [r for r in rows
                if r["dtype"] == str(dt).replace("torch.", "")
                and r["case"] not in cross_cases
                and (r["head_dims"] == list(dims) if dims
                     else r["head_dims"] not in other_dims)]
        main = next(r for r in mine if "ms" in r)
        e = entry(name, dt, main, mine, source, what)
        if dt == f32:
            e.update(
                bound="max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s): "
                      "the products run as 3xTF32 on the tensor cores",
                ms_best_tile=min(main["ms_by_tile"].values()))
        entries.append(e)
    # the calls of the VLM and enc-dec paths, one row each
    for name, case, _, what in CROSS_FLASH_ROWS:
        main = next(r for r in rows if r["case"] == case)
        entries.append(entry(name, bf16, main, [main],
                             "flash_attention_sm90.cu", what))
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


def serve_config(sizes: dict, arch: str, cuts=None, why: str = ""):
    """``arch``'s config at full width, with ``cuts`` (config fields cut to
    fit one card) applied; the CPU rehearsal takes its reduced config in
    f32. Returns (config, the ``reduced`` record of the cuts)."""
    import dataclasses

    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = dataclasses.replace(full, **(cuts or {}))
    reduced = {k: [getattr(full, k), v] for k, v in (cuts or {}).items()}
    if reduced:
        reduced["why"] = why
    if sizes["serve_reduced"]:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        reduced["rehearsal"] = "the config's reduced() in f32"
    return cfg, reduced


def serve_path(device, sizes: dict, cfg, reduced=None,
               sampled: bool = True):
    """The serving path of ``cfg`` (all widths as published); returns the
    report, the flash launches of generate() and serve(), those of the
    sampled generate, and the parameters (for the end-to-end check).
    ``sampled`` adds the lock-step route's sampled generate()."""
    import numpy as np

    import repro_torch.core.hardware as hw
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.power import EnergySession
    from repro_torch.serving import (ContinuousEngine, Request, ServeEngine,
                                     poisson_arrivals, serve)
    from repro_torch.tree import tree_leaves
    rt = Runtime(tp=1, moe_impl="local")
    max_len, new = sizes["serve_max_len"], sizes["serve_new_tokens"]
    lo, hi = sizes["serve_prompt_lens"]
    report = {"arch": cfg.name, "dtype": cfg.dtype, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
              "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "max_len": max_len, "new_tokens": new}
    if cfg.family == "moe":
        report["experts"] = [cfg.n_experts, cfg.experts_per_token,
                             cfg.n_shared_experts]
    if cfg.use_mla:
        report["mla"] = {"q_lora_rank": cfg.q_lora_rank,
                         "kv_lora_rank": cfg.kv_lora_rank,
                         "qk_head_dim": cfg.qk_nope_dim + cfg.qk_rope_dim,
                         "v_head_dim": cfg.v_head_dim}
    if reduced:
        report["reduced"] = reduced
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, rt, gen, device=device)
    _sync(device)
    report["init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
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
    counts = dict(ops.launch_counts(),
                  flash_by_head_dims=ops.flash_launches_by_head_dims())
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
    report["flash_launches"] = counts["flash_attention"]
    report["flash_launches_by_head_dims"] = counts["flash_by_head_dims"]
    if device.type == "cuda":
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for what, x in (("prefill ms", prefill_s), ("decode ms/step",
                                                    decode_s),
                        ("peak memory", report["peak_memory_gb"]),
                        ("flash launches", counts["flash_attention"])):
            check(x > 0, f"{cfg.name}: {what} is {x}")
    del ceng, pfs
    if not sampled:
        return report, counts, 0, params

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
    return report, counts, sampled_launches, params


def moe_local_vs_dense(device, sizes: dict, cfg, params) -> dict:
    """The MoE local path (sort-scatter into capacity buffers) against the
    dense oracle on the card: DBRX layer 0's MoE weights cast to f32, on
    MOE_CHECK_TOKENS tokens, within the reference test's 2e-4. The routing
    each path used is taken from inside its call and must be equal; a token
    with a pair past its expert's capacity is dropped by the local path
    alone (the oracle has no capacity), so the comparison takes the tokens
    none of whose pairs was dropped, and reports the drops."""
    from repro_torch.models import moe
    p = params["layers"][0]["mlp"]
    p32 = {"router": p["router"].float(),
           "experts": {k: w.float() for k, w in p["experts"].items()}}
    g = torch.Generator(device=device)
    g.manual_seed(21)
    T, k = MOE_CHECK_TOKENS, cfg.experts_per_token
    x = torch.randn((1, T, cfg.d_model), generator=g, device=device)
    used, route = [], moe._route

    def recorded(router_w, xt, k):
        out = route(router_w, xt, k)
        used.append(out[1])
        return out

    with patched(moe, "_route", recorded):
        y_local, aux_l = moe.moe_block_local(p32, cfg, x)
        y_dense, aux_d = moe.moe_block_dense(p32, cfg, x)
    order, _, pos = moe._dispatch_indices(used[0])
    capacity = moe._capacity(T, cfg)
    dropped = torch.zeros(T, dtype=torch.bool, device=device)
    dropped[(order[pos >= capacity] // k).long()] = True
    keep = ~dropped
    diff = (y_local[0] - y_dense[0]).abs()[keep]
    limit = MOE_TOL + MOE_TOL * y_dense[0].abs()[keep]
    share = float((diff / limit).max()) if bool(keep.any()) else 0.0
    out = {"arch": cfg.name, "layer": 0, "dtype": "float32",
           "tokens": T, "experts": [cfg.n_experts, k], "capacity": capacity,
           "routing_equal": len(used) == 2 and bool(torch.equal(*used)),
           "pairs_dropped": int((pos >= capacity).sum()),
           "tokens_compared": int(keep.sum()),
           "max_abs_err": float(diff.max()) if bool(keep.any()) else 0.0,
           "share_of_limit": share,
           "aux_local": float(aux_l), "aux_dense": float(aux_d),
           "output_max_abs": float(y_dense.abs().max()),
           "tolerance": f"|err| <= {MOE_TOL} + {MOE_TOL} * |dense|"}
    check(out["routing_equal"] and out["tokens_compared"] > 0
          and share <= 1.0 and abs(out["aux_local"] - out["aux_dense"])
          <= 1e-5 * max(1.0, abs(out["aux_dense"])),
          f"the MoE local path differs from the dense oracle: {out}")
    del p32
    return out


def end_to_end_check(device, cfg, params, sizes: dict,
                     extra=None) -> dict:
    """One prompt through prefill + greedy decode on both attention routes.
    Both routes decode alike; they differ in prefill attention, kernel or
    plain. Tokens must agree at every step whose plain-route top-2 margin
    exceeds the routes' logit difference, up to the first step where it
    does not (after that the two contexts may part).

    An MoE model's top-k routing turns a last-bit difference into another
    expert for the token (a near tie between the k-th and the next expert),
    which moves the logits by more than the top-2 margin, so its tokens may
    part at once. For it the prefill's routing is compared too, layer by
    layer: the share of tokens whose expert set is that of the kernel
    route. Layer 0's router reads the prefill attention's output directly;
    its share is read on three routes that compute the same attention (the
    plain route, the plain route with p rounded as in the kernel, the
    kernel route again), each of which must reach MOE_ROUTING_AGREEMENT,
    and on the card on the kernel route broken on purpose (its softmax
    scale times MOE_BROKEN_SCALE), which must not.

    A hybrid model (recurrentgemma-2b) with random weights echoes its
    input: the tied embeddings, scaled by sqrt(d_model), dominate the
    residual stream, so the top-2 margin among 256,000 logits is about one
    bf16 step, the routes' difference, and its tokens may not be compared
    at all. For it the first local-attention layer's output is compared
    (layer 2: its input comes out of two RG-LRU layers that both routes
    compute alike): on the kernel route and a second kernel run it must
    lie within the flash tolerance of the plain route's with p rounded as
    in the kernel (as check_flash holds the kernel), and on the card on the
    kernel route with its softmax scale times MOE_BROKEN_SCALE it must not.
    Its share of the limit against the plain route with p in f32 is
    reported: rounding p alone moves an output near 0 by about 2**-9 of
    |v|, close to the limit's 2e-3.

    ``extra`` joins the prefill's batch: a VLM's or enc-dec's frontend for
    the prompt."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode as decode_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Runtime
    rng = np.random.default_rng(7)
    S, steps = sizes["e2e_prompt_len"], sizes["e2e_steps"]
    V = cfg.vocab_size
    toks = torch.from_numpy(rng.integers(0, V, (1, S), dtype=np.int32)).to(
        device)
    route, chunked = moe_mod._route, attn_mod.chunked_attention

    def prefill(impl, max_len):
        """prefill's logits and state, and each MoE layer's expert sets or
        a hybrid's first attention layer's output"""
        routes, attn_out = [], []

        def recorded(router_w, x, k):
            out = route(router_w, x, k)
            routes.append(torch.sort(out[1], dim=-1).values)
            return out

        def first_attention(*args, **kw):
            out = chunked(*args, **kw)
            if not attn_out:
                attn_out.append(out)
            return out

        hybrid = cfg.family == "hybrid"
        with patched(moe_mod, "_route", recorded), \
                (patched(attn_mod, "chunked_attention", first_attention)
                 if hybrid else contextlib.nullcontext()):
            logits, state = decode_mod.prefill(
                cfg, Runtime(attn_impl=impl), params,
                {"tokens": toks, **(extra or {})}, max_len)
        return logits, state, (attn_out if hybrid else routes)

    runs, routes = {}, {}
    for impl in ("kernel", "plain"):
        rt = Runtime(attn_impl=impl)
        logits, state, routes[impl] = prefill(impl, S + steps)
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
    out = {}
    if cfg.family in ("moe", "hybrid"):
        kernel_op = ops.flash_attention_op

        def wrong_scale(q, k, v, *, scale, **kw):
            return kernel_op(q, k, v, scale=scale * MOE_BROKEN_SCALE, **kw)

        witnesses = {
            "plain_round_p": ("plain", (fa, "flash_attention_plain",
                                        functools.partial(
                                            fa.flash_attention_plain,
                                            round_p=True))),
            "kernel_again": ("kernel", None),
            "kernel_wrong_scale": ("kernel", (ops, "flash_attention_op",
                                              wrong_scale))}
        for name, (impl, patch) in witnesses.items():
            with patched(*patch) if patch else contextlib.nullcontext():
                _, state, routes[name] = prefill(impl, S + 1)
            del state
    if cfg.family == "hybrid":
        rounded = routes["plain_round_p"][0]
        shares = {name: flash_error(routes[name][0], rounded)[1]
                  for name in ("kernel", "kernel_again",
                               "kernel_wrong_scale")}
        out["first_attention_layer_share_of_limit"] = shares
        out["first_attention_layer_tolerance"] = (
            f"{flash_tolerance(rounded.dtype)} against the plain route "
            f"with p rounded as in the kernel")
        out["first_attention_layer_share_of_limit_unrounded_plain"] = {
            name: flash_error(routes[name][0], routes["plain"][0])[1]
            for name in ("kernel", "plain_round_p")}
        out["broken_softmax_scale_factor"] = MOE_BROKEN_SCALE
        same = ("kernel", "kernel_again")
        check(all(shares[n] <= 1.0 for n in same)
              and (device.type != "cuda"
                   or shares["kernel_wrong_scale"] > 1.0),
              f"{cfg.name}: the first attention layer's output on {same} "
              f"is not within the flash tolerance of the plain route's "
              f"with p rounded, or the broken kernel's is: {shares}")
    if cfg.family == "moe":
        agree = {name: [float((a == b).all(dim=-1).float().mean())
                        for a, b in zip(routes["kernel"], r)]
                 for name, r in routes.items() if name != "kernel"}
        out["prefill_routing_agreement_by_layer"] = agree["plain"]
        out["layer0_routing_agreement"] = {n: a[0] for n, a in agree.items()}
        out["broken_softmax_scale_factor"] = MOE_BROKEN_SCALE
        same = ("plain", "plain_round_p", "kernel_again")
        check(all(len(a) == cfg.n_layers for a in agree.values())
              and all(agree[n][0] >= MOE_ROUTING_AGREEMENT for n in same)
              and (device.type != "cuda" or agree["kernel_wrong_scale"][0]
                   < MOE_ROUTING_AGREEMENT),
              f"{cfg.name}: layer 0 routes {out['layer0_routing_agreement']}"
              f" of the prompt's tokens as the kernel route does: at least "
              f"{MOE_ROUTING_AGREEMENT} needed on {same}, less on the "
              f"broken kernel")
    return {"prompt_len": S, "steps": steps, **out,
            "prefill_logits_max_abs_diff": diffs[0],
            "step_logit_diffs": diffs, "plain_top2_margins": margins,
            "tokens_compared": compared, "kernel_tokens": tk,
            "plain_tokens": tp}


# ------------------------------------------------------- recurrent models
def recurrent_scan_check(device, sizes: dict) -> dict:
    """The chunked SSD (mamba2-2.7b) and the doubling RG-LRU scan
    (recurrentgemma-2b) against their one-token decode steps on the card:
    one block of each at full width in f32 with the model's initial
    parameters, 2 sequences of ``scan_len`` tokens (SSD: scan_len / 128
    chunks), the forward's outputs and final (h, conv) against those of
    scan_len decode steps from a zero cache, within :data:`SCAN_TOL`; the
    SSD block once more with dt in Mamba2's trained range
    (:data:`SSD_TRAINED_DT`), where the state carried across chunks holds
    weight (``chunk_decay``: exp of a chunk's summed log decay, by head and
    chunk, for each draw). Both serving routes run the same forward forms,
    so only this holds them against the plain recurrence."""
    import dataclasses

    from repro_torch.models import rglru, ssm
    from repro_torch.models.common import ParamMaker, softplus
    S = sizes["scan_len"]
    atol, rtol = SCAN_TOL
    g = torch.Generator(device=device)
    g.manual_seed(31)
    out = {"dtype": "float32", "batch": 2, "seq": S,
           "tolerance": f"|err| <= {atol} + {rtol} * |step|"}
    ssd = (ssm.ssm_params, ssm.ssd_forward, ssm.init_ssm_cache,
           ssm.ssd_decode_step)
    for key, arch, block, leaves, (params_fn, fwd, init, step) in (
            ("mamba2-2.7b", "mamba2-2.7b", "ssd", {}, ssd),
            ("mamba2-2.7b_trained_dt", "mamba2-2.7b", "ssd", SSD_TRAINED_DT,
             ssd),
            ("recurrentgemma-2b", "recurrentgemma-2b", "rglru", {},
             (rglru.rglru_params, rglru.rglru_forward,
              rglru.init_rglru_cache, rglru.rglru_decode_step))):
        cfg = dataclasses.replace(serve_config(sizes, arch)[0],
                                  dtype="float32")
        p = params_fn(ParamMaker(g, "float32", device), block, cfg)
        for name, value in leaves.items():
            p[name].fill_(value)
        u = torch.randn((2, S, cfg.d_model), generator=g, device=device)
        t0 = time.perf_counter()
        want, (h, tail) = fwd(p, cfg, u, return_state=True)
        _sync(device)
        fwd_s = time.perf_counter() - t0
        cache = init(cfg, 2, device=device)
        t0 = time.perf_counter()
        steps = torch.cat([step(p, cfg, u[:, t:t + 1], cache)[0]
                           for t in range(S)], dim=1)
        _sync(device)
        step_s = time.perf_counter() - t0
        errs, shares = {}, {}
        for name, a, b in (("output", want, steps), ("h", h, cache["h"]),
                           ("conv", tail, cache["conv"])):
            diff = (a - b).abs()
            errs[name] = float(diff.max())
            shares[name] = float((diff / (atol + rtol * b.abs())).max())
        row = out[key] = {"block": block, "d_model": cfg.d_model,
                          "leaves_set": leaves,
                          "max_abs_err": errs, "share_of_limit": shares,
                          "output_max_abs": float(steps.abs().max()),
                          "state_max_abs": float(cache["h"].abs().max()),
                          "forward_s": fwd_s, "decode_steps_s": step_s}
        if block == "ssd":
            n = S // ssm.CHUNK if S % ssm.CHUNK == 0 else 1
            H = ssm.ssm_dims(cfg)[1]
            dt = softplus((u @ p["w_in"][:, -H:]) + p["dt_bias"])
            seg = (dt * -torch.exp(p["A_log"])).reshape(2, n, -1, H).sum(2)
            decay = torch.exp(seg)
            row.update(chunks=n, chunk_decay={
                "min": float(decay.min()), "median": float(decay.median()),
                "max": float(decay.max())})
        check(all(v <= 1.0 for v in shares.values()),
              f"{key}: the {block} forward differs from {S} decode steps: "
              f"{errs}, {shares} of the limit {out['tolerance']}")
        del p, u, want, steps, cache
    return out


def serve_recurrent(device, sizes: dict, arch: str):
    """A recurrent model (``mamba2-2.7b``, ``recurrentgemma-2b``) at full
    width and depth in bf16, random weights from a seeded generator:
    ServeEngine.generate on REC_REQUESTS greedy requests of one length
    (``rec_prompt_len``; the recurrent state folds pads, so ragged prompts
    would mean something else), which takes the lock-step route, its flash
    launches counted from just before to just after; then the prefill of
    the same batch and decode steps, timed alone. Returns the report, the
    launch counts of generate(), the parameters and the config."""
    import numpy as np

    import repro_torch.core.hardware as hw
    from repro_torch.kernels import ops
    from repro_torch.models import decode as decode_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import Runtime
    from repro_torch.power import EnergySession
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.tree import tree_leaves
    cfg, reduced = serve_config(sizes, arch)
    rt = Runtime(tp=1)
    S, new = sizes["rec_prompt_len"], sizes["serve_new_tokens"]
    max_len, B = sizes["serve_max_len"], REC_REQUESTS
    report = {"arch": cfg.name, "dtype": cfg.dtype, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "reduced": reduced,
              "requests": B, "prompt_len": S, "max_len": max_len,
              "new_tokens": new, "route": "lock-step (generate_blocking)"}
    if cfg.family == "ssm":
        d_in, H, hd, ds = ssm.ssm_dims(cfg)
        report["ssm"] = {"d_inner": d_in, "heads": H, "head_dim": hd,
                         "state": ds, "chunk": ssm.CHUNK,
                         "chunks": S // ssm.CHUNK if S % ssm.CHUNK == 0
                         else 1}
    else:
        kinds = tfm.hybrid_kinds(cfg)
        report["hybrid"] = {
            "pattern": list(cfg.block_pattern), "lru_width": cfg.lru_width,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
            "d_ff": cfg.d_ff, "local_window": cfg.local_window,
            "attention_layers": kinds.count("attn")}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, rt, gen, device=device)
    _sync(device)
    report["init_s"] = time.perf_counter() - t0
    report["params"] = sum(t.numel() for t in tree_leaves(params))
    report["param_count_config"] = cfg.param_count()
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, V, S, dtype=np.int32),
                    max_new_tokens=new) for _ in range(B)]
    sess = EnergySession(policy="energy-aware", chip=hw.H100_SXM,
                         device=device)
    engine = ServeEngine(cfg, rt, params, max_len=max_len, session=sess)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    _sync(device)
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts(),
                  flash_by_head_dims=ops.flash_launches_by_head_dims())
    report["generate"] = {"wall_s": wall, "tokens_per_s": B * new / wall,
                          "tokens": [o.tolist()[:8] for o in outs],
                          "session": sess.summary()}
    check(all(o.shape == (new,) and o.min() >= 0 and o.max() < V
              for o in outs), f"{arch}: generate returned malformed tokens")
    del engine

    # -- the prefill of the same batch, then decode steps, timed alone ----
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(device)
    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        logits, state = decode_mod.prefill(cfg, rt, params,
                                           {"tokens": tokens}, max_len)
        _sync(device)
        times.append(time.perf_counter() - t0)
    prefill_s = statistics.median(times)
    tok = torch.argmax(logits[:, 0, :V], dim=-1).to(torch.int32)[:, None]
    n_steps = sizes["serve_decode_steps"]

    def step(i):
        return decode_mod.decode_step(
            cfg, rt, params, tok,
            torch.tensor(S + i, dtype=torch.int32, device=device), state)[0]
    step(0)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(1, n_steps + 1):
        logits = step(i)
    _sync(device)
    decode_s = (time.perf_counter() - t0) / n_steps
    check(bool(torch.isfinite(logits).all()),
          f"{arch}: decode gave non-finite logits")
    report["timing"] = {
        "prefill_tokens": B * S, "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": B * S / prefill_s, "decode_batch": B,
        "decode_ms_per_step": decode_s * 1e3,
        "decode_tokens_per_s": B / decode_s}
    report["flash_launches"] = counts["flash_attention"]
    report["flash_launches_by_head_dims"] = counts["flash_by_head_dims"]
    if device.type == "cuda":
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for what, x in (("prefill ms", prefill_s),
                        ("decode ms/step", decode_s),
                        ("generate tokens/s", report["generate"]
                         ["tokens_per_s"]),
                        ("peak memory", report["peak_memory_gb"])):
            check(x > 0, f"{arch}: {what} is {x}")
    del state, logits
    return report, counts, params, cfg


# ------------------------------------------------------ VLM and enc-dec
def draw_frontend(cfg, batch: int, generator, device) -> torch.Tensor:
    """A frontend ``[batch, frontend_seq, d_model]`` in the config's dtype:
    standard normal times :data:`FRONTEND_SCALE`, drawn on ``device``."""
    from repro_torch.models.common import torch_dtype
    x = torch.randn((batch, cfg.frontend_seq, cfg.d_model),
                    generator=generator, device=device) * FRONTEND_SCALE
    return x.to(torch_dtype(cfg.dtype))


def serve_cross(device, sizes: dict, arch: str):
    """A VLM (``llama-3.2-vision-11b``) or enc-dec
    (``seamless-m4t-large-v2``) at full width and depth in bf16, random
    weights from a seeded generator, the VLM's tanh gates drawn non-zero
    (they are zeros at init, and a VLM with them at 0 ignores its image):
    ServeEngine.generate on CROSS_REQUESTS greedy requests of one length
    with a frontend in ``extra_batch`` (the lock-step route), its flash
    launches counted from just before to just after; then the prefill of
    the same batch and decode steps, timed alone, each with its launches
    counted. Returns the report, the launch counts of generate() (by head
    dims and mask, and by call shape), the parameters and the config."""
    import numpy as np

    import repro_torch.core.hardware as hw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import decode as decode_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.power import EnergySession
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.tree import tree_leaves
    cfg, reduced = serve_config(sizes, arch)
    rt = Runtime(tp=1)
    S, max_len = sizes["cross_serve"][arch]
    new, B = sizes["serve_new_tokens"], CROSS_REQUESTS
    report = {"arch": cfg.name, "dtype": cfg.dtype, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
              "d_ff": cfg.d_ff, "act": cfg.act, "vocab": cfg.vocab_size,
              "reduced": reduced, "requests": B, "prompt_len": S,
              "max_len": max_len, "new_tokens": new,
              "route": "lock-step (generate_blocking, extra_batch)"}
    if cfg.family == "vlm":
        report["cross_attn_every"] = cfg.cross_attn_every
    else:
        report["n_encoder_layers"] = cfg.n_encoder_layers
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, rt, gen, device=device)
    if cfg.family == "vlm":
        for block in params["layers"]["cross"]:
            for name in ("gate_a", "gate_m"):
                block[name].copy_(torch.randn(block[name].shape,
                                              generator=gen, device=device))
        report["gates"] = {
            "drawn": "standard normal, each block's gate_a and gate_m (zeros "
                     "at init)",
            **{name: [float(b[name]) for b in params["layers"]["cross"]]
               for name in ("gate_a", "gate_m")}}
    fe = draw_frontend(cfg, B, gen, device)
    _sync(device)
    report["init_s"] = time.perf_counter() - t0
    report["params"] = sum(t.numel() for t in tree_leaves(params))
    report["param_count_config"] = cfg.param_count()
    report["frontend"] = {"shape": list(fe.shape), "dtype": str(fe.dtype),
                          "scale": FRONTEND_SCALE}
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, V, S, dtype=np.int32),
                    max_new_tokens=new) for _ in range(B)]
    sess = EnergySession(policy="energy-aware", chip=hw.H100_SXM,
                         device=device)
    engine = ServeEngine(cfg, rt, params, max_len=max_len, session=sess)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(reqs, extra_batch={"frontend": fe})
    _sync(device)
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts(),
                  flash_by_head_dims=ops.flash_launches_by_head_dims(),
                  flash_by_shape=dict(fa.LAUNCHES_BY_SHAPE))
    report["generate"] = {"wall_s": wall, "tokens_per_s": B * new / wall,
                          "tokens": [o.tolist()[:8] for o in outs],
                          "session": sess.summary()}
    check(all(o.shape == (new,) and o.min() >= 0 and o.max() < V
              for o in outs), f"{arch}: generate returned malformed tokens")
    del engine

    # -- the prefill of the same batch, then decode steps, timed alone, each
    #    with its flash launches counted -----------------------------------
    batch = {"tokens": torch.from_numpy(
        np.stack([r.prompt for r in reqs])).to(device), "frontend": fe}
    times = []
    ops.reset_launch_counts()
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        logits, state = decode_mod.prefill(cfg, rt, params, batch, max_len)
        _sync(device)
        times.append(time.perf_counter() - t0)
    prefill_s = statistics.median(times)
    per_prefill = {k: v / 3
                   for k, v in ops.flash_launches_by_head_dims().items()}
    tok = torch.argmax(logits[:, 0, :V], dim=-1).to(torch.int32)[:, None]
    n_steps = sizes["serve_decode_steps"]

    def step(i):
        return decode_mod.decode_step(
            cfg, rt, params, tok,
            torch.tensor(S + i, dtype=torch.int32, device=device), state)[0]
    step(0)
    _sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(1, n_steps + 1):
        logits = step(i)
    _sync(device)
    decode_s = (time.perf_counter() - t0) / n_steps
    per_step = {k: v / n_steps
                for k, v in ops.flash_launches_by_head_dims().items()}
    check(bool(torch.isfinite(logits).all()),
          f"{arch}: decode gave non-finite logits")
    report["timing"] = {
        "prefill_tokens": B * S, "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": B * S / prefill_s, "decode_batch": B,
        "decode_ms_per_step": decode_s * 1e3,
        "decode_tokens_per_s": B / decode_s}
    report["flash_launches"] = counts["flash_attention"]
    report["flash_launches_by_head_dims"] = counts["flash_by_head_dims"]
    report["flash_launches_by_shape"] = counts["flash_by_shape"]
    report["flash_launches_per_prefill"] = per_prefill
    report["flash_launches_per_decode_step"] = per_step
    if device.type == "cuda":
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for what, x in (("prefill ms", prefill_s),
                        ("decode ms/step", decode_s),
                        ("generate tokens/s", report["generate"]
                         ["tokens_per_s"]),
                        ("peak memory", report["peak_memory_gb"])):
            check(x > 0, f"{arch}: {what} is {x}")
        # a prefill: the causal self-attention once a decoder layer, the
        # non-causal calls (encoder layers, cross-attention) once each; a
        # decode step: the cross-attention alone (its self-attention reads
        # a cache of written rows, the plain route's case)
        key = f"{cfg.resolved_head_dim}x{cfg.resolved_head_dim}"
        n_cross = (cfg.n_layers // cfg.cross_attn_every
                   if cfg.family == "vlm" else cfg.n_layers)
        n_enc = cfg.n_encoder_layers if cfg.family == "encdec" else 0
        want_prefill = {key: cfg.n_layers, f"{key}/noncausal": n_enc + n_cross}
        want_step = {f"{key}/noncausal": n_cross}
        want_generate = {key: cfg.n_layers,
                         f"{key}/noncausal": n_enc + n_cross * (1 + new)}
        report["flash_launches_expected"] = {
            "per_prefill": want_prefill, "per_decode_step": want_step,
            "generate": want_generate}
        check(per_prefill == want_prefill and per_step == want_step
              and counts["flash_by_head_dims"] == want_generate,
              f"{arch}: flash launches a prefill {per_prefill}, a decode "
              f"step {per_step}, in generate "
              f"{counts['flash_by_head_dims']}; expected "
              f"{report['flash_launches_expected']}")
    del state, logits
    return report, counts, params, cfg


def cross_witness(device, cfg, params, sizes: dict) -> dict:
    """The first cross-attention layer's output of a VLM or enc-dec on the
    card, its inputs computed alike on every route: a prefill of one
    prompt with its frontend on the kernel route, where that one call (the
    first non-causal call with Sq != Skv: the VLM's first cross block,
    after cross_attn_every self layers; the enc-dec's decoder layer 0,
    after the whole encoder) takes the route under test. On the kernel
    route and a second kernel run it must lie within the flash tolerance
    of the plain route's with p rounded as in the kernel, and on the card
    on the kernel with its softmax scale times MOE_BROKEN_SCALE it must
    not. Then a second frontend through the same prompt: the prefill's
    logits must move by more than the routes' own difference (the kernel
    route against the plain one, ``routes_logit_diff``), so that the
    frontend reaches the output."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode as decode_mod
    from repro_torch.models.transformer import Runtime
    S, V = sizes["e2e_prompt_len"], cfg.vocab_size
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, V, (1, S), dtype=np.int32)).to(
        device)
    g = torch.Generator(device=device)
    g.manual_seed(9)
    frontends = [draw_frontend(cfg, 1, g, device) for _ in range(2)]
    chunked, kernel_op = attn_mod.chunked_attention, ops.flash_attention_op
    rounded_plain = functools.partial(fa.flash_attention_plain, round_p=True)

    def wrong_scale(q, k, v, *, scale, **kw):
        return kernel_op(q, k, v, scale=scale * MOE_BROKEN_SCALE, **kw)

    def run(route, frontend, impl="kernel"):
        """prefill's logits, and the first cross-attention call's output
        on ``route`` (None: every call on ``impl``)"""
        seen = []

        def witnessed(q, k, v, **kw):
            if (route is None or seen or kw.get("causal", True)
                    or q.shape[1] == k.shape[1]):
                return chunked(q, k, v, **kw)
            if route == "plain_round_p":
                with patched(fa, "flash_attention_plain", rounded_plain):
                    out = chunked(q, k, v, **{**kw, "impl": "plain"})
            elif route == "kernel_wrong_scale":
                with patched(ops, "flash_attention_op", wrong_scale):
                    out = chunked(q, k, v, **kw)
            else:
                out = chunked(q, k, v, **kw)
            seen.append(out)
            return out
        with patched(attn_mod, "chunked_attention", witnessed):
            logits, state = decode_mod.prefill(
                cfg, Runtime(attn_impl=impl), params,
                {"tokens": toks, "frontend": frontend}, S + 1)
        del state
        return logits[0, 0, :V].float(), (seen[0] if seen else None)

    outs = {name: run(name, frontends[0])[1]
            for name in ("plain_round_p", "kernel", "kernel_again",
                         "kernel_wrong_scale")}
    rounded = outs["plain_round_p"]
    shares = {name: flash_error(outs[name], rounded)[1]
              for name in ("kernel", "kernel_again", "kernel_wrong_scale")}
    kernel_logits = run(None, frontends[0])[0]
    plain_logits = run(None, frontends[0], impl="plain")[0]
    other_logits = run(None, frontends[1])[0]
    routes_diff = float((kernel_logits - plain_logits).abs().max())
    frontend_diff = float((other_logits - kernel_logits).abs().max())
    out = {"prompt_len": S, "frontend": list(frontends[0].shape),
           "first_cross_attention_output": list(rounded.shape),
           "first_cross_attention_share_of_limit": shares,
           "first_cross_attention_tolerance":
               f"{flash_tolerance(rounded.dtype)} against the plain route "
               f"with p rounded as in the kernel",
           "first_cross_attention_max_abs": float(rounded.float().abs().max()),
           "broken_softmax_scale_factor": MOE_BROKEN_SCALE,
           "routes_logit_diff": routes_diff,
           "second_frontend_logit_diff": frontend_diff,
           "logit_max_abs": float(kernel_logits.abs().max())}
    same = ("kernel", "kernel_again")
    check(all(shares[n] <= 1.0 for n in same)
          and (device.type != "cuda" or shares["kernel_wrong_scale"] > 1.0),
          f"{cfg.name}: the first cross-attention layer's output on {same} "
          f"is not within the flash tolerance of the plain route's with p "
          f"rounded, or the broken kernel's is: {shares}")
    check(frontend_diff > routes_diff,
          f"{cfg.name}: a second frontend moves the prefill's logits by "
          f"{frontend_diff}, not more than the routes' difference "
          f"{routes_diff}: the frontend does not reach the output")
    return out


# --------------------------------------------------------------- training
#: the reference training CLI's default --arch, trained at full width in
#: bf16 with f32 AdamW moments, cut in depth to fit one card
TRAIN_ARCH = "stablelm-12b"
TRAIN_CUTS = {"n_layers": 4}
TRAIN_CUT_WHY = (
    "memory: 4 layers hold ~2.14 B parameters, ~26 GB of bf16 weights and "
    "grads and f32 moments, and the out-of-place update holds a second "
    "copy; all 40 layers would need ~144 GB of one card's 80 GB")
#: the shape of the train phase: train_4k's length, its global batch of
#: 256 cut to 2 (a step's activations at full width fit one card)
TRAIN_BATCH_WHY = "memory and time: one card, a few steps"
#: the card against the host: reduced f32 configs, steps of
#: make_train_step on each from one state and the same batches
CARD_VS_HOST_ARCHS = ("stablelm-12b", "dbrx-132b")
CARD_VS_HOST_STEPS = 3
CARD_VS_HOST_RTOL = 1e-5
#: the attention backward's limits against f64 dense attention, as a share
#: of max|want|: f32 the order of sums, bf16 the output's rounding
ATTN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _dense_attention_f64(q, k, v, causal: bool, scale: float):
    """Softmax attention in f64 with the kv heads repeated: the reference
    the attention's gradients are held against."""
    G = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)


def train_attention_grad(device, sizes: dict, timer: Timer) -> dict:
    """``chunked_attention``'s gradients under autograd (the FlashAttention
    Function) on the card against autograd through dense softmax attention
    in f64 on the card, from the same inputs and output gradient: each of
    dq, dk, dv within ATTN_GRAD_TOL[dtype] * max|want|; every gradient
    nonzero (the kernel op has no backward and would cut them)."""
    from repro_torch.models import attention as attn
    cases = []
    g = torch.Generator(device=device)
    g.manual_seed(31)
    for name, (B, Sq, Skv, Hq, Hkv, D, Dv), causal, dtype in \
            sizes["train_grad_cases"]:
        dt = getattr(torch, dtype)
        q = torch.randn((B, Sq, Hq, D), generator=g, device=device).to(dt)
        k = torch.randn((B, Skv, Hkv, D), generator=g, device=device).to(dt)
        v = torch.randn((B, Skv, Hkv, Dv), generator=g,
                        device=device).to(dt)
        dout = torch.randn((B, Sq, Hq, Dv), generator=g,
                           device=device).to(dt)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def run():
            out = attn.chunked_attention(*leaves, causal=causal)
            return out, torch.autograd.grad(out, leaves, dout)
        out, got = run()
        ms = timer(lambda: run(), reps=3)
        ref = [t.detach().double().requires_grad_() for t in (q, k, v)]
        want_out = _dense_attention_f64(*ref, causal, D ** -0.5)
        want = torch.autograd.grad(want_out, ref, dout.double())
        tol = ATTN_GRAD_TOL[dt]
        shares = {}
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dt, f"{name}: {n} came back in {a.dtype}")
            shares[n] = float((a.double() - b).abs().max()
                              / (tol * b.abs().max()))
        row = {"case": name, "dtype": dtype, "causal": causal,
               "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D, Dv],
               "grad_fn": type(out.grad_fn).__name__,
               "share_of_limit": shares,
               "worst_share": max(shares.values()),
               "min_abs_grad_max": min(float(a.abs().max()) for a in got),
               "fwd_bwd_ms": ms,
               "tolerance": f"|err| <= {tol} * max|want| (f64 dense)"}
        cases.append(row)
        del q, k, v, dout, leaves, ref, want, got, out, want_out
    out = {"cases": cases}
    check(all(r["worst_share"] <= 1.0 and r["min_abs_grad_max"] > 0
              and r["grad_fn"] == "FlashAttentionBackward" for r in cases),
          f"the attention's gradients on the card are off: {out}")
    return out


def _train_states(cfg, device, seed: int):
    """(state on the host, the same state on ``device``): the port's
    initial parameters drawn on the host, zero f32 moments."""
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_map
    g = torch.Generator()
    g.manual_seed(seed)
    params = model_mod.init_params(cfg, Runtime(), g, device="cpu")
    host = {"params": params, "opt": init_opt_state(params)}
    return host, tree_map(lambda t: t.to(device), host)


def train_card_vs_host(device, sizes: dict) -> dict:
    """Reduced f32 configs: CARD_VS_HOST_STEPS steps of make_train_step on
    the card and on CPU tensors, from one state and the same batches:
    losses within rtol CARD_VS_HOST_RTOL, every parameter within
    ``CARD_VS_HOST_RTOL * max|p|``. Then the reference's restart
    equivalence on the card: 4 steps straight against 2 steps, a new
    Trainer restored from disk (under build/), then 2 more; the last
    losses within 1e-6."""
    import dataclasses
    import shutil

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves_with_paths
    shape = SHAPES_BY_NAME["train_4k"].reduced()
    rows = []
    for arch in CARD_VS_HOST_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        host, card = _train_states(cfg, device, seed=41)
        step = make_train_step(cfg, Runtime(), OptConfig())
        losses = {"card": [], "host": []}
        for i in range(CARD_VS_HOST_STEPS):
            batch = {k: torch.from_numpy(v)
                     for k, v in make_batch(cfg, shape, i).items()}
            card, m_card = step(card, {k: v.to(device)
                                       for k, v in batch.items()})
            host, m_host = step(host, batch)
            losses["card"].append(float(m_card["loss"]))
            losses["host"].append(float(m_host["loss"]))
        worst, worst_leaf = 0.0, ""
        for (path, a), (_, b) in zip(leaves_with_paths(host["params"]),
                                     leaves_with_paths(card["params"])):
            lim = CARD_VS_HOST_RTOL * float(a.abs().max()) + 1e-30
            share = float((b.cpu() - a).abs().max()) / lim
            if share >= worst:
                worst, worst_leaf = share, path
        loss_rel = max(abs(c - h) / abs(h) for c, h in
                       zip(losses["card"], losses["host"]))
        rows.append({"arch": arch, "config": "reduced() in f32",
                     "steps": CARD_VS_HOST_STEPS, "losses": losses,
                     "max_loss_rel_diff": loss_rel,
                     "params_worst_share_of_limit": worst,
                     "params_worst_leaf": worst_leaf})
        del host, card
    ckpt = os.path.join(HERE, "build", "train_restart")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              dtype="float32")

    def trainer(steps, ckpt_dir):
        return Trainer(cfg, shape, Runtime(), tcfg=TrainConfig(
            steps=steps, ckpt_dir=ckpt_dir, ckpt_interval=2,
            log_every=1000), device=device)
    full = trainer(4, None).run()
    trainer(2, ckpt).run()
    resumed = trainer(4, ckpt)
    part = resumed.run()
    shutil.rmtree(ckpt, ignore_errors=True)
    restart = {"arch": TRAIN_ARCH, "config": "reduced() in f32",
               "straight": full["losses"], "resumed": part["losses"],
               "start_step": resumed.start_step,
               "last_loss_abs_diff": abs(full["losses"][-1]
                                         - part["losses"][-1]),
               "checkpoints": "build/train_restart (removed after)"}
    out = {"card_vs_host": rows, "restart": restart,
           "tolerance": f"losses rtol {CARD_VS_HOST_RTOL}, parameters "
                        f"{CARD_VS_HOST_RTOL} * max|p| a leaf; restart "
                        f"1e-6 on the last loss"}
    check(all(r["max_loss_rel_diff"] <= CARD_VS_HOST_RTOL
              and r["params_worst_share_of_limit"] <= 1.0 for r in rows)
          and restart["start_step"] == 2
          and restart["last_loss_abs_diff"] <= 1e-6 * max(
              1.0, abs(full["losses"][-1])),
          f"training on the card differs from the host or from itself "
          f"after a restart: {out}")
    return out


def train_phase(device, sizes: dict, timer: Timer) -> dict:
    """``Trainer.run()`` of TRAIN_ARCH at full width in bf16 (f32 AdamW
    moments), cut to TRAIN_CUTS, at train_4k's length and a batch cut to
    ``sizes["train_batch"]``, energy-aware, no checkpoints: each step's ms,
    tokens/s over the steps after the first, peak memory, the session's
    energy and the losses. Then, on the trained state: one forward and
    backward of the loss alone, and one attention forward and backward at
    the step's shape, timed, for where the step's time goes."""
    import dataclasses

    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import attention as attn
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import OptConfig
    from repro_torch.tree import tree_leaves, tree_map
    cfg, reduced = serve_config(sizes, TRAIN_ARCH, TRAIN_CUTS, TRAIN_CUT_WHY)
    shape = SHAPES_BY_NAME["train_4k"]
    B = sizes["train_batch"]
    S = shape.seq_len if not sizes["serve_reduced"] else \
        shape.reduced().seq_len
    reduced["global_batch"] = [shape.global_batch, B]
    reduced["global_batch_why"] = TRAIN_BATCH_WHY
    shape = dataclasses.replace(shape, seq_len=S, global_batch=B)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = Trainer(cfg, shape, Runtime(), opt_cfg=OptConfig(),
                tcfg=TrainConfig(steps=sizes["train_steps"],
                                 policy="energy-aware", log_every=1000),
                device=device)
    t0 = time.perf_counter()
    out = t.run()
    wall = time.perf_counter() - t0
    step_ms = [h["wall_s"] * 1e3 for h in t.history]
    n_params = sum(p.numel() for p in tree_leaves(t.state["params"]))
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if device.type == "cuda" else None)
    # where the step's time goes: the loss's forward and backward alone,
    # and one attention layer's forward and backward at the step's shape
    batch = t._device_batch(0)

    def fwd_bwd():
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          t.state["params"])
        loss, _ = model_mod.loss_fn(cfg, Runtime(), params, batch)
        torch.autograd.grad(loss, tree_leaves(params))
    fwd_bwd_ms = timer(fwd_bwd, reps=2)
    hd = cfg.resolved_head_dim
    g = torch.Generator(device=device)
    g.manual_seed(51)
    dt = t.state["params"]["emb"].dtype
    q = torch.randn((B, S, cfg.n_heads, hd), generator=g, device=device,
                    dtype=dt).requires_grad_()
    k, v = (torch.randn((B, S, cfg.n_kv_heads, hd), generator=g,
                        device=device, dtype=dt).requires_grad_()
            for _ in range(2))

    def attention():
        o = attn.chunked_attention(q, k, v)
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    attn_ms = timer(attention, reps=2)
    del q, k, v
    med = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    tokens = B * S
    report = {"arch": cfg.name, "dtype": cfg.dtype, "reduced": reduced,
              "width": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                        "n_kv_heads": cfg.n_kv_heads, "head_dim": hd,
                        "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab(1),
                        "n_layers": cfg.n_layers},
              "params": n_params, "moments": "float32",
              "shape": {"seq_len": S, "global_batch": B},
              "steps": sizes["train_steps"], "policy": "energy-aware",
              "step_ms": step_ms,
              "tokens_per_s_after_first": (
                  tokens * (len(step_ms) - 1) / (sum(step_ms[1:]) / 1e3)
                  if len(step_ms) > 1 else None),
              "peak_memory_gb": peak, "energy_j": out["energy_j"],
              "losses": out["losses"], "run_wall_s": wall,
              "loss_fwd_bwd_ms": fwd_bwd_ms,
              "attention_fwd_bwd_ms_a_layer": attn_ms,
              "attention_share_of_step": attn_ms * cfg.n_layers / med,
              "optimizer_and_rest_ms": med - fwd_bwd_ms,
              "timing": "host clock around each step, synchronised; the "
                        "pieces by CUDA events, median of 2"}
    check(all(math.isfinite(x) for x in out["losses"]),
          f"the training losses are not finite: {report}")
    return report


FULL = dict(vai_elems=2 ** 28, membw_small_rows=65536,       # 32 MiB
            membw_big_rows=2 ** 21, membw_iters=64,          # 1 GiB
            fleet_rows=9408 * 8, fleet_samples=5760, jobs=1500,
            # stream / broker: shard sizes of the fleet-day fold, the job
            # stream and the replay at scale; the broker grid's and the
            # broker benchmark's job counts
            stream_shard=2 ** 22, stream_job_shard=65536,
            replay_shard=2 ** 20, replay_sizes=(2 ** 23, 2 ** 24),
            broker_jobs=1500, broker_bench_jobs=50_000,
            # flash: (batch*heads, seq, head dim) of SPACES; the served
            # model's prefill (seq, q heads, kv heads, head dim); MLA's
            # prefill (seq, heads) at head dims MLA_HEAD_DIMS
            flash_space=(4, 1024, 128), flash_model=(1024, 40, 8, 128),
            flash_ragged=1000, flash_mla=(1024, 128),
            flash_rg=(1024, 10, 1),
            serve_reduced=False,
            serve_max_len=2048, serve_new_tokens=32,
            serve_prompt_lens=(100, 1000), serve_decode_steps=16,
            e2e_prompt_len=512, e2e_steps=8,
            # the recurrent models: one prompt length (8 SSD chunks, inside
            # RecurrentGemma's 2048-token window); the scan check's length
            rec_prompt_len=1024, scan_len=512,
            # the VLM and enc-dec: (prompt length, max_len) by arch; the
            # flash kernel's calls on their paths: the VLM's (batch,
            # prompt, patches, q heads, kv heads, head dim) and the
            # enc-dec's (batch, prompt, frames, heads, head dim)
            cross_serve={"llama-3.2-vision-11b": (1024, 2048),
                         "seamless-m4t-large-v2": (256, 512)},
            flash_vlm=(4, 1024, 1600, 32, 8, 128),
            flash_encdec=(4, 256, 4096, 16, 64),
            # training: the attention backward's cases (name, (B, Sq, Skv,
            # Hq, Hkv, D, Dv), causal, dtype) at stablelm-12b's head dims,
            # the enc-dec's cross shape and MLA's head dims; the train
            # phase's global batch and steps
            train_grad_cases=(
                ("stablelm_causal_bf16", (1, 2048, 2048, 32, 8, 160, 160),
                 True, "bfloat16"),
                ("stablelm_causal_f32", (1, 2048, 2048, 32, 8, 160, 160),
                 True, "float32"),
                ("encdec_cross_noncausal_bf16", (2, 256, 1024, 16, 16, 64,
                                                 64), False, "bfloat16"),
                ("encdec_cross_noncausal_f32", (2, 256, 1024, 16, 16, 64,
                                                64), False, "float32"),
                ("mla_causal_bf16", (1, 2048, 2048, 16, 16, 192, 128), True,
                 "bfloat16"),
                ("mla_causal_f32", (1, 2048, 2048, 16, 16, 192, 128), True,
                 "float32")),
            train_batch=2, train_steps=4)
TOY = dict(vai_elems=2 ** 16, membw_small_rows=256, membw_big_rows=2048,
           membw_iters=8, fleet_rows=64, fleet_samples=300, jobs=300,
           stream_shard=2 ** 12, stream_job_shard=4096,
           replay_shard=2 ** 10, replay_sizes=(2 ** 13, 2 ** 14),
           broker_jobs=120, broker_bench_jobs=2000,
           flash_space=(2, 128, 64), flash_model=(64, 4, 2, 64),
           flash_ragged=61, flash_mla=(64, 4), flash_rg=(64, 2, 1),
           serve_reduced=True,
           serve_max_len=256, serve_new_tokens=6,
           serve_prompt_lens=(10, 100), serve_decode_steps=2,
           e2e_prompt_len=32, e2e_steps=3, rec_prompt_len=32, scan_len=256,
           cross_serve={"llama-3.2-vision-11b": (24, 64),
                        "seamless-m4t-large-v2": (24, 64)},
           flash_vlm=(2, 40, 72, 4, 2, 64), flash_encdec=(2, 24, 96, 2, 64),
           train_grad_cases=(
               ("causal_bf16", (1, 96, 96, 4, 2, 32, 32), True, "bfloat16"),
               ("cross_noncausal_f32", (2, 24, 80, 4, 4, 16, 16), False,
                "float32"),
               ("mla_causal_f32", (1, 64, 64, 4, 4, 24, 16), True,
                "float32")),
           train_batch=2, train_steps=3)


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
    from repro_torch.kernels import flash_attention as fa
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
                                                 "UTMALDG"),
                  "flash_bf16_256x256_hgmma_in_sass": (
                      "flash_fwd_sm90_kernelILi256ELi256E", "HGMMA")}
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
                                         "flash_fwd_f32_kernel"),
             flash_bf16_ptxas=ptxas_facts(build.build_log(),
                                          "flash_fwd_sm90_kernel"))
        check(bool(in_sass["flash_bf16_hgmma_in_sass"])
              and bool(in_sass["flash_bf16_utmaldg_in_sass"])
              and bool(in_sass["flash_bf16_256x256_hgmma_in_sass"]),
              f"the bf16 flash kernel shows no HGMMA or UTMALDG (or its "
              f"256x256 instantiation no HGMMA): {in_sass}")
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
    flash = check_flash(device, timer, sizes)
    kernels.extend(flash)
    emit(phase="flash_attention_check", cases=flash[0]["cases"])

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
    report, jobs_raw = main_path(device, sizes)
    counts = ops.launch_counts()
    report["vai"]["main_path_cost"] = vai_main_path_loss(
        report["vai"]["wall_ms"], vai_mod.LAUNCHES_BY_SHAPE,
        sizes["vai_elems"])
    emit(phase="main_path", **report)
    emit(phase="main_path_jobs_card_vs_host",
         **jobs_card_vs_host(jobs_raw, sizes["jobs"], jobs_raw["cal"]))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(phase="stream", **stream_phase(device, sizes, jobs_raw["table"]))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(phase="broker", **broker_phase(device, sizes))

    cfg, _ = serve_config(sizes, SERVE_ARCH)
    serve_report, serve_counts, sampled_launches, params = serve_path(
        device, sizes, cfg)
    emit(phase="serve", **serve_report)
    e2e = end_to_end_check(device, cfg, params, sizes)
    emit(phase="serve_kernel_vs_plain", **e2e)
    del params
    # the MoE models, one at a time: each path's flash launches by head
    # dims, counted from just before its generate() to just after serve()
    moe_counts = {}
    for arch, cuts, why in MOE_SERVE:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        cfg, reduced = serve_config(sizes, arch, cuts, why)
        report, moe_counts[arch], _, params = serve_path(
            device, sizes, cfg, reduced, sampled=False)
        if arch == "dbrx-132b":
            emit(phase="moe_local_vs_dense",
                 **moe_local_vs_dense(device, sizes, cfg, params))
        emit(phase="serve_moe", **report)
        emit(phase="serve_moe_kernel_vs_plain", arch=arch,
             **end_to_end_check(device, cfg, params, sizes))
        del params
    # the recurrent models, one at a time: each path's flash launches by
    # head dims, counted from just before its generate() to just after
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(phase="recurrent_scan_check", **recurrent_scan_check(device, sizes))
    rec_counts = {}
    for arch in RECURRENT_SERVE:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        report, rec_counts[arch], params, cfg = serve_recurrent(
            device, sizes, arch)
        emit(phase="serve_recurrent", **report)
        if cfg.family == "hybrid":
            rg_attn_layers = report["hybrid"]["attention_layers"]
            emit(phase="serve_recurrent_kernel_vs_plain", arch=arch,
                 **end_to_end_check(device, cfg, params, sizes))
        del params
    # the VLM and the enc-dec, one at a time: each path's flash launches by
    # head dims and mask, and by call shape, counted from just before its
    # generate() to just after
    cross_counts = {}
    for arch in CROSS_SERVE:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        report, cross_counts[arch], params, cfg = serve_cross(
            device, sizes, arch)
        emit(phase="serve_cross", **report)
        g = torch.Generator(device=device)
        g.manual_seed(8)
        e2e = end_to_end_check(device, cfg, params, sizes, extra={
            "frontend": draw_frontend(cfg, 1, g, device)})
        emit(phase="serve_cross_kernel_vs_plain", arch=arch, **e2e,
             witness=cross_witness(device, cfg, params, sizes))
        del params
    # training, one phase after another, each with the counts set to 0
    # just before it: no kernel of the port's may launch (the reference's
    # training never reaches its Pallas kernel; the flash kernel has no
    # backward)
    train_counts = {}
    for name, fn in (("train_attention_grad",
                      lambda: train_attention_grad(device, sizes, timer)),
                     ("train_card_vs_host",
                      lambda: train_card_vs_host(device, sizes)),
                     ("train", lambda: train_phase(device, sizes, timer))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ops.reset_launch_counts()
        report = fn()
        train_counts[name] = ops.launch_counts()
        emit(phase=name, **report, launches=train_counts[name])
        check(not any(train_counts[name].values()),
              f"the {name} phase launched a kernel: {train_counts[name]}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    by_dims = {arch: c["flash_by_head_dims"]
               for arch, c in {**moe_counts, **rec_counts,
                               **cross_counts}.items()}
    cases = {r["case"]: r for r in flash[0]["cases"]}

    def served_launches(arch, case):
        """the launches of ``arch``'s generate() at ``case``'s call shape"""
        r = cases[case]
        return cross_counts[arch]["flash_by_shape"].get(fa.launch_key(
            *r["head_dims"], r["causal"], r["q"][1], r["kv"][1]), 0)
    mla_key = "x".join(map(str, MLA_HEAD_DIMS))
    rg_key = "x".join(map(str, RG_HEAD_DIMS))

    launches = {"vai": counts["vai"], "membw": counts["membw"],
                "flash_attention": serve_counts["flash_attention"]
                + moe_counts["dbrx-132b"]["flash_attention"],
                "flash_attention_192x128":
                    by_dims["deepseek-v3-671b"].get(mla_key, 0),
                "flash_attention_256x256":
                    by_dims["recurrentgemma-2b"].get(rg_key, 0),
                "flash_attention_f32": tuning_launches + dispatch_f32,
                **{name: served_launches(arch, case)
                   for name, case, arch, _ in CROSS_FLASH_ROWS}}
    emit(phase="launches", **launches,
         flash_attention_sampled_generate=sampled_launches,
         flash_attention_f32_tuning=tuning_launches,
         flash_attention_f32_model_dispatch=dispatch_f32,
         flash_attention_by_path={SERVE_ARCH: serve_counts["flash_attention"],
                                  **{a: c["flash_attention"]
                                     for a, c in {**moe_counts,
                                                  **rec_counts,
                                                  **cross_counts}.items()}},
         flash_attention_by_head_dims=by_dims,
         flash_attention_by_shape={a: c["flash_by_shape"]
                                   for a, c in cross_counts.items()},
         train=train_counts)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    if device.type != "cuda":
        emit(ok=False, rehearsal=True, note="CPU rehearsal: nothing measured")
        return 3
    check(counts["vai"] > 0 and counts["membw"] > 0,
          f"the main path did not launch both of its kernels: {counts}")
    check(serve_counts["flash_attention"] > 0,
          "the serving path never launched the flash_attention kernel")
    check(by_dims["dbrx-132b"].get("128x128", 0) > 0
          and by_dims["deepseek-v3-671b"].get(mla_key, 0) > 0,
          f"the MoE serving paths did not launch the bf16 flash kernel at "
          f"128x128 (dbrx-132b) and {mla_key} (deepseek-v3-671b): {by_dims}")
    check(by_dims["recurrentgemma-2b"].get(rg_key, 0) == rg_attn_layers > 0
          and rec_counts["mamba2-2.7b"]["flash_attention"] == 0,
          f"recurrentgemma-2b's generate did not launch the bf16 flash "
          f"kernel at {rg_key} once for each of its {rg_attn_layers} "
          f"attention layers, or mamba2-2.7b launched it: {by_dims}")
    check(all(launches[name] > 0 for name, _, _, _ in CROSS_FLASH_ROWS),
          f"a call of the VLM or enc-dec path never reached the bf16 flash "
          f"kernel at the shape its kernels row was checked at: {launches}")
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
