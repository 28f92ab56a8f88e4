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
    the sharded executor (repro_torch.parallel.ShardedExecutor) on the
      card: decide_shard on its memo, warm-memo, dedup and chunked routes
      bit for bit with the plain infer + decide on the card for six
      policies over 1 M quantized samples, and within rtol 1e-12 of the
      executor on CPU tensors with equal modes; replay with and without it
      bit for bit; the Frontier day streamed through its segment sums bit
      for bit with decompose; a Study with it equal to the Study without;
      its replay times, launches a shard, stats and peak memory at 1 M and
      2**24 samples beside the plain path's, card and host
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
    the dry run and its cost model (repro_torch.launch.dryrun,
      repro_torch.core.hlo_cost / roofline): (a) stablelm-12b train_4k
      (with ZeRO-1 and with whole moments, --no-zero1), dbrx-132b
      prefill_32k, mamba2-2.7b prefill_32k and qwen2.5-14b decode_32k
      (unsplit and with --decode-cache-shard seq) on the 256-rank mesh,
      deepseek-v3-671b decode_32k on the 512-rank one, stablelm-12b
      train_4k reduced on a (2, 4) mesh with and without --seq-shard, each
      in a process of its own on a
      fake process group and meta tensors, off the card: records written,
      finite and positive, the model's flops at most 1.05x the counted; the
      split cache's record the unsplit one's less (model - 1) / model of
      its cache bytes, its dot flops equal and its collectives the
      unsplit's plus the combine's, counted by hand; the whole-moment
      record's dot flops the ZeRO-1 one's, its gradients all-reduced where
      ZeRO-1 reduce-scatters them and its moments the parameters' shards;
      the --seq-shard record's dot flops and input bytes the default's,
      its temp bytes lower, each activation all-reduce a reduce-scatter
      and an all-gather, counted by hand; (b) one more step of the training cell counted on the card and on
      meta tensors: dot flops and collective bytes equal, bytes and
      elementwise flops equal or the ops that differ named; its roofline on
      H100_SXM beside the measured step and max_memory_allocated; (c)
      qwen2.5-14b's prefill counted on the kernel and the plain attention
      route: equal outside attention, the kernel's charge its launches
      times its work at the call's shape; (d) PowerGovernor.choose on (b)'s
      profile equal to EnergyAwarePolicy's decision
    the multi-device path (repro_torch.parallel, repro_torch.launch.mesh /
      elastic) with NCCL at world 1 on a 1 x 1 mesh: (a) dbrx-132b (8 of
      40 layers) prefill through impl="ep" (the all-to-all path) and decode
      steps through ep with ep2d, against impl="local" on the same weights
      (logits within the bf16 flash limit, tokens by the margin rule, flash
      launches equal, times in turns); (b) stablelm-12b (4 of 40 layers,
      bf16) through make_train_step(rules=...) with ZeRO-1 specs, and its
      reduced config in f32 on the mesh against one device's step; (c)
      that f32 state saved, elastic_restore onto the surviving world's
      mesh, back bit for bit with the next loss equal; (d) four processes
      on the one card over gloo (a 2 x 2 mesh, dbrx-132b 2 layers): which
      collectives gloo takes on CUDA tensors, then ep prefill and ep2d
      decode in bf16 and in f32 (the same weights) against the local path
      on the card in both: the f32 mesh within a relative limit of the f32
      local path, the bf16 mesh no further from the f32 local path than a
      factor times the bf16 local path is (times host-staged, reported);
      (e) on the same four gloo processes the SSM, hybrid, VLM and enc-dec
      families split over model at full width (mamba2-2.7b 4 layers,
      recurrentgemma-2b one (rglru, rglru, attn) group, llama-3.2-vision-11b
      5 self layers and a cross block, seamless-m4t-large-v2 2 + 2 layers):
      a 512-token prefill a data row and 4 decode steps in bf16 and in f32,
      and the f32 loss forward and backward, against the local path on
      rank 0 (the same gates as (d); the loss rtol 1e-5, every gradient
      leaf within 1e-4 * max|g| and nonzero; each rank's flash launches
      by call shape equal to the local path's); (f) four more gloo
      processes as a (data=1, model=4) mesh: deepseek-v3-671b at full
      width (1 layer) with its MLA latent cache split over the sequence
      (--decode-cache-shard seq), a 512-token prefill and 4 decode steps
      (the first writes the first row of rank 1's shard; ranks 2 and 3
      hold no valid row) in bf16 and f32 against the local path (the gates
      of (d), and each rank's flash launches equal to the local path's);
      (g) the same processes as a 2 x 2 mesh: seamless-m4t-large-v2 at full
      width in f32 (2 + 2 layers), two train steps with whole moments
      (zero1=False)
      against two ZeRO-1 steps from the same weights (losses rtol 1e-5,
      every parameter leaf within 1e-5 * max|p|, the moments of each
      rank's parameter shard's shape); (h) the same processes as a 2 x 2
      mesh, dbrx-132b (2 layers in bf16, 1 in f32) with its experts split
      over model and its rows over data: a 512-token prefill a data row
      and 4 decode steps through impl="local" (the reference's capacity
      factor 1.25, global slots; the pairs it drops reported), "dense"
      and "ep" under the ep2d rules (the experts' ffn stored over data,
      gathered whole for the prefill) against the local path on rank 0
      (the gates of (d), each rank's flash launches equal to the local
      path's); then, cut in width, two ep2d train steps with whole moments
      against the same steps with the experts' ffn whole (the gates of
      (g)) and one device's losses; (i) the same processes as a 2 x 2 mesh
      under the rule seq -> model (sequence parallelism, --seq-shard):
      stablelm-12b (2 of 40 layers), dbrx-132b through impl="ep" (cut as
      (h)'s train leg) and the four families of (e), in f32: the loss and
      every gradient leaf against the same mesh without the rule and the
      local path (the gates of (e); the norms' gains, which each rank
      applies to its own rows, among the leaves), and
      seamless-m4t-large-v2's prefill (its encoder split over the frames)
      and 4 decode steps under the rule with (e)'s gates

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
#: check_flash's head-dim sweep, in f32 and bf16: (D, Dv) pairs whose
#: widths round up to every kind of head-dim class (the kernels take any
#: 1 <= D, Dv <= 256), each causal over a ragged length and non-causal
#: with Sq != Skv; in f32 also MLA's and RecurrentGemma's pairs
FLASH_SWEEP_DIMS = ((16, 16), (32, 32), (80, 80), (96, 96), (200, 200),
                    (24, 16), (128, 64))
FLASH_SWEEP_F32_DIMS = (MLA_HEAD_DIMS, RG_HEAD_DIMS)
#: bf16 head dims whose rows (40 bytes at one head) break the kernels'
#: 16-byte copy rule: the wrapper copies q, k and v into padded buffers
FLASH_PADDED_DIMS = (20, 20)
#: the head-dim classes added for any head dim, each timed at
#: ``flash_class`` (batch, tokens, heads), causal: (dtype, width)
FLASH_CLASS_ROWS = (("bf16", 32), ("bf16", 96), ("bf16", 192), ("f32", 32),
                    ("f32", 96), ("f32", 192))
#: the flash cases timed (every tile, beside the plain version and SDPA)
TIMED_FLASH_CASES = ("space_f32", "model_prefill_bf16", "mla_prefill_bf16",
                     "rg_local_prefill_served_bf16", "rg_local_prefill_bf16",
                     "vlm_self_prefill_bf16", "vlm_cross_prefill_bf16",
                     "vlm_cross_decode_bf16", "encdec_encoder_bf16",
                     "encdec_self_prefill_bf16", "encdec_cross_prefill_bf16",
                     "encdec_cross_decode_bf16", "mla_prefill_f32",
                     "rg_local_prefill_served_f32",
                     *(f"class_{w}_{dt}" for dt, w in FLASH_CLASS_ROWS))
#: check_flash's cases at head dims the kernels take since they take any
ANY_HEAD_DIM_CASES = ("sweep_", "class_", "padded_")
#: the f32 tuning spaces beside SPACES' head dim 128: (D, Dv)
TUNE_HEAD_DIMS = ((32, 32), (96, 96), (256, 256), (192, 128))
#: the models whose f32 prefill attends at head dims the f32 kernel now
#: takes, at full width: (arch, the config's cuts, why)
F32_PREFILL = (
    ("deepseek-v3-671b", {"n_layers": 2, "mtp_depth": 0, "n_experts": 32},
     "memory: in f32 a layer of 256 experts holds 46 GB; 32 experts (8 a "
     "token, as published) keep a layer at 6.6 GB, and the attention, "
     "which this run checks, is whole"),
    ("recurrentgemma-2b", {}, ""),
)
#: the reduced() config of each attention family, served in bf16 on the
#: kernel route; REDUCED_REQUESTS prompts of ``reduced_serve`` tokens
REDUCED_SERVE = ("qwen2.5-14b", "dbrx-132b", "deepseek-v3-671b",
                 "recurrentgemma-2b", "llama-3.2-vision-11b",
                 "seamless-m4t-large-v2")
REDUCED_REQUESTS = 2
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


def _report_key(rep) -> tuple:
    """Every number of a replay report, for an exact comparison."""
    return (rep.n_samples, rep.energy_rec_j, rep.energy_base_j,
            rep.energy_new_j, rep.time_rec_s, rep.time_new_s,
            sorted(rep.recorded.energy_mwh.items()),
            sorted(rep.recorded.hours_pct.items()),
            sorted(rep.replayed.energy_mwh.items()),
            sorted(rep.replayed.hours_pct.items()), _replay_rows(rep))


def _replay_worst(a, b, label: str) -> float:
    """The largest relative difference between two replays' energies and
    times, fleet and job rows; job order and counts must be equal."""
    check([r[:2] for r in _replay_rows(a)] == [r[:2] for r in
                                              _replay_rows(b)]
          and a.n_samples == b.n_samples,
          f"replay {label}: sample counts, job order or n_samples differ")
    worst = max(_rel(getattr(a, k), getattr(b, k)) for k in (
        "energy_rec_j", "energy_base_j", "energy_new_j", "time_rec_s",
        "time_new_s"))
    for ra, rb in zip(_replay_rows(a), _replay_rows(b)):
        worst = max([worst] + [_rel(x, y) for x, y in zip(ra[2:], rb[2:])])
    return worst


def stream_phase(device, sizes: dict, table) -> dict:
    """The out-of-core stream and counterfactual replay on the card: the
    Frontier-day fleet folded shard by shard against the one-shot
    decomposition (bit for bit, histogram counts exact), the job table's
    stream against its batch decomposition and job report, the replays of
    examples/streaming_replay.py against the same replays on CPU tensors,
    and replay at scale with its peak memory. Returns the report, the
    day's samples and their one-shot decomposition, which the executor
    phase reuses."""
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
        check(rep.n_samples == n_samples,
              f"replay {label}: {rep.n_samples} samples of {n_samples}")
        worst = max(worst, _replay_worst(rep, host, label))
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
    del st, fa
    return report, flat, want


# ------------------------------------------------------------- executor
#: the decision routes of the sharded executor held against the plain path
EXEC_ROUTES = ("memo", "memo_warm", "dedup", "chunked")
#: the policies of tests/test_executor.py (name, knobs)
EXEC_POLICIES = (
    ("nominal", {}),
    ("static", {"freq_mhz": 1200}),
    ("power-cap", {"cap_w": 400.0}),
    ("energy-aware", {"slowdown_budget": 0.05}),
    ("energy-aware", {"slowdown_budget": 0.03, "objective": "edp"}),
    ("energy-aware", {"slowdown_budget": 0.10,
                      "objective": "perf_per_watt", "power_cap_w": 450.0}))
#: two powers that share a memo key at 0.1 W and at 0.01 W: a shard of them
#: turns the memo off for its signature, so later shards take the dedup
#: route
EXEC_COLLISION = (100.001, 100.004, 350.25, 420.5)


def _device_launches(device, fn):
    """``fn()`` under ``torch.profiler`` (as tools/broker_profile.py): the
    kernels it launched on the device and their device ms, with its wall
    seconds; on the CPU rehearsal the wall seconds only."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, {"launches": None, "device_ms": None,
                     "wall_s": time.perf_counter() - t0}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, dev_us = 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = next((float(getattr(evt, a)) for a in (
                "self_device_time_total", "self_cuda_time_total")
                if getattr(evt, a, None) is not None), 0.0)
            if us > 0:
                launches += evt.count
                dev_us += us
    return out, {"launches": launches, "device_ms": dev_us * 1e-3,
                 "wall_s": wall}


def executor_phase(device, sizes: dict, flat, day) -> dict:
    """The sharded executor (``repro_torch.parallel.ShardedExecutor``) on
    the card: ``decide_shard`` on every route against the plain path on
    the card, bit for bit, and against the executor on CPU tensors (rtol
    STREAM_RTOL, equal modes); ``replay(executor=)`` against ``replay()``;
    the Frontier day streamed through it against ``decompose``; a Study with
    it against the same Study without; and its times, launches a shard,
    stats and peak memory beside the plain path's, card and host."""
    import numpy as np
    from repro_torch.core import modal
    from repro_torch.core.power_model import ChipModel
    from repro_torch.parallel import ShardedExecutor
    from repro_torch.power import StreamingTelemetry, Study, Workload
    from repro_torch.power.policies import decide_batch, get_policy
    from repro_torch.power.stream import SampleShard, iter_array, replay
    host = torch.device("cpu")

    def executor(dev, **kw):
        # the default device list on the card: every visible CUDA device
        return ShardedExecutor(**kw) if dev.type == "cuda" \
            else ShardedExecutor(devices=[dev], **kw)

    report = {}
    n, shard, n_jobs = (sizes["exec_trace"], sizes["exec_shard"],
                        sizes["exec_jobs"])
    # benchmarks/bench_sharded.py's trace: 0.1 W sensor steps, 100 jobs
    trace = torch.round(modal.synth_fleet_powers(
        n, seed=0, device=device) * 10.0) / 10.0
    jids = np.repeat([f"job{i:04d}" for i in range(n_jobs)], n // n_jobs)
    host_trace = trace.cpu()

    def stream(p, cols=None, size=shard):
        for a in range(0, p.numel(), size):
            b = min(a + size, p.numel())
            yield SampleShard.from_arrays(
                p[a:b], job_id=jids[a:b] if p.numel() == n else "job0",
                **{k: v[a:b] for k, v in (cols or {}).items()})

    mi = ChipModel("mi250x-gcd")

    def plain(pol, p):
        modes = modal.classify_power(p, mi.spec)
        bd = decide_batch(pol, mi.surface(p.device).infer_profiles(
            p, freq_frac=1.0, duration_s=15.0, mode_idx=modes), mi,
            device=p.device)
        return (bd.energy_j, bd.baseline_energy_j, bd.time_s, bd.mode_idx,
                modes.to(torch.int64))

    # -- decide_shard, every route, against the plain path ------------------
    collision = torch.tensor(EXEC_COLLISION, dtype=torch.float64,
                             device=device).repeat(2_000)
    starts = range(0, n, shard)
    routes = {r: {"shards": 0} for r in EXEC_ROUTES}
    worst, modes_equal = 0.0, True
    for name, knobs in EXEC_POLICIES:
        pol = get_policy(name, **knobs)
        exs = {"memo": executor(device), "dedup": executor(device),
               "chunked": executor(device, dedup=False)}
        exs["dedup"].decide_shard(pol, mi, mi, collision, None, 15.0, 1.0)
        check(list(exs["dedup"]._memo.values()) == [False],
              f"the collision trace left the memo on: {exs['dedup']._memo}")
        ex_host = executor(host)
        wants = {}

        def held(route, ex, a):
            got = ex.decide_shard(pol, mi, mi, trace[a:a + shard], None,
                                  15.0, 1.0, return_modes=True)
            check(all(torch.equal(g, w.to(g.dtype))
                      for g, w in zip(got, wants[a])),
                  f"decide_shard ({route}, {name} {knobs}) differs from "
                  f"the plain path at shard {a}")
            routes[route]["shards"] += 1
            return got

        for a in starts:
            wants[a] = plain(pol, trace[a:a + shard])
            got = [held(r, exs[r], a) for r in ("memo", "dedup", "chunked")]
            on_host = ex_host.decide_shard(
                pol, mi, mi, host_trace[a:a + shard], None, 15.0, 1.0,
                return_modes=True)
            memo = [x.cpu() for x in got[0]]
            modes_equal &= all(torch.equal(g, h) for g, h in
                               zip(memo[3:], on_host[3:]))
            for g, h in zip(memo[:3], on_host[:3]):
                worst = max(worst, float(((g - h).abs() / h.abs().clamp(
                    min=1e-300)).max()))
        # a second pass: every key is in the memo, no decision body runs
        before = dict(exs["memo"].stats)
        for a in starts:
            held("memo_warm", exs["memo"], a)
        warm = exs["memo"].stats
        check(warm["memo_hits"] - before["memo_hits"] == len(starts)
              and warm["kernel_calls"] == before["kernel_calls"]
              and exs["dedup"].stats["memo_hits"] == 0
              and exs["dedup"].stats["dedup_samples"] >= n - shard
              and exs["chunked"].stats["dedup_samples"] == 0,
              f"a route did not run as named: "
              f"{ {r: e.stats for r, e in exs.items()} }")
        for route, ex in exs.items():       # summed over the policies
            tot = routes[route].setdefault("stats", dict.fromkeys(ex.stats,
                                                                  0))
            for k, v in ex.stats.items():
                tot[k] += v
    check(modes_equal and worst <= STREAM_RTOL,
          f"decide_shard on the card differs from the host: modes equal "
          f"{modes_equal}, rtol {worst}")
    report["decide_shard"] = {
        "samples": n, "shard_samples": shard, "policies": len(EXEC_POLICIES),
        "routes": routes, "bit_for_bit_with_plain": True,
        "card_vs_host": {"max_rel_diff": worst, "rtol": STREAM_RTOL,
                         "mode_idx_equal": modes_equal}}

    # -- replay(executor=) against replay(), card and host ------------------
    replays, worst = [], 0.0
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    freq = torch.tensor([1100.0, 1400.0, 1700.0], dtype=torch.float64,
                        device=device)[torch.randint(
                            0, 3, (n,), generator=gen, device=device)]
    cols = {"mode": modal.classify_power(trace, mi.spec), "freq_mhz": freq}
    cases = [(f"{name} {knobs}", name, dict(chip="mi250x-gcd", **knobs),
              None) for name, knobs in EXEC_POLICIES]
    cases.append(("energy-aware on tpu-v5e, mode + freq_mhz columns",
                  "energy-aware", dict(chip="tpu-v5e",
                                       record_chip="mi250x-gcd",
                                       slowdown_budget=0.05), cols))
    for label, name, kw, c in cases:
        ex = executor(device)
        a, t_plain = _measured(device, lambda: replay(stream(trace, c), name,
                                                      **kw))
        b, t_ex = _measured(device, lambda: replay(stream(trace, c), name,
                                                   executor=ex, **kw))
        check(_report_key(a) == _report_key(b),
              f"replay({label}) with the executor differs from without")
        row = {"case": label, "plain_s": t_plain["seconds"],
               "executor_s": t_ex["seconds"], "bit_for_bit": True,
               "stats": dict(ex.stats)}
        if c is None:
            hc = executor(host)
            h = replay(stream(host_trace), name, executor=hc, **kw)
            row["host_max_rel_diff"] = _replay_worst(b, h, label)
            worst = max(worst, row["host_max_rel_diff"])
        replays.append(row)
    check(worst <= STREAM_RTOL,
          f"replay with the executor on the card differs from the host's "
          f"by rtol {worst}")
    report["replay"] = {"cases": replays, "card_vs_host_max_rel_diff": worst,
                        "rtol": STREAM_RTOL}

    # -- the Frontier day through the executor's segment sums ---------------
    ex = executor(device)
    st, fold = _measured(device, lambda: StreamingTelemetry(
        track_jobs=False, executor=ex).extend(iter_array(
            flat, chunk=sizes["stream_shard"])))
    got = st.decomposition()
    for key in ("hours_pct", "energy_mwh", "total_energy_mwh"):
        check(getattr(got, key) == getattr(day, key),
              f"the day streamed through the executor: {key} differs from "
              f"decompose")
    report["fleet_day"] = {"samples": flat.numel(), "stream": fold,
                           "segment_calls": ex.stats["kernel_calls"],
                           "bit_for_bit_with_decompose": True}
    del st

    # -- a Study with the executor against the same Study without -----------
    w = Workload("w", "mi250x-gcd", powers=torch.round(
        modal.synth_fleet_powers(10_000, seed=14, device=device) * 10.0)
        / 10.0)
    axes = dict(workloads=[w], chips=["mi250x-gcd", "tpu-v5e"],
                policies=[("energy-aware", {"slowdown_budget": 0.05}),
                          ("power-cap", {"cap_w": 420.0})])
    ra = Study(**axes).run()
    ex = executor(device)
    rb = Study(**axes, executor=ex).run()
    check(len(ra) == len(rb) == 4 and all(
        (ca.workload, ca.chip, ca.policy, ca.savings_pct,
         ca.total_energy_mwh) == (cb.workload, cb.chip, cb.policy,
                                  cb.savings_pct, cb.total_energy_mwh)
        and _report_key(ca.detail) == _report_key(cb.detail)
        for ca, cb in zip(ra.cells, rb.cells)),
        "a Study with the executor differs from the same Study without")
    report["study"] = {"cells": len(rb), "bit_for_bit": True,
                       "stats": dict(ex.stats)}

    # -- times, launches a shard, peak memory --------------------------------
    kw = dict(chip="mi250x-gcd", slowdown_budget=0.05)
    timing = {}
    for dev, p in ((device, trace), (host, host_trace)):
        ex = executor(dev)
        replay(stream(p), "energy-aware", executor=ex, **kw)     # warm memo
        _, t_plain = _measured(dev, lambda: replay(stream(p), "energy-aware",
                                                   **kw))
        _, t_warm = _measured(dev, lambda: replay(
            stream(p), "energy-aware", executor=ex, **kw))
        timing[dev.type] = {"plain_s": t_plain["seconds"],
                            "executor_warm_s": t_warm["seconds"],
                            "speedup": t_plain["seconds"]
                            / t_warm["seconds"]}
    shards = -(-n // shard)
    ex = executor(device)
    _, lp = _device_launches(device, lambda: replay(stream(trace),
                                                    "energy-aware", **kw))
    _, lc = _device_launches(device, lambda: replay(
        stream(trace), "energy-aware", executor=ex, **kw))
    _, lw = _device_launches(device, lambda: replay(
        stream(trace), "energy-aware", executor=ex, **kw))
    per_shard = {k: {"launches_per_shard": None if v["launches"] is None
                     else v["launches"] / shards,
                     "device_ms_per_shard": None if v["device_ms"] is None
                     else v["device_ms"] / shards,
                     "wall_s_profiled": v["wall_s"]}
                 for k, v in (("plain", lp), ("executor_cold", lc),
                              ("executor_warm", lw))}
    big, big_shard = sizes["exec_big"], sizes["exec_big_shard"]
    at_scale = {}
    # one pass with a cold memo, then a second with it warm; unquantized
    # (memo and dedup decline) at the default chunk, and at a chunk of the
    # shard's size
    for label, p, passes, chunk in (
            ("quantized", torch.round(flat[:big] * 10.0) / 10.0, 2, None),
            ("unquantized", flat[:big], 1, None),
            ("unquantized_chunk_shard", flat[:big], 1, big_shard)):
        ex = executor(device) if chunk is None \
            else executor(device, chunk=chunk)

        def run(**extra):
            return replay(stream(p, size=big_shard), "energy-aware", **kw,
                          **extra)
        a, t_plain = _measured(device, run)
        row = {"samples": big, "shard_samples": big_shard,
               "chunk": ex.chunk, "plain": t_plain}
        for i in range(passes):
            b, t_ex = _measured(device, lambda: run(executor=ex))
            check(_report_key(a) == _report_key(b),
                  f"replay of {big} {label} samples with the executor "
                  f"differs from without")
            row["executor" if i == 0 else "executor_warm"] = t_ex
            row["speedup" if i == 0 else "speedup_warm"] = \
                t_plain["seconds"] / t_ex["seconds"]
        at_scale[label] = {**row, "bit_for_bit": True,
                           "stats": dict(ex.stats)}
        del p
    report["timing"] = {"trace_samples": n, "shards": shards,
                        "replay_1m": timing, "launches": per_shard,
                        "at_scale": at_scale}
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
def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, itemsize, causal, Dv=None):
    """Least time for one call: the bytes and flops the attention function
    needs (kernels/flash_attention.py's attention_need: q and k of head
    dim D, v and o of Dv, each read or written once; 2 D for q.k and 2 Dv
    for p.v per unmasked score entry), the bytes over the HBM rate against
    the flops over the rate of the tensor-core products the kernel does
    them with: bf16 at the bf16 peak; f32 as 3xTF32, three TF32 products
    for each f32 one, at the TF32 peak."""
    from repro_torch.kernels import flash_attention as fa
    Dv = D if Dv is None else Dv
    flops, byts = fa.attention_need(B, Hq, Hkv, Sq, Skv, D, Dv, itemsize,
                                    causal)
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


def flash_sass_by_instantiation(build) -> dict:
    """The tensor-core products in the SASS of every instantiation of both
    flash kernels (HMMA for the f32 kernel, HGMMA for the bf16 one), keyed
    ``"<f32|sm90> D<class D>_<class Dv>_<block_q>x<block_k>"``, from one
    disassembly of the library."""
    import re
    out = {}
    for chunk in build.sass("flash_fwd_").split("Function : ")[1:]:
        m = re.search(r"flash_fwd_(f32|sm90)_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E", chunk.split("\n", 1)[0])
        if m:
            out[f"{m[1]} D{m[2]}_{m[3]}_{m[4]}x{m[5]}"] = chunk.count(
                "HMMA" if m[1] == "f32" else "HGMMA")
    return out


def flash_instantiations() -> list:
    """The keys of flash_sass_by_instantiation that the kernels' rules
    (``fa.unsupported``) say are built: every tile at every class pair."""
    from repro_torch.kernels import flash_attention as fa
    keys = []
    for tag, itemsize in (("f32", 4), ("sm90", 2)):
        q_opts, k_opts = fa.tile_options(itemsize)
        for D, Dv in fa.HEAD_DIM_PAIRS:
            keys += [f"{tag} D{D}_{Dv}_{bq}x{bk}" for bq in q_opts
                     for bk in k_opts
                     if fa.unsupported(itemsize, D, Dv, bq, bk) is None]
    return keys


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
    at the model's tiles; f32 at MLA's and RecurrentGemma's prefills (the
    f32 kernel takes their head dims since it takes any). Then the head
    dims that the kernels take since they take any: the head-dim classes
    32, 96 and 192 in both dtypes, timed (FLASH_CLASS_ROWS); the sweep of
    FLASH_SWEEP_DIMS (and in f32 FLASH_SWEEP_F32_DIMS), causal over a
    ragged length with GQA and non-causal with Sq != Skv; and a bf16 shape
    whose rows break the 16-byte copy rule, which the wrapper copies
    (every case's copies are counted against the tensors that break the
    rule). Returns the kernels-line entries of the bf16 kernel at D = Dv =
    128, at (192, 128) and at (256, 256), and of the f32 kernel, each from
    the first timed case at its head dims (the rows of the VLM and enc-dec
    paths and of any head dim apart), then one for each class a path of
    this run reaches at head dims taken since the kernels take any, then
    one entry for each row of the VLM and enc-dec paths
    (CROSS_FLASH_ROWS)."""
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
        # f32 at MLA's (192, 128) and at RecurrentGemma's (256, 256), as
        # the bf16 rows (their f32 prefills reach the kernel now)
        ("mla_prefill_f32", 1, mla_seq, mla_seq, mla_heads, mla_heads,
         MLA_HEAD_DIMS, f32, True, *attn.flash_tiles(f32, MLA_HEAD_DIMS)),
        ("rg_local_prefill_served_f32", REC_REQUESTS, rec_seq, rec_seq,
         rg_heads, rg_kv, RG_HEAD_DIMS, f32, True,
         *attn.flash_tiles(f32, RG_HEAD_DIMS)),
    ]
    # the head-dim classes added for any head dim, timed; the sweep over
    # head dims of every kind of class, causal and ragged, non-causal with
    # Sq != Skv; and rows that break the 16-byte copy rule
    cb, cs_, ch = sizes["flash_class"]
    for dname, w in FLASH_CLASS_ROWS:
        dt = f32 if dname == "f32" else bf16
        cases.append((f"class_{w}_{dname}", cb, cs_, cs_, ch, ch, w, dt,
                      True, *attn.flash_tiles(dt, (w, w))))
    sw_s, sw_q, sw_kv = sizes["flash_sweep"]
    for dt in (f32, bf16):
        dname = "f32" if dt == f32 else "bf16"
        for dims in FLASH_SWEEP_DIMS + (FLASH_SWEEP_F32_DIMS if dt == f32
                                        else ()):
            tag = "x".join(map(str, dims))
            cases.append((f"sweep_causal_{tag}_{dname}", 1, sw_s, sw_s, 4,
                          2, dims, dt, True,
                          *attn.flash_tiles(dt, dims, True, sw_s)))
            cases.append((f"sweep_noncausal_{tag}_{dname}", 2, sw_q, sw_kv,
                          4, 4, dims, dt, False,
                          *attn.flash_tiles(dt, dims, False, sw_q)))
    cases.append(("padded_copy_bf16", 1, sw_s, sw_s, 1, 1, FLASH_PADDED_DIMS,
                  bf16, True, *attn.flash_tiles(bf16, FLASH_PADDED_DIMS)))
    rows = []
    for name, B, Sq, Skv, Hq, Hkv, D, dt, causal, bq, bk in cases:
        D, Dv = (D, D) if isinstance(D, int) else D
        q = rnd((B, Sq, Hq, D), dt)
        k = rnd((B, Skv, Hkv, D), dt)
        v = rnd((B, Skv, Hkv, Dv), dt)
        if name == "zero_k_bf16":
            k.zero_()
        copies = fa.PADDED_COPIES
        got = fa.flash_attention_bshd(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk)
        copies = fa.PADDED_COPIES - copies
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        block_q=bq, block_k=bk, round_p=True)
        err, share = flash_error(got, want)
        check(share <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention[{name}] differs from its plain version by "
              f"{err}, {share} of the limit {flash_tolerance(dt)}")
        breaking = sum(not fa.copy_rule_holds(t) for t in (q, k, v))
        check(device.type != "cuda" or copies == breaking,
              f"flash_attention[{name}]: {copies} padded copies where "
              f"{breaking} of q, k, v break the 16-byte rule")
        check(name != "padded_copy_bf16" or breaking == 3,
              f"flash_attention[{name}] keeps the 16-byte rule")
        row = {"case": name, "q": list(q.shape), "kv": list(k.shape),
               "v": list(v.shape), "head_dims": [D, Dv],
               "head_dim_class": list(fa.head_dim_class(D, Dv)),
               "dtype": str(dt).replace("torch.", ""), "causal": causal,
               "blocks": [bq, bk], "max_abs_err": err,
               "share_of_limit": share, "tolerance": flash_tolerance(dt),
               "padded_copies": copies}
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
            "timing": timing, "timed_case": main["case"]}

    entries = []
    other_dims = (list(MLA_HEAD_DIMS), list(RG_HEAD_DIMS))
    cross_cases = {case for _, case, _, _ in CROSS_FLASH_ROWS}
    for name, dt, dims, source, what in (
            ("flash_attention", bf16, None, "flash_attention_sm90.cuh",
             "(the served model's prefill)"),
            ("flash_attention_192x128", bf16, MLA_HEAD_DIMS,
             "flash_attention_sm90.cuh",
             "(deepseek-v3-671b's MLA prefill, q/k head dim 192, v 128)"),
            ("flash_attention_256x256", bf16, RG_HEAD_DIMS,
             "flash_attention_sm90.cuh",
             "(recurrentgemma-2b's local-attention prefill as served, "
             "head dim 256)"),
            ("flash_attention_f32", f32, None, "flash_attention_f32.cuh",
             "(the tuning space's shape, the model's f32 tiles)")):
        mine = [r for r in rows
                if r["dtype"] == str(dt).replace("torch.", "")
                and r["case"] not in cross_cases
                and not r["case"].startswith(ANY_HEAD_DIM_CASES)
                and (r["head_dims"] == list(dims) if dims
                     else r["head_dims"] not in other_dims)]
        main = next(r for r in mine if "ms" in r)
        entries.append(entry(name, dt, main, mine, source, what))
    # the classes that paths of this run reach at head dims the kernels
    # took only since they take any: each entry's rows are those of its
    # class and dtype, its time its timed case's
    for name, dt, case, what in (
            ("flash_attention_f32_192x128", f32, "mla_prefill_f32",
             "(deepseek-v3-671b's MLA prefill in f32)"),
            ("flash_attention_f32_256x256", f32,
             "rg_local_prefill_served_f32",
             "(recurrentgemma-2b's local-attention prefill in f32)"),
            ("flash_attention_f32_96x96", f32, "class_96_f32",
             "(the (96, 96) class: tuning at head dim 96)"),
            ("flash_attention_f32_32x32", f32, "class_32_f32",
             "(the (32, 32) class: tuning at head dim 32)"),
            ("flash_attention_32x32", bf16, "class_32_bf16",
             "(the (32, 32) class: the reduced configs' head dims 16 and "
             "(24, 16))")):
        main = next(r for r in rows if r["case"] == case)
        mine = [r for r in rows if r["dtype"] == main["dtype"]
                and r["head_dim_class"] == main["head_dim_class"]]
        entries.append(entry(name, dt, main, mine,
                             "flash_attention_f32.cuh" if dt == f32
                             else "flash_attention_sm90.cuh", what))
    for e in entries:
        if "f32" in e["name"]:
            e.update(
                bound="max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s): "
                      "the products run as 3xTF32 on the tensor cores",
                ms_best_tile=min(next(
                    r for r in rows if r["case"] == e["timed_case"])[
                        "ms_by_tile"].values()))
    # the calls of the VLM and enc-dec paths, one row each
    for name, case, _, what in CROSS_FLASH_ROWS:
        main = next(r for r in rows if r["case"] == case)
        entries.append(entry(name, bf16, main, [main],
                             "flash_attention_sm90.cuh", what))
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


def tune_flash_head_dims(device, sizes: dict) -> dict:
    """tune() over the f32 flash tiles at the head dims of
    TUNE_HEAD_DIMS (any head dim runs at its class), each with the
    wall-clock harness and every candidate validated against the oracle;
    the kernel's launches of each, counted from just before to just
    after."""
    import repro_torch.core.hardware as hw
    from repro_torch.kernels import ops
    from repro_torch.tuning import (FlashAttentionSpace, PerfParams,
                                    WallClockBackend, tune)
    bh, seq, _ = sizes["flash_space"]
    out = {}
    for D, Dv in TUNE_HEAD_DIMS:
        space = FlashAttentionSpace(batch_heads=bh, seq_q=seq, head_dim=D,
                                    value_dim=Dv, chip=hw.H100_SXM,
                                    device=device)
        backend = WallClockBackend(hw.H100_SXM, perf=PerfParams.ideal(),
                                   repeats=3, device=device)
        ops.reset_launch_counts()
        result = tune(space, backend=backend, validate=True)
        launches = ops.launch_counts()["flash_attention"]
        meas = result.measurement
        check(bool(meas.candidates)
              and max(meas.validation_err) <= space.tol,
              f"flash_attention tuning at head dims ({D}, {Dv}): no "
              f"candidate, or one outside {space.tol} of kernels.ref")
        out[f"{D}x{Dv}"] = {
            "shape": [bh, seq, D, Dv],
            "candidates": [c.label for c in meas.candidates],
            "wall_ms": {c.label: w * 1e3
                        for c, w in zip(meas.candidates, backend.wall_s)},
            "validation_max_abs_err": max(meas.validation_err),
            "best_time": repr(result.best("time")), "launches": launches}
        space.release()
    return out


def _attention_dims(cfg) -> tuple:
    """(D, Dv) of a config's self-attention at prefill."""
    if cfg.use_mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return (cfg.resolved_head_dim,) * 2


def f32_model_prefills(device, sizes: dict) -> dict:
    """The f32 prefill of each model of F32_PREFILL (deepseek-v3-671b's MLA
    at (192, 128), recurrentgemma-2b's local attention at (256, 256)) on
    the kernel route against the plain route (end_to_end_check: tokens by
    margin, the MoE's routing, the hybrid's first attention layer), with
    the flash kernel's launches by call shape counted from just before to
    just after: each kernel-route prefill (the route, again, and on the
    card broken on purpose) launches it once an attention layer at the
    prompt's shape."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import Runtime
    out = {}
    for arch, cuts, why in F32_PREFILL:
        cfg, reduced = serve_config(sizes, arch, cuts, why)
        cfg = dataclasses.replace(cfg, dtype="float32")
        gen = torch.Generator(device=device)
        gen.manual_seed(4321)
        params = model_mod.init_params(cfg, Runtime(tp=1), gen,
                                       device=device)
        ops.reset_launch_counts()
        e2e = end_to_end_check(device, cfg, params, sizes)
        by_shape = dict(fa.LAUNCHES_BY_SHAPE)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        S = sizes["e2e_prompt_len"]
        key = fa.launch_key(*_attention_dims(cfg), True, S, S)
        layers = (tfm.hybrid_kinds(cfg).count("attn")
                  if cfg.family == "hybrid" else cfg.n_layers)
        expected = 3 * layers if device.type == "cuda" else 0
        check(by_shape.get(key, 0) == expected
              and sum(by_shape.values()) == expected,
              f"{arch} f32: the kernel-route prefills launched the flash "
              f"kernel {by_shape}, not {expected} times at {key}")
        out[arch] = {"dtype": "float32", "reduced": reduced,
                     "n_layers": cfg.n_layers,
                     "head_dims": list(_attention_dims(cfg)),
                     "flash_launches_by_shape": by_shape,
                     "flash_launches_expected": {key: expected}, **e2e}
    return out


def serve_reduced_configs(device, sizes: dict) -> dict:
    """The reduced() config of each attention family (REDUCED_SERVE: dense,
    MoE, MLA, hybrid, VLM, enc-dec; head dim 16, MLA's (24, 16), the
    (32, 32) class), in bf16 with random weights from a seed (the VLM's
    gates drawn non-zero): ServeEngine.generate on REDUCED_REQUESTS greedy
    requests (with a frontend in ``extra_batch`` for the VLM and the
    enc-dec; no longer than the hybrid's local window, which would mask
    keys, the plain route's case), its flash launches by head dims counted
    from just before to just after; then the prefill and greedy decode steps on the kernel and
    the plain route, whose tokens must agree at every step whose top-2
    margin exceeds the routes' logit difference."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode as decode_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving import Request, ServeEngine
    prompt, new, max_len = sizes["reduced_serve"]
    out = {}
    for arch in REDUCED_SERVE:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="bfloat16")
        S = min(prompt, cfg.local_window or prompt)
        gen = torch.Generator(device=device)
        gen.manual_seed(99)
        params = model_mod.init_params(cfg, Runtime(tp=1), gen,
                                       device=device)
        if cfg.family == "vlm":
            for block in params["layers"]["cross"]:
                for name in ("gate_a", "gate_m"):
                    block[name].copy_(torch.randn(
                        block[name].shape, generator=gen, device=device))
        B = REDUCED_REQUESTS
        extra = ({"frontend": draw_frontend(cfg, B, gen, device)}
                 if cfg.family in ("vlm", "encdec") else {})
        rng = np.random.default_rng(3)
        reqs = [Request(rng.integers(0, cfg.vocab_size, S, dtype=np.int32),
                        max_new_tokens=new) for _ in range(B)]
        engine = ServeEngine(cfg, Runtime(tp=1), params, max_len=max_len)
        ops.reset_launch_counts()
        outs = engine.generate(reqs, extra_batch=extra or None)
        _sync(device)
        by_dims = ops.flash_launches_by_head_dims()
        check(all(o.shape == (new,) and o.min() >= 0
                  and o.max() < cfg.vocab_size for o in outs),
              f"{arch} reduced: generate returned malformed tokens")
        key = "x".join(map(str, _attention_dims(cfg)))
        check(device.type != "cuda" or by_dims.get(key, 0) > 0,
              f"{arch} reduced: generate never launched the flash kernel "
              f"at {key}: {by_dims}")
        toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(
            device)
        steps = {}
        for impl in ("kernel", "plain"):
            rt = Runtime(tp=1, attn_impl=impl)

            def pf(p, batch, rt=rt):
                return decode_mod.prefill(cfg, rt, p, {**batch, **extra},
                                          max_len)

            def dec(p, tok, pos, state, rt=rt):
                return decode_mod.decode_step(cfg, rt, p, tok, pos, state)
            steps[impl], _, _ = _greedy(pf, dec, params, toks, new, device)
        margin = _margin_tokens(steps["plain"], steps["kernel"])
        check(margin["tokens_equal"] == margin["tokens_compared"],
              f"{arch} reduced: greedy tokens differ between the kernel and "
              f"the plain route where the margin exceeds the difference: "
              f"{margin}")
        out[arch] = {"family": cfg.family, "dtype": cfg.dtype,
                     "head_dims": list(_attention_dims(cfg)),
                     "requests": B, "prompt_len": S, "new_tokens": new,
                     "generate_tokens": [o.tolist() for o in outs],
                     "flash_launches_by_head_dims": by_dims,
                     "prefill_logits_max_abs_diff": float(
                         (steps["kernel"][0].float()
                          - steps["plain"][0].float()).abs().max()),
                     **margin}
        del engine, params, steps
    return out


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

    def recorded(router_w, xt, k, **kw):
        out = route(router_w, xt, k, **kw)
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

        def recorded(router_w, x, k, **kw):
            out = route(router_w, x, k, **kw)
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


def train_phase(device, sizes: dict, timer: Timer, keep=None) -> dict:
    """``Trainer.run()`` of TRAIN_ARCH at full width in bf16 (f32 AdamW
    moments), cut to TRAIN_CUTS, at train_4k's length and a batch cut to
    ``sizes["train_batch"]``, energy-aware, no checkpoints: each step's ms,
    tokens/s over the steps after the first, peak memory, the session's
    energy and the losses. Then, on the trained state: one forward and
    backward of the loss alone, and one attention forward and backward at
    the step's shape, timed, for where the step's time goes. ``keep``
    receives the trainer (``"trainer"``) for the dry-run phase's count of
    one more step."""
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
    if keep is not None:
        keep["trainer"] = t
    return report



# ---------------------------------------------------------------- dry run
#: (a): cells of the dry run (repro_torch.launch.dryrun), each in a fresh
#: process on a fake world of the production mesh's size; the rehearsal
#: runs their reduced configs on a fake (2, 4) mesh
DRYRUN_CELLS = (("stablelm-12b", "train_4k", "single"),
                ("dbrx-132b", "prefill_32k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"),
                ("mamba2-2.7b", "prefill_32k", "single"),
                ("qwen2.5-14b", "decode_32k", "single"))
#: (a)'s cells with a setting, each held against its cell of DRYRUN_CELLS
#: (the same arch, shape and mesh): (tag, its flags)
DRYRUN_SETTINGS = {("qwen2.5-14b", "decode_32k", "single"): (
                       "seq", ("--decode-cache-shard", "seq")),
                   ("stablelm-12b", "train_4k", "single"): (
                       "no_zero1", ("--no-zero1",))}
#: (a)'s sequence-parallel pair at the reduced size on a fake (2, 4) mesh:
#: the cell with --seq-shard (the rule seq -> model) and without, (cell,
#: the flags both take); the gate counts the collectives by hand
DRYRUN_SEQ_SHARD = (("stablelm-12b", "train_4k", "single"),
                    ("--reduced", "--mesh-shape", "2,4"))
#: (a)'s cells on the host: the longest (dbrx-132b's prefill, 40 layers of
#: the plain blocked attention at 32k tokens) takes about 40 s
DRYRUN_CELL_TIMEOUT_S = 600
#: (a)'s gate: the model's flops over the counted flops of the whole
#: world; above this the counter missed model flops
DRYRUN_USEFUL_MAX = 1.05
#: (c): SERVE_ARCH's prefill counted on both attention routes, (batch,
#: tokens)
DRYRUN_PREFILL = (4, 1024)
#: (d): the governor's slowdown budget
DRYRUN_BUDGET = 0.05


def _dryrun_cells(sizes: dict, out_dir: str):
    """Start (a)'s cells, one process each, all at once, off the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    sp_cell, sp_flags = DRYRUN_SEQ_SHARD
    cells = [(c, "", ()) for c in DRYRUN_CELLS] + [
        (c, tag, flags) for c, (tag, flags) in DRYRUN_SETTINGS.items()] + [
        (sp_cell, "reduced", sp_flags),
        (sp_cell, "seq_shard", (*sp_flags, "--seq-shard"))]
    for (arch, shape, mesh), tag, flags in cells:
        cmd = [sys.executable, "-W", "ignore", "-m",
               "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", mesh, "--out", out_dir, *flags] + sizes[
                   "dryrun_flags"]
        if tag:
            cmd += ["--tag", tag]
        if mesh in sizes["dryrun_mesh_shapes"]:
            cmd += ["--mesh-shape", sizes["dryrun_mesh_shapes"][mesh]]
        name = f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")
        with open(os.path.join(out_dir, name + ".log"), "w") as f:
            procs.append(((arch, shape, mesh, tag), time.perf_counter(),
                          subprocess.Popen(cmd, cwd=HERE, env=env, stdout=f,
                                           stderr=subprocess.STDOUT)))
    return procs


def _dryrun_config(arch: str, shape: str, sizes: dict):
    """(config, shape config, (data, model) of the single mesh) of a (a)
    cell at the size the phase runs it."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch.mesh import PRODUCTION
    cfg, sh = get_config(arch), SHAPES_BY_NAME[shape]
    if "--reduced" in sizes["dryrun_flags"]:
        cfg, sh = cfg.reduced(), sh.reduced()
    mesh = sizes["dryrun_mesh_shapes"].get("single")
    dims = (tuple(int(n) for n in mesh.split(",")) if mesh
            else PRODUCTION[False][0])
    return cfg, sh, dims


def _dryrun_seq_cache_gates(base: dict, rec: dict, sizes: dict) -> dict:
    """The split cache's record (--decode-cache-shard seq) against the
    unsplit one of its cell, both on the single mesh: the input bytes a
    device the unsplit ones less (model - 1) / model of the self cache's
    bytes (K and V, whole over model: the kv heads do not split), the dot
    flops equal, and the collectives the unsplit ones plus the combine's a
    layer (q gathered over the heads, this rank's operand; the f32 maxima
    all-reduced, [B, Hq]; the f32 partials reduce-scattered, [B, Hq, hd +
    1]), all counted by hand from the config."""
    cfg, sh, (dp, tp) = _dryrun_config(rec["arch"], rec["shape"], sizes)
    B, M, L = sh.global_batch // dp, sh.seq_len, cfg.n_layers
    hd, Hq = cfg.resolved_head_dim, cfg.padded_heads(tp)
    cache = 2 * L * B * M * cfg.padded_kv_heads(tp) * hd * 2
    add = {"all-gather": (L, L * B * Hq // tp * hd * 2),
           "all-reduce": (L, L * B * Hq * 4),
           "reduce-scatter": (L, L * B * Hq * (hd + 1) * 4)}
    cb, cr = base["collectives"], rec["collectives"]
    colls = {k: [cr["__counts__"].get(k, 0), cr.get(k, 0),
                 cb["__counts__"].get(k, 0) + add.get(k, (0, 0))[0],
                 cb.get(k, 0) + add.get(k, (0, 0))[1]]
             for k in sorted(set(cb["__counts__"]) | set(cr["__counts__"])
                             | set(add))}
    out = {"cache_bytes_unsplit": cache,
           "input_bytes_per_device": [base["input_bytes_per_device"],
                                      rec["input_bytes_per_device"]],
           "input_bytes_want": base["input_bytes_per_device"]
           - cache * (tp - 1) // tp,
           "dot_flops": [base["parsed_cost"]["dot_flops"],
                         rec["parsed_cost"]["dot_flops"]],
           "collectives_count_bytes_want": colls}
    check(out["input_bytes_per_device"][1] == out["input_bytes_want"]
          and out["dot_flops"][0] == out["dot_flops"][1] > 0
          and all(v[0] == v[2] and v[1] == v[3] for v in colls.values()),
          f"the split cache's dry-run record is not the unsplit one's less "
          f"its cache's bytes, or its collectives are not the combine's: "
          f"{out}")
    return out


def _dryrun_seq_shard_gates(base: dict, rec: dict) -> dict:
    """The --seq-shard record (the rule seq -> model) against its cell's
    default record, both at the reduced size on a fake (2, 4) mesh, ZeRO-1
    and full remat: the dot flops and the input bytes a device equal, the
    peak of the step's live intermediates lower, and the collectives
    counted by hand from the config. Each of the default's 2 + 5 L
    activation all-reduces of ``W = [tokens, d]`` bf16 (the embedding's,
    attention's and the mlp's forward sums, attention's again in the
    recompute, the two entries' gradients backward, the loss head's
    gradient) becomes a reduce-scatter charged ``W`` and an all-gather
    charged its local shard ``W / tp`` (``core/hlo_cost.py``'s
    convention); the recompute gathers each layer's mlp input again (L
    all-gathers more); each norm's gain (2 L + 1) has its gradient
    all-reduced over model."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    cfg = get_config(rec["arch"]).reduced()
    sh = SHAPES_BY_NAME[rec["shape"]].reduced()
    dp, tp = (int(n) for n in DRYRUN_SEQ_SHARD[1][-1].split(","))
    L, d = cfg.n_layers, cfg.d_model
    W = sh.global_batch // dp * sh.seq_len * d * 2
    n_act, n_norm = 2 + 5 * L, 2 * L + 1
    add = {"all-reduce": (n_norm - n_act, n_norm * d * 2 - n_act * W),
           "reduce-scatter": (n_act, n_act * W),
           "all-gather": (n_act + L, (n_act + L) * W // tp)}
    cb, cr = base["collectives"], rec["collectives"]
    colls = {k: [cr["__counts__"].get(k, 0), cr.get(k, 0),
                 cb["__counts__"].get(k, 0) + add.get(k, (0, 0))[0],
                 cb.get(k, 0) + add.get(k, (0, 0))[1]]
             for k in sorted(set(cb["__counts__"]) | set(cr["__counts__"])
                             | set(add))}
    out = {"input_bytes_per_device": [base["input_bytes_per_device"],
                                      rec["input_bytes_per_device"]],
           "dot_flops": [base["parsed_cost"]["dot_flops"],
                         rec["parsed_cost"]["dot_flops"]],
           "temp_bytes": [base["memory"]["temp_bytes"],
                          rec["memory"]["temp_bytes"]],
           "collectives_count_bytes_want": colls}
    check(out["input_bytes_per_device"][0] == out["input_bytes_per_device"][1]
          and out["dot_flops"][0] == out["dot_flops"][1] > 0
          and out["temp_bytes"][1] < out["temp_bytes"][0]
          and all(v[0] == v[2] and v[1] == v[3] for v in colls.values()),
          f"the --seq-shard dry-run record is not its default's with each "
          f"activation all-reduce a reduce-scatter and an all-gather: {out}")
    return out


def _dryrun_whole_moment_gates(base: dict, rec: dict, sizes: dict) -> dict:
    """The whole-moment train record (--no-zero1) against the ZeRO-1 one of
    its cell: the dot flops equal; no reduce-scatter, the all-gathers fewer
    by the reduce-scattered leaves, each of them all-reduced instead (the
    all-reduce bytes grow by the reduce-scatter's); the input bytes grow by
    the f32 moments (m and v) the parameters' shards hold beyond their
    ZeRO-1 shards, counted from the specs."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel.sharding import (NamedSharding, is_spec,
                                               zero1_specs)
    from repro_torch.tree import tree_leaves
    cfg, _, (dp, tp) = _dryrun_config(rec["arch"], rec["shape"], sizes)
    mesh = AbstractMesh((dp, tp), ("data", "model"))
    shapes = model_mod.init_params(cfg, Runtime(tp=tp), device="meta")
    p_specs = model_mod.param_specs(cfg, Runtime(tp=tp), default_rules())
    z_specs = zero1_specs(p_specs, shapes, mesh, ("data",))

    def elems(specs):
        return sum(math.prod(NamedSharding(mesh, sp).local_shape(t.shape))
                   for t, sp in zip(tree_leaves(shapes),
                                    tree_leaves(specs, is_leaf=is_spec)))
    extra = 2 * 4 * (elems(p_specs) - elems(z_specs))
    cb, cr = base["collectives"], rec["collectives"]
    n_rs = cb["__counts__"].get("reduce-scatter", 0)
    out = {"input_bytes_per_device": [base["input_bytes_per_device"],
                                      rec["input_bytes_per_device"]],
           "moment_bytes_extra_want": extra,
           "dot_flops": [base["parsed_cost"]["dot_flops"],
                         rec["parsed_cost"]["dot_flops"]],
           "counts": [cb["__counts__"], cr["__counts__"]],
           "all_reduce_bytes": [cb["all-reduce"], cr["all-reduce"]],
           "reduce_scatter_bytes_zero1": cb.get("reduce-scatter", 0)}
    check(out["dot_flops"][0] == out["dot_flops"][1] > 0 and n_rs > 0
          and "reduce-scatter" not in cr["__counts__"]
          and cr["__counts__"].get("all-gather", 0)
          == cb["__counts__"].get("all-gather", 0) - n_rs
          and cr["__counts__"]["all-reduce"]
          == cb["__counts__"]["all-reduce"] + n_rs
          and cr["all-reduce"] == cb["all-reduce"] + cb["reduce-scatter"]
          and rec["input_bytes_per_device"]
          == base["input_bytes_per_device"] + extra,
          f"the whole-moment dry-run record is not the ZeRO-1 one's with "
          f"all-reduced gradients and whole moments: {out}")
    return out


def _count(fn, *args):
    """(``fn(*args)``, the CostCounter that counted it)."""
    from repro_torch.core.hlo_cost import CostCounter
    with CostCounter() as c:
        c.arguments(*args)
        out = fn(*args)
    return out, c


def _abstract(tree):
    """``meta`` tensors of ``tree``'s shapes and dtypes (the dry run's)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _table_diff(a: dict, b: dict) -> dict:
    """{op: [a, b]} where two per-op tables differ."""
    return {k: [a.get(k, 0.0), b.get(k, 0.0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0.0) != b.get(k, 0.0)}


def _dryrun_real_step(device, trainer) -> dict:
    """(b): one more step of the train phase's trainer counted on the card,
    untimed, and the same step on ``meta`` tensors (the dry run's way): the
    counts side by side, the abstract one priced on H100_SXM beside the
    train phase's measured step."""
    from repro_torch.core import roofline as rl
    from repro_torch.core.hardware import H100_SXM
    t = trainer
    batch = t._device_batch(t.tcfg.steps)
    meta_out, counted = _count(t._step_fn, *_abstract((t.state, batch)))
    meta_mem = counted.memory(meta_out)
    del meta_out
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, metrics), real = _count(t._step_fn, t.state, batch)
    _sync(device)
    real_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    t.state = state
    a, b = real.totals, counted.totals
    # where the card's count and the abstract one differ, by op (an op the
    # card dispatches and the meta device does not, say)
    diffs = {"bytes_accessed": _table_diff(a.bytes_table, b.bytes_table),
             "elementwise_flops": _table_diff(real.elementwise_table,
                                              counted.elementwise_table)}
    check(math.isfinite(float(metrics["loss"])),
          "the counted step's loss is not finite")
    check(a.dot_flops == b.dot_flops
          and a.collective_bytes == b.collective_bytes,
          f"the card's step and the meta step count different dot flops "
          f"or collective bytes: {a.to_dict()} vs {b.to_dict()}")
    check((a.bytes_accessed == b.bytes_accessed
           or bool(diffs["bytes_accessed"]))
          and (a.elementwise_flops == b.elementwise_flops
               or bool(diffs["elementwise_flops"])),
          f"the bytes or elementwise flops differ by no op named: {diffs}")
    mf = rl.model_flops(t.cfg, t.shape)
    rep = rl.roofline_from_artifacts(
        {"flops": b.flops, "bytes accessed": b.bytes_accessed},
        rl.collective_bytes(b), 1, mf, H100_SXM)
    walls = [h["wall_s"] for h in t.history]
    step_s = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
    return {"cell": {"arch": t.cfg.name, "n_layers": t.cfg.n_layers,
                     "tokens": [t.shape.global_batch, t.shape.seq_len],
                     "dtype": t.cfg.dtype},
            "card": a.to_dict(), "meta": b.to_dict(),
            "ops": {"card": real.ops, "meta": counted.ops},
            "equal": {"dot_flops": a.dot_flops == b.dot_flops,
                      "collective_bytes": a.collective_bytes
                      == b.collective_bytes,
                      "bytes_accessed": a.bytes_accessed == b.bytes_accessed,
                      "elementwise_flops": a.elementwise_flops
                      == b.elementwise_flops},
            "differences_by_op": diffs,
            "counted_step_s": real_s,
            "roofline": rep.to_dict(),
            "measured_step_ms": step_s * 1e3,
            "measured_mfu": mf / (step_s * H100_SXM.peak_flops),
            "roofline_mfu": rep.mfu,
            "memory_estimate_bytes": meta_mem["argument_bytes"]
            + meta_mem["temp_bytes"],
            "memory_estimate": meta_mem, "card_memory": real.memory(state),
            "max_memory_allocated": peak}


def _dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _dryrun_prefill_routes(device, sizes: dict) -> dict:
    """(c): SERVE_ARCH's prefill counted on the kernel route and on the
    plain route, its attention calls also under a counter of their own:
    outside attention the counts must be equal, and the kernel route's
    flash charge must be its launches times the kernel's work at the
    call's shape."""
    from repro_torch.core.hlo_cost import CostCounter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode as decode_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    cfg, reduced = serve_config(sizes, SERVE_ARCH)
    B, S = sizes["dryrun_prefill"]
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, Runtime(), gen, device=device)
    gen.manual_seed(24)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=device, dtype=torch.int32)
    chunked = attn_mod.chunked_attention
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "tokens": [B, S],
           "reduced": reduced}
    for impl in ("kernel", "plain"):
        inner = CostCounter()

        def counted(*a, **kw):
            with inner:
                return chunked(*a, **kw)
        ops.reset_launch_counts()
        with patched(attn_mod, "chunked_attention", counted), \
                CostCounter() as outer:
            logits, _ = decode_mod.prefill(cfg, Runtime(attn_impl=impl),
                                           params, {"tokens": toks}, S)
        _sync(device)
        o, i = outer.totals, inner.totals
        out[impl] = {
            "launches": ops.launch_counts()["flash_attention"],
            "charged_launches": outer.kernel_launches.get(
                "flash_attention", 0),
            "outside_attention": {
                "dot_flops": o.dot_flops - i.dot_flops,
                "elementwise_flops": o.elementwise_flops
                - i.elementwise_flops,
                "bytes_accessed": o.bytes_accessed - i.bytes_accessed,
                "collective_total": o.collective_total
                - i.collective_total},
            "attention_dot_flops": i.dot_flops,
            "attention_bytes": i.bytes_accessed,
            "flash_charge": [o.dot_table.get("flash_attention", 0.0),
                             o.bytes_table.get("flash_attention", 0.0)],
            "logits_finite": bool(torch.isfinite(logits).all())}
        del logits
    del params
    k, p = out["kernel"], out["plain"]
    hd, dt = cfg.resolved_head_dim, _dtype_of(cfg)
    bq, bk = attn_mod.flash_tiles(dt, (hd, hd), True, S)
    one = fa.flash_attention_cost(B * cfg.n_heads, S, S, hd, hd,
                                  dt.itemsize, causal=True, block_q=bq,
                                  block_k=bk)
    want = [k["launches"] * one[0], k["launches"] * one[1]]
    out.update(flash_tiles=[bq, bk], flash_charge_expected=want)
    check(k["logits_finite"] and p["logits_finite"],
          f"a counted prefill's logits are not finite: {out}")
    check(k["outside_attention"] == p["outside_attention"],
          f"the two prefill routes count differently outside attention: "
          f"{k['outside_attention']} vs {p['outside_attention']}")
    check(k["charged_launches"] == k["launches"]
          and k["flash_charge"] == want and p["launches"] == 0
          and p["flash_charge"] == [0.0, 0.0],
          f"the flash charge is not its launches times the kernel's work: "
          f"{k}, expected {want}")
    return out


def dryrun_phase(device, sizes: dict, keep: dict) -> dict:
    """The dry run and its cost model: (a) DRYRUN_CELLS through
    repro_torch.launch.dryrun, each in a fresh process (a fake world of the
    mesh's 256 / 512 ranks, meta tensors, off the card), started first and
    read last; (b) the train phase's step counted on the card and on meta
    tensors; (c) SERVE_ARCH's prefill counted on both attention routes;
    (d) the legacy governor on (b)'s roofline against EnergyAwarePolicy,
    field for field. The records are counted and priced on H100_SXM's
    datasheet peaks, not measured."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.power_model import profile_from_roofline
    from repro_torch.power import (ChipModel, EnergyAwarePolicy,
                                   GovernorConfig, PowerGovernor)
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "dryrun_torch")
    os.makedirs(out_dir, exist_ok=True)
    procs = _dryrun_cells(sizes, out_dir)
    report = {}
    try:
        t1 = time.perf_counter()
        report["real_step"] = _dryrun_real_step(device, keep.pop("trainer"))
        report["real_step"]["seconds"] = time.perf_counter() - t1
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        report["prefill_routes"] = _dryrun_prefill_routes(device, sizes)
        report["prefill_routes"]["seconds"] = time.perf_counter() - t1
        r = report["real_step"]["roofline"]
        profile = profile_from_roofline(r["compute_s"], r["memory_s"],
                                        r["collective_s"])
        gov = PowerGovernor(GovernorConfig(slowdown_budget=DRYRUN_BUDGET),
                            chip=H100_SXM).choose(profile)
        pol = EnergyAwarePolicy(slowdown_budget=DRYRUN_BUDGET).decide(
            profile, ChipModel(H100_SXM))
        check(gov == pol, f"PowerGovernor.choose {gov} differs from "
                          f"EnergyAwarePolicy.decide {pol}")
        report["governor"] = {"profile": [profile.compute_s,
                                          profile.memory_s,
                                          profile.collective_s],
                              "slowdown_budget": DRYRUN_BUDGET,
                              "freq_mhz": gov.freq_mhz,
                              "mode": gov.mode.name,
                              "savings_pct": gov.savings_pct,
                              "equal_to_policy": gov == pol}
        # each cell's own seconds: its process polled until it exits
        ended = {}
        while len(ended) < len(procs):
            check(time.perf_counter() - t0 < DRYRUN_CELL_TIMEOUT_S,
                  f"the dry-run cells ran past {DRYRUN_CELL_TIMEOUT_S} s")
            for i, (_, start, proc) in enumerate(procs):
                if i not in ended and proc.poll() is not None:
                    ended[i] = time.perf_counter() - start
            time.sleep(0.1)
        cells, records = [], {}
        for i, ((arch, shape, mesh, setting), _, proc) in enumerate(procs):
            seconds = ended[i]
            tag = os.path.join(out_dir, f"{arch}__{shape}__{mesh}" + (
                f"__{setting}" if setting else ""))
            path = tag + ".json"
            if proc.returncode or not os.path.exists(path):
                with open(tag + ".log") as f:
                    check(False, f"the dry-run cell {arch} {shape} {mesh} "
                                 f"{setting} failed ({proc.returncode}): "
                                 f"{f.read()[-2000:]}")
            with open(path) as f:
                rec = json.load(f)
            records[(arch, shape, mesh, setting)] = rec
            ro = rec["roofline"]
            row = {"arch": arch, "shape": shape, "mesh": mesh,
                   "setting": setting or None,
                   "chips": rec["chips"], "dominant": ro["dominant"],
                   "step_time_s": ro["step_time_s"], "mfu": ro["mfu"],
                   "useful_flops_ratio": ro["useful_flops_ratio"],
                   "fits_hbm": rec["fits_hbm"],
                   "collective_total": rec["collectives"]["total"],
                   "flops": rec["cost"]["flops"],
                   "bytes": rec["cost"]["bytes accessed"],
                   "ops": rec["ops"], "compile_s": rec["compile_s"],
                   "seconds": seconds,
                   "host_peak_rss_bytes": rec["host_peak_rss_bytes"]}
            nums = [row[k] for k in ("step_time_s", "mfu",
                                     "useful_flops_ratio",
                                     "collective_total", "flops", "bytes")]
            check(all(math.isfinite(x) and x > 0 for x in nums)
                  and row["useful_flops_ratio"] <= DRYRUN_USEFUL_MAX,
                  f"a dry-run record's numbers are not finite and positive, "
                  f"or its useful flops ratio exceeds {DRYRUN_USEFUL_MAX}: "
                  f"{row}")
            cells.append(row)
        report["cells"] = cells
        gates = {"seq": _dryrun_seq_cache_gates,
                 "no_zero1": _dryrun_whole_moment_gates}
        report["settings"] = {
            tag: {"cell": list(cell), "flags": list(flags),
                  **gates[tag](records[(*cell, "")], records[(*cell, tag)],
                               sizes)}
            for cell, (tag, flags) in DRYRUN_SETTINGS.items()}
        sp_cell, sp_flags = DRYRUN_SEQ_SHARD
        report["settings"]["seq_shard"] = {
            "cell": list(sp_cell), "flags": [*sp_flags, "--seq-shard"],
            **_dryrun_seq_shard_gates(records[(*sp_cell, "reduced")],
                                      records[(*sp_cell, "seq_shard")])}
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    report["priced_on"] = ("H100_SXM's datasheet peaks: counted, not "
                           "measured")
    report["seconds"] = time.perf_counter() - t0
    return report


# ------------------------------------------------------------ distributed
#: the MoE model of the distributed phase, cut as its serving phase is
DIST_MOE_ARCH, DIST_MOE_CUTS, DIST_MOE_WHY = MOE_SERVE[0]
#: (a): prefill timed on one prompt of this many tokens; decode steps timed
#: on DIST_DECODE_BATCH sequences prefilled at the same length
DIST_PREFILL_LEN = 1024
DIST_DECODE_BATCH = 4
DIST_DECODE_STEPS = 8
DIST_MAX_LEN = 2048
#: (a)'s routes timed in turns, the order repeated sizes["dist_turns"]
#: times
DIST_TURNS = ("local", "ep", "ep", "local")
#: (b): make_train_step steps at full width (the first one warms up)
DIST_TRAIN_STEPS = 3
#: (d): four processes on the one card over gloo, a (data=2, model=2) mesh;
#: DBRX at full width cut to this many layers, a prompt a data row
DIST_GLOO_MESH = (2, 2)
DIST_GLOO_CUTS = {"n_layers": 2}
DIST_GLOO_WHY = ("memory: four processes share one card; each holds "
                 "half of 2 layers' experts and heads (of 1 layer in f32), "
                 "and the local path it is held against holds them all")
DIST_GLOO_PROMPT = 512
DIST_GLOO_STEPS = 4
#: the capacity factor of both (d) routes: a shard of the expert-parallel
#: path sizes its capacity from its own tokens, the local path from all of
#: them, so at the default factor they drop different pairs; inflated (no
#: drops) as the reference's multi-device tests inflate it
DIST_GLOO_CAPACITY = 8.0
#: (d) runs each leg in these dtypes, the f32 weights the bf16 ones widened;
#: the first run chooses its decode tokens greedily, the second is fed them
DIST_GLOO_DTYPES = ("bfloat16", "float32")
#: the layers of (d)'s f32 run: four ranks of 2 layers' f32 weights (17 GB
#: each, with their CUDA contexts and caches) outgrew the card once
DIST_GLOO_F32_LAYERS = 1
#: (d)'s gates, each step's logits: the f32 mesh within DIST_GLOO_F32_RTOL *
#: max|local f32| of the local path in f32; the bf16 mesh no further from
#: the local f32 path than DIST_GLOO_BF16_FACTOR times the bf16 local path
#: is. Set from the card's readings (PERF.md §6): at most 6.3e-6
#: relative in f32 (at 2 layers), a ratio of at most 1.10 in bf16; a
#: collective that drops a partial sum moves the logits by their own size,
#: thousands of times the f32 limit and tens of times the bf16 one
DIST_GLOO_F32_RTOL = 5e-5
DIST_GLOO_BF16_FACTOR = 2.0
#: the collectives of each (d) leg, probed on CUDA tensors before it runs
DIST_GLOO_COLLECTIVES = ("all_reduce", "all_to_all_single",
                         "all_gather_into_tensor", "reduce_scatter_tensor")
DIST_GLOO_LEGS = {"ep_prefill": ("all_reduce", "all_to_all_single",
                                 "all_gather_into_tensor"),
                  "ep2d_decode": ("all_reduce", "all_gather_into_tensor")}


#: (e): the SSM, hybrid, VLM and enc-dec families split over model on
#: four gloo processes on the one card (DIST_GLOO_MESH), each at full width
#: and cut in depth: arch -> its cuts
DIST_FAMILIES = {"mamba2-2.7b": {"n_layers": 4},
                 "recurrentgemma-2b": {"n_layers": 3},
                 "llama-3.2-vision-11b": {"n_layers": 5},
                 "seamless-m4t-large-v2": {"n_layers": 2,
                                           "n_encoder_layers": 2}}
DIST_FAMILIES_WHY = ("time and memory: four processes share one card, and "
                     "rank 0 holds the local path's whole f32 weights and "
                     "gradients beside its shards; RecurrentGemma keeps one "
                     "(rglru, rglru, attn) group, Llama 3.2 Vision one group "
                     "of 5 self layers and its cross block")
#: (e)'s weights, tokens and frontends
DIST_FAMILIES_SEED = 41
#: (e)'s f32 loss and gradients against the local path's: the loss within
#: this relative tolerance, each gathered gradient leaf within
#: DIST_FAMILIES_GRAD_SHARE * max|local leaf| and nonzero
DIST_FAMILIES_LOSS_RTOL = 1e-5
DIST_FAMILIES_GRAD_SHARE = 1e-4
#: the collectives (e)'s split forwards and their gradients call, probed on
#: CUDA tensors first: gloo refusing one fails the run
DIST_FAMILIES_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                             "reduce_scatter_tensor")


#: (f): the decode cache split over the sequence (--decode-cache-shard seq)
#: on four gloo processes on the one card as a (data=1, model=4) mesh:
#: DeepSeek-V3's MLA latent cache, which the split always takes, at full
#: width and cut in depth; DIST_SEQ_BATCH sequences of the (d) prompt's
#: length, DIST_GLOO_STEPS lock-step decode steps, the cache
#: sizes["dist_max_len"] long (the first step writes the first row of rank
#: 1's shard, ranks 2 and 3 hold no valid row)
DIST_SEQ_MESH = (1, 4)
DIST_SEQ_ARCH = "deepseek-v3-671b"
DIST_SEQ_CUTS = {"n_layers": 1, "mtp_depth": 0}
DIST_SEQ_WHY = ("memory: a layer holds ~11.5 B parameters (23.0 GB in "
                "bf16, 46 GB in f32); the f32 run and the f32 local path "
                "the bf16 gate reads hold a layer's whole f32 weights, so "
                "one layer, where the serving phase keeps two in bf16")
DIST_SEQ_BATCH = 2
#: the GQA leg at full width: qwen2.5-14b on (data=1, model=3), where its 8
#: kv heads do not divide over model (arch, model)
DIST_SEQ_GQA = ("qwen2.5-14b", 3)
#: (g): train steps with whole moments (zero1=False) against ZeRO-1 ones
#: on the same four processes as a DIST_GLOO_MESH mesh, seamless-m4t-large-v2
#: at full width in f32 cut in depth as (e) cuts it; a data row of the (d)
#: prompt's length and its frontend
DIST_WHOLE_ARCH = "seamless-m4t-large-v2"
DIST_WHOLE_CUTS = DIST_FAMILIES[DIST_WHOLE_ARCH]
DIST_WHOLE_WHY = ("memory: a whole-moment step holds about 7x a rank's f32 "
                  "weights (weights, gradients, old and new moments, the "
                  "updated weights); stablelm-12b's one layer and "
                  "embeddings are 2.6 GB a rank, 18 GB in the step, past the "
                  "card with four ranks; this model "
                  "cut as (e) is 1.3 GB a rank")
DIST_WHOLE_STEPS = 2
DIST_WHOLE_LR = 1e-3
#: (g)'s gates: the losses within this relative tolerance of the ZeRO-1
#: run's, each parameter leaf within DIST_WHOLE_PARAM_SHARE * max|p|
DIST_WHOLE_LOSS_RTOL = 1e-5
DIST_WHOLE_PARAM_SHARE = 1e-5

#: (h): the MoE on split experts on the same four processes as a
#: DIST_GLOO_MESH mesh (rows over data, experts over model): DBRX cut as (d)
#: cuts it, a data row of the (d) prompt's length and DIST_GLOO_STEPS decode
#: steps through each route, against the local path on rank 0: "local" at
#: the reference's capacity factor (global slots: the same pairs dropped as
#: on one device), "dense", and "ep2d" (impl="ep" under the rules
#: --moe-ep2d installs: the experts' ffn stored over data, gathered whole
#: for the prefill, split for decode) at DIST_GLOO_CAPACITY
DIST_SPLIT_ROUTES = ("local", "dense", "ep2d")
DIST_SPLIT_CAPACITY = 1.25
#: (h)'s train leg: ep2d steps with whole moments (zero1=False) against
#: the same steps on one device (rank 0, the local dispatch at
#: DIST_GLOO_CAPACITY), in f32, cut in width; (g)'s gates
DIST_SPLIT_TRAIN_CUTS = {"n_layers": 1, "d_ff": 1344, "vocab_size": 8192}
DIST_SPLIT_TRAIN_WHY = (
    "memory: a train step holds 16 B an f32 parameter element (weights, "
    "gradients, two moments); one full-width layer with the embeddings is "
    "4.49 B parameters, 23 GB a rank on the mesh (93 GB for the four) and "
    "72 GB for the one-device step the gates read; the experts' ffn cut 8x "
    "and the vocabulary to 8192 leave 0.59 B: 3.1 GB a rank, 9.4 GB for "
    "one device")
DIST_SPLIT_TRAIN_STEPS = 2

#: (i): sequence parallelism (the rule seq -> model that --seq-shard
#: installs: the training trunks and the encoder keep each rank's S / tp
#: rows between their blocks) on the same four processes as a
#: DIST_GLOO_MESH mesh, at full width: each family's f32 loss forward and
#: backward under the rule, against the same mesh without it and the local
#: path on rank 0; arch -> (cuts, the MoE route on the mesh)
DIST_SP_FAMILIES = {"stablelm-12b": ({"n_layers": 2}, "local"),
                    "dbrx-132b": (DIST_SPLIT_TRAIN_CUTS, "ep"),
                    **{a: (c, "local") for a, c in DIST_FAMILIES.items()}}
DIST_SP_WHY = ("time and memory: four processes share one card, and rank 0 "
               "holds the local path's whole f32 weights and gradients "
               "beside its shards (stablelm-12b at 2 of 40 layers with the "
               "vocabulary whole: 6.3 GB of each); dbrx-132b cut as (h)'s "
               "train leg, the SSM, hybrid, VLM and enc-dec as (e)")
#: (i)'s serving leg: the family whose prefill reads the rule (its encoder
#: splits the frames), a prefill and DIST_GLOO_STEPS decode steps in bf16
#: and f32 under the rule, with (e)'s gates against the local path
DIST_SP_SERVE = "seamless-m4t-large-v2"
#: the leaves each rank applies to its own rows only under the rule (the
#: residual norms' gains, the VLM's tanh gates, MTP's): their gradients are
#: summed over model, and the report names the worst of them
DIST_SP_ROW_LEAVES = ("ln1", "ln2", "ln_x", "ln_m", "ln_f", "gate_a",
                      "gate_m", "ln_h", "ln_e", "w_proj")


def _flash_limit_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the bf16 flash limit 2e-3 + 1e-2 |want|."""
    lo, rel = FLASH_TOL[torch.bfloat16]
    return float(((got.float() - want.float()).abs()
                  / (lo + rel * want.float().abs())).max())


def _margin_tokens(want_steps, got_steps) -> dict:
    """The serving checks' margin rule over greedy steps: at each step whose
    plain-route top-2 margin exceeds the routes' logit difference the
    tokens must agree, up to the first step where it does not."""
    compared = agreed = 0
    for want, got in zip(want_steps, got_steps):
        w, g = want.float()[:, -1], got.float()[:, -1]
        diff = (w - g).abs().max(dim=-1).values
        top2 = w.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > diff
        if not bool(sure.all()):
            break
        compared += int(sure.sum())
        agreed += int((w.argmax(-1) == g.argmax(-1)).sum())
    return {"tokens_compared": compared, "tokens_equal": agreed}


def _greedy(prefill, decode, params, toks, steps: int, device):
    """logits of the prefill and of ``steps`` greedy decode steps, and the
    prefill's and a decode step's milliseconds (host clock, synchronised)."""
    _sync(device)
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": toks})
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = [logits]
    pos = toks.shape[1]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        tok = out[-1][:, -1:].argmax(-1).to(torch.int32)
        logits, state = decode(params, tok, torch.tensor(pos + i), state)
        out.append(logits)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    return out, prefill_ms, decode_ms


def dist_moe_ep(device, sizes: dict, mesh) -> dict:
    """(a) DBRX at full width (cut as its serving phase) on the world-1
    mesh: prefill through impl="ep" (the all-to-all path) and decode steps
    through ep with ep2d, against impl="local" on the same weights; the
    flash kernel's launches of each route; prefill ms of one prompt and
    decode ms a step of DIST_DECODE_BATCH sequences on each, the routes
    timed in turns (DIST_TURNS) after a greedy run of each has warmed
    it."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import ShardingRules, default_rules
    from repro_torch.models.transformer import Runtime
    cfg, reduced = serve_config(sizes, DIST_MOE_ARCH, DIST_MOE_CUTS,
                                DIST_MOE_WHY)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rt_ep = Runtime(mesh=mesh, moe_impl="ep", moe_ep2d_decode=True)
    rules = ShardingRules(rules={**default_rules().rules,
                                 "expert_ff": "data"})
    params = model_mod.init_params(cfg, rt_ep, seed=11, rules=rules)
    rt_local = Runtime(moe_impl="local")
    S = sizes["dist_prefill_len"]
    B = sizes["dist_decode_batch"]
    max_len = sizes["dist_max_len"]
    steps = sizes["dist_decode_steps"]
    g = torch.Generator(device=device)
    g.manual_seed(12)
    one = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                        device=device, dtype=torch.int32)
    many = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=device, dtype=torch.int32)
    routes = {"local": (make_prefill_step(cfg, rt_local, max_len),
                        make_decode_step(cfg, rt_local)),
              "ep": (make_prefill_step(cfg, rt_ep, max_len, rules),
                     make_decode_step(cfg, rt_ep, rules))}
    got, launches = {}, {}
    pms = {name: [] for name in routes}
    dms = {name: [] for name in routes}
    with torch.no_grad():
        for name, (pf, dec) in routes.items():
            before = ops.launch_counts()["flash_attention"]
            got[name], _, _ = _greedy(pf, dec, params, many, steps, device)
            launches[name] = ops.launch_counts()["flash_attention"] - before
        # times in turns (local, ep, ep, local, ...), each route warm
        for name in DIST_TURNS * sizes["dist_turns"]:
            pf, dec = routes[name]
            before = ops.launch_counts()["flash_attention"]
            _sync(device)
            t0 = time.perf_counter()
            pf(params, {"tokens": one})
            _sync(device)
            pms[name].append((time.perf_counter() - t0) * 1e3)
            _, _, d_ms = _greedy(pf, dec, params, many, steps, device)
            dms[name].append(d_ms)
            launches[name] += ops.launch_counts()["flash_attention"] - before
    timing = {name: {"prefill_ms": statistics.median(pms[name]),
                     "prefill_ms_runs": pms[name], "prefill_tokens": S,
                     "decode_ms_per_step": statistics.median(dms[name]),
                     "decode_ms_runs": dms[name], "decode_batch": B,
                     "decode_steps_a_run": steps}
              for name in routes}
    timing["ep_over_local"] = {
        k: timing["ep"][k] / timing["local"][k]
        for k in ("prefill_ms", "decode_ms_per_step")}
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if device.type == "cuda" else None)
    shares = [_flash_limit_share(a, b) for a, b in zip(got["ep"],
                                                      got["local"])]
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got["ep"], got["local"])]
    out = {"arch": cfg.name, "reduced": reduced, "dtype": cfg.dtype,
           "routes": {"prefill": "impl='ep' (all-to-all over model)",
                      "decode": "impl='ep', ep2d (experts over model, "
                                "their ffn over data)",
                      "against": "impl='local', the same weights"},
           "max_abs_err": max(errs), "share_of_limit": max(shares),
           "tolerance": "2e-3 + 1e-2 * |local| on every logit (the bf16 "
                        "flash limit)",
           **_margin_tokens(got["local"], got["ep"]),
           "flash_launches": launches, "timing": timing,
           "engine_timing_ms_perf_md": {"prefill": 40.05,
                                        "decode_per_step": 22.20},
           "peak_memory_gb": peak}
    check(max(shares) <= 1.0 and out["tokens_equal"] ==
          out["tokens_compared"],
          f"(a) the ep route's logits or tokens differ from the local "
          f"route's: {out}")
    check(launches["ep"] == launches["local"]
          and (launches["ep"] > 0 or device.type != "cuda"),
          f"(a) flash launches differ between the routes: {launches}")
    del params
    return out


def dist_train(device, sizes: dict, mesh, timer) -> tuple:
    """(b) TRAIN_ARCH at full width in bf16 (cut as the train phase is)
    through make_train_step(rules=...) with ZeRO-1 specs on the world-1
    mesh: step ms, tokens/s after the first step, peak memory; then the
    reduced config in f32 (TF32 off): CARD_VS_HOST_STEPS steps on the mesh
    against the single-device make_train_step, losses within rtol
    CARD_VS_HOST_RTOL. Returns (report, the f32 mesh state after two
    steps, its config, the mesh runtime, the batches)."""
    import dataclasses

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import OptConfig
    cfg, reduced = serve_config(sizes, TRAIN_ARCH, TRAIN_CUTS, TRAIN_CUT_WHY)
    shape = SHAPES_BY_NAME["train_4k"]
    B = sizes["train_batch"]
    S = shape.seq_len if not sizes["serve_reduced"] else \
        shape.reduced().seq_len
    shape = dataclasses.replace(shape, seq_len=S, global_batch=B)
    rt = Runtime(mesh=mesh)
    rules = default_rules()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, rt, model_mod.init_params(
        cfg, rt, seed=21, rules=rules), rules=rules)
    step = make_train_step(cfg, rt, OptConfig(), rules=rules)
    step_ms, losses = [], []
    for i in range(sizes["dist_train_steps"]):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in make_batch(cfg, shape, i).items()}
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if device.type == "cuda" else None)
    del state, step
    tokens = B * S
    report = {"arch": cfg.name, "dtype": cfg.dtype, "reduced": reduced,
              "shape": {"seq_len": S, "global_batch": B},
              "zero1": "moments split over the batch axes (data = 1)",
              "step_ms": step_ms,
              "tokens_per_s_after_first": tokens * (len(step_ms) - 1)
              / (sum(step_ms[1:]) / 1e3),
              "peak_memory_gb": peak, "losses": losses,
              "train_phase_perf_md": {"step_ms": 689.0,
                                      "tokens_per_s": 11884.0,
                                      "peak_memory_gb": 48.42}}
    check(all(math.isfinite(x) for x in losses),
          f"(b) the losses are not finite: {report}")
    # the reduced config in f32: the mesh step against one device's
    rcfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                               dtype="float32")
    rshape = SHAPES_BY_NAME["train_4k"].reduced()
    host, card = _train_states(rcfg, device, seed=41)
    del host
    one = make_train_step(rcfg, Runtime(), OptConfig())
    on_mesh = make_train_step(rcfg, rt, OptConfig(), rules=rules)
    s1 = card
    sm = init_train_state(rcfg, rt, card["params"], rules=rules)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in make_batch(rcfg, rshape, i).items()}
               for i in range(CARD_VS_HOST_STEPS)]
    l1, lm, kept = [], [], None
    for i, batch in enumerate(batches):
        s1, m1 = one(s1, batch)
        sm, mm = on_mesh(sm, batch)
        l1.append(float(m1["loss"]))
        lm.append(float(mm["loss"]))
        if i == CARD_VS_HOST_STEPS - 2:
            from repro_torch.tree import tree_map
            kept = tree_map(torch.clone, sm)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lm, l1))
    report["f32_check"] = {"config": "reduced() in f32, TF32 off",
                           "steps": CARD_VS_HOST_STEPS,
                           "losses_mesh": lm, "losses_one_device": l1,
                           "max_loss_rel_diff": rel,
                           "tolerance": f"rtol {CARD_VS_HOST_RTOL}"}
    check(rel <= CARD_VS_HOST_RTOL,
          f"(b) the mesh train step differs from one device's: {report}")
    return report, kept, rcfg, rt, batches, lm


def dist_elastic(device, mesh, state, cfg, rt, batches, losses) -> dict:
    """(c) the f32 state of (b) after CARD_VS_HOST_STEPS - 1 mesh steps,
    saved (gathered) under build/, elastic_restore onto shrink_mesh() (the
    1 x 1 mesh of the surviving world): every leaf back bit for bit, and
    the next step's loss equal to the uninterrupted step's."""
    import shutil

    from repro_torch.checkpoint import save
    from repro_torch.launch.elastic import elastic_restore, shrink_mesh
    from repro_torch.launch.steps import (make_train_step,
                                          train_state_shardings)
    from repro_torch.models.common import default_rules
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves_with_paths
    ckpt = os.path.join(HERE, "build", "dist_elastic")
    shutil.rmtree(ckpt, ignore_errors=True)
    n = CARD_VS_HOST_STEPS - 1
    save(ckpt, n, state, shardings=train_state_shardings(cfg, rt))
    new_mesh = shrink_mesh(model_axis=1, device_type=mesh.device_type)
    back, step, rt_new = elastic_restore(ckpt, cfg, rt, new_mesh)
    shutil.rmtree(ckpt, ignore_errors=True)
    want = dict(leaves_with_paths(state))
    got = dict(leaves_with_paths(back))
    same = (want.keys() == got.keys() and all(
        torch.equal(want[k], got[k]) and want[k].dtype == got[k].dtype
        for k in want))
    _, m = make_train_step(cfg, rt_new, OptConfig(),
                           rules=default_rules())(back, batches[n])
    out = {"config": "the f32 state of (b)'s check, after "
                     f"{n} mesh steps", "restored_step": step,
           "new_mesh": dict(new_mesh.shape), "leaves": len(want),
           "bit_for_bit": bool(same),
           "next_loss": float(m["loss"]), "uninterrupted_loss": losses[n],
           "checkpoint": "build/dist_elastic (removed after)"}
    check(same and step == n and out["next_loss"] == losses[n],
          f"(c) elastic restore did not give the state back: {out}")
    return out


def _probe_collectives(group, device) -> dict:
    """Which of DIST_GLOO_COLLECTIVES the process group takes on tensors
    of ``device`` in the model's dtypes: "ok", or the error's first line."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = {}
    for name in DIST_GLOO_COLLECTIVES:
        res = []
        for dt in (torch.bfloat16, torch.float32):
            x = torch.ones(4 * n, dtype=dt, device=device)
            try:
                if name == "all_reduce":
                    dist.all_reduce(x, group=group)
                elif name == "all_to_all_single":
                    dist.all_to_all_single(torch.empty_like(x), x,
                                           group=group)
                elif name == "all_gather_into_tensor":
                    dist.all_gather_into_tensor(
                        x.new_empty(4 * n * n), x, group=group)
                else:
                    dist.reduce_scatter_tensor(x.new_empty(4), x,
                                               group=group)
                _sync(device)
                res.append("ok")
            except RuntimeError as exc:
                res.append(f"{dt}: " + str(exc).strip().splitlines()[0][:160])
        out[name] = "ok" if res == ["ok", "ok"] else "; ".join(
            r for r in res if r != "ok")
    return out


def _widen(tree) -> None:
    """Every tensor leaf of a params tree in f32, in place, leaf by leaf
    (each narrow leaf is freed as its wide copy takes its place)."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, torch.Tensor):
            tree[k] = v.float()
        else:
            _widen(v)


def _gloo_leg(cfg, rt, params, rules, toks, fed, greedy: bool, sizes,
              device) -> dict:
    """(d)'s run of one dtype on this rank: a prefill of its rows through
    impl="ep", then (when ``fed``, a list of this rank's tokens a step, is
    given) DIST_GLOO_STEPS ep2d decode steps, each fed the argmax of the
    last logits, appended to ``fed`` (``greedy``), or ``fed``'s token; the
    logits of each, and their times. ``params`` is cut to the 2D layout on
    the way."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import ShardingRules
    from repro_torch.parallel import collectives as coll
    mesh = rt.mesh
    out = {}
    ops.reset_launch_counts()
    with torch.no_grad():
        prefill = make_prefill_step(cfg, rt, sizes["dist_max_len"], rules)
        _sync(device)
        t0 = time.perf_counter()
        logits, state = prefill(params, {"tokens": toks})
        _sync(device)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["flash_launches"] = ops.launch_counts()["flash_attention"]
        steps_out = [logits]
        if fed is not None:
            # the same weights in the 2D layout: each rank keeps its data
            # row's slice of its experts' ffn
            dgrp = mesh.group("data")
            for layer in params["layers"]:
                ex = layer["mlp"]["experts"]
                ex["wi"] = coll.chunk(ex["wi"], 2, dgrp)
                ex["wg"] = coll.chunk(ex["wg"], 2, dgrp)
                ex["wo"] = coll.chunk(ex["wo"], 1, dgrp)
            rules2d = ShardingRules(rules={**rules.rules,
                                           "expert_ff": "data"})
            decode = make_decode_step(cfg, rt, rules2d)
            pos = toks.shape[1]
            _sync(device)
            t0 = time.perf_counter()
            for i in range(DIST_GLOO_STEPS):
                if greedy:
                    fed.append(steps_out[-1][:, -1:].argmax(-1).to(
                        torch.int32))
                logits, state = decode(params, fed[i], torch.tensor(pos + i),
                                       state)
                steps_out.append(logits)
            _sync(device)
            out["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                         / DIST_GLOO_STEPS)
    out["logits"] = steps_out
    return out


def _gloo_cfg(cfg, dtype: str):
    """(d)'s config for its run in ``dtype`` (the f32 run cut to
    DIST_GLOO_F32_LAYERS), and the config its weights are drawn in (bf16,
    from seed 31: the f32 run's weights are those widened)."""
    import dataclasses
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, n_layers=DIST_GLOO_F32_LAYERS)
    return (dataclasses.replace(cfg, dtype=dtype),
            dataclasses.replace(cfg, dtype=DIST_GLOO_DTYPES[0]))


def _gloo_rank(rank: int, world: int, store_path: str, out_path: str,
               device_type: str, sizes: dict) -> None:
    """One of the (d) ranks: gloo over ``device_type`` tensors on the one
    card (or the CPU in the rehearsal): probe the collectives, then each
    leg whose collectives gloo takes, DBRX (cut to DIST_GLOO_CUTS) on a
    DIST_GLOO_MESH mesh: prefill through impl="ep", and decode steps
    through ep with ep2d, in each of DIST_GLOO_DTYPES (:func:`_gloo_cfg`),
    the f32 run fed the tokens the bf16 run chose; rank 0 writes the
    logits, the tokens and the times."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel.sharding import NamedSharding
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    report = {"rank": rank}
    try:
        report["probe"] = _probe_collectives(None, device)
        cfg, _ = serve_config(sizes, DIST_MOE_ARCH, DIST_GLOO_CUTS)
        mesh = make_host_mesh(*DIST_GLOO_MESH, device_type=device_type)
        tp = mesh.shape["model"]
        rt = Runtime(tp=tp, mesh=mesh, moe_impl="ep", moe_ep2d_decode=True,
                     moe_capacity_factor=DIST_GLOO_CAPACITY)
        rules = default_rules()
        rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
        g = torch.Generator(device=device)
        g.manual_seed(32)
        B = DIST_GLOO_MESH[0]
        toks = torch.randint(0, cfg.vocab_size, (B, sizes["dist_gloo_prompt"]),
                             generator=g, device=device, dtype=torch.int32)
        legs = {}
        for leg, needs in DIST_GLOO_LEGS.items():
            refused = [n for n in needs if report["probe"][n] != "ok"]
            legs[leg] = ("run" if not refused else
                         f"not run: gloo refused {', '.join(refused)} on "
                         f"{device_type} tensors")
        report["legs"] = legs
        if legs["ep_prefill"] == "run":
            fed = [] if legs["ep2d_decode"] == "run" else None
            runs = {}
            for dt in DIST_GLOO_DTYPES:
                dcfg, drawn = _gloo_cfg(cfg, dt)
                params = model_mod.init_params(drawn, rt, seed=31,
                                               rules=rules)
                if dt == "float32":
                    _widen(params)
                res = _gloo_leg(dcfg, rt, params, rules, rows.shard(toks),
                                fed, dt == DIST_GLOO_DTYPES[0], sizes,
                                device)
                del params
                runs[dt] = {"logits": [rows.gather(t).float().cpu()
                                       for t in res.pop("logits")], **res}
                if device_type == "cuda":
                    torch.cuda.empty_cache()
            report["runs"] = {dt: {k: v for k, v in r.items()
                                   if k != "logits"}
                              for dt, r in runs.items()}
            peak = (torch.cuda.max_memory_allocated(device) / 1e9
                    if device_type == "cuda" else None)
            peaks = [None] * world
            dist.all_gather_object(peaks, peak)
            report["peak_memory_gb_by_rank"] = peaks
            fed_whole = [rows.gather(t).cpu() for t in (fed or [])]
            if rank == 0:
                torch.save({"tokens": toks.cpu(), "fed": fed_whole,
                            "logits": {dt: r["logits"]
                                       for dt, r in runs.items()}},
                           out_path + ".pt")
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _memory_now(device) -> dict:
    """Free memory on the card (every process's use counted, by
    cudaMemGetInfo; None off the card), the host's MemAvailable and this
    container's cgroup use, in GB."""
    out = {"device_free_gb": None, "host_available_gb": None,
           "cgroup_used_gb": None}
    if device.type == "cuda":
        with contextlib.suppress(RuntimeError):
            out["device_free_gb"] = torch.cuda.mem_get_info(device)[0] / 1e9
    with contextlib.suppress(OSError, ValueError, IndexError):
        with open("/proc/meminfo") as f:
            kb = next(int(line.split()[1]) for line in f
                      if line.startswith("MemAvailable:"))
        out["host_available_gb"] = kb * 1024 / 1e9
    with contextlib.suppress(OSError, ValueError):
        with open("/sys/fs/cgroup/memory.current") as f:
            out["cgroup_used_gb"] = int(f.read()) / 1e9
    return out


class _Headroom:
    """The least free memory on the card and on the host, and the most the
    container's cgroup held, while a gloo phase's ranks run: sampled every
    0.2 s on a thread of the parent (:func:`_memory_now`)."""

    def __init__(self, device):
        import threading
        self.device = device
        self.samples = 0
        self.worst = {"device_free_gb": None, "host_available_gb": None,
                      "cgroup_used_gb": None}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        for k, v in _memory_now(self.device).items():
            if v is not None:
                w = self.worst[k]
                pick = max if k == "cgroup_used_gb" else min
                self.worst[k] = v if w is None else pick(w, v)
        self.samples += 1

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            self._sample()

    def stop(self) -> dict:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join()
            self._sample()
        return {**self.worst, "samples": self.samples}


#: each gloo phase's memory headroom (:class:`_Headroom`), by its name
GLOO_HEADROOM: dict = {}
#: a gloo rank's error text that only says a peer went away first
PEER_GONE = ("Connection closed by peer", "Connection reset by peer",
             "Broken pipe")


def _gloo_entry(rank: int, target, world: int, store_path: str,
                out_path: str, device_type: str, sizes: dict) -> None:
    """Run one gloo rank's ``target``; if it raises, write its traceback and
    the memory it saw to ``<out_path>.rank<rank>.err`` first, so that the
    parent can name the rank that failed first."""
    try:
        target(rank, world, store_path, out_path, device_type, sizes)
    except BaseException:
        import traceback
        text = traceback.format_exc()
        device = (torch.device("cuda", 0) if device_type == "cuda"
                  else torch.device("cpu"))
        with open(f"{out_path}.rank{rank}.err", "w") as f:
            f.write(f"{text}memory when it failed: {_memory_now(device)}\n")
        raise


def _gloo_failure(name: str, out_path: str, codes: list,
                  headroom: dict) -> str:
    """Print every failed rank's traceback to stderr, the rank that failed
    first (its error not one of PEER_GONE) last, and return one line that
    names it, its error, each rank's exit code and the phase's headroom."""
    errs = {}
    for rank in range(len(codes)):
        path = f"{out_path}.rank{rank}.err"
        if os.path.exists(path):
            with open(path) as f:
                errs[rank] = f.read()
    first = [r for r, t in errs.items() if not any(s in t for s in PEER_GONE)]
    for rank in sorted(errs, key=lambda r: r in first):
        print(f"== ({name}) rank {rank} (exit code {codes[rank]}):\n"
              f"{errs[rank]}", file=sys.stderr)
    lasts = {r: next((line for line in reversed(errs[r].splitlines())
                      if line and not line.startswith("memory when")), "")
             for r in first}
    why = (f"rank {first[0]} failed first: {lasts[first[0]]}" if first else
           "no rank left an error of its own (a rank killed, or every error "
           "names a peer gone)")
    return (f"({name}) a gloo rank failed: {why}; exit codes by rank "
            f"{codes}; headroom over the phase {headroom}")


def _spawn_gloo(target, name: str, device, sizes: dict):
    """``target(rank, world, store, out_path, device_type, sizes)`` on the
    DIST_GLOO_MESH ranks, spawned with torch.multiprocessing, a FileStore
    and rank 0's ``out_path`` under ``build/<name>``: (rank 0's report,
    the wall seconds, ``out_path``). The memory headroom while they run is
    kept in GLOO_HEADROOM[name]; if a rank fails, the error names the rank
    that failed first (:func:`_gloo_failure`)."""
    import shutil

    import torch.multiprocessing as mp
    world = DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1]
    work = os.path.join(HERE, "build", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out_path = os.path.join(work, "rank0.json")
    watch = _Headroom(device)
    t0 = time.perf_counter()
    # four ranks and the parent share the one card: each rank's allocator
    # maps its blocks as expandable segments (unless the caller chose a
    # setting), so that its cache holds little beyond what it has allocated
    mine = "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    if mine:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ctx = mp.start_processes(_gloo_entry, args=(
            target, world, os.path.join(work, "store"), out_path,
            device.type, sizes), nprocs=world, join=False,
            start_method="spawn")
    finally:
        if mine:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    try:
        while not ctx.join():
            pass
    except Exception as exc:
        for p in ctx.processes:
            p.join()
        raise RuntimeError(_gloo_failure(
            name, out_path, [p.exitcode for p in ctx.processes],
            watch.stop())) from exc
    finally:
        GLOO_HEADROOM[name] = watch.stop()
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        return json.load(f), wall, out_path


def _logit_gates(have: dict, l16: list, l32_wide: list, l32: list) -> dict:
    """The gates of (d) and (e) on each step's logits: the f32 mesh
    (``have["float32"]``) against the f32 local path ``l32`` within
    DIST_GLOO_F32_RTOL * max|logits|, and the bf16 mesh's distance from the
    f32 local path at its layers (``l32_wide``) at most
    DIST_GLOO_BF16_FACTOR times the bf16 local path's (``l16``): the steps'
    distances and each gate's worst share of its limit."""
    amax = lambda a, b: float((a - b).abs().max())  # noqa: E731
    steps = [{"bf16_mesh_vs_local": amax(have["bfloat16"][i], l16[i]),
              "bf16_mesh_vs_local_f32": amax(have["bfloat16"][i],
                                             l32_wide[i]),
              "bf16_local_vs_local_f32": amax(l16[i], l32_wide[i]),
              "f32_mesh_vs_local": amax(have["float32"][i], l32[i]),
              "max_abs_logit_f32": float(l32[i].abs().max())}
             for i in range(len(l32))]
    return {
        "steps": steps,
        "f32_share_of_limit": max(
            r["f32_mesh_vs_local"]
            / (DIST_GLOO_F32_RTOL * r["max_abs_logit_f32"]) for r in steps),
        "bf16_share_of_limit": max(
            r["bf16_mesh_vs_local_f32"]
            / (DIST_GLOO_BF16_FACTOR * r["bf16_local_vs_local_f32"])
            for r in steps)}


def dist_gloo_on_card(device, sizes: dict) -> dict:
    """(d) four processes on the one card over gloo (DIST_GLOO_MESH),
    started with torch.multiprocessing; then the local path on the card
    from the same seed, fed the tokens the mesh chose, as each of the
    ranks' runs (:func:`_gloo_cfg`) and in f32 at the bf16 run's layers:
    each step's logits, the f32 mesh's against the f32 local path (within
    DIST_GLOO_F32_RTOL * max|logits|), the bf16 mesh's distance from the
    f32 local path at its layers against the bf16 local path's (at most
    DIST_GLOO_BF16_FACTOR times it), and the bf16 routes' tokens by the
    margin rule. The legs' times go through gloo's host staging:
    reported, not gated."""
    import dataclasses
    import shutil

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Runtime
    parent_gb = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
        parent_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
                     "reserved": torch.cuda.memory_reserved() / 1e9}
    rep, wall, out_path = _spawn_gloo(_gloo_rank, "dist_gloo", device, sizes)
    out = {"backend": "gloo", "world": DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1],
           "mesh": dict(zip(("data", "model"), DIST_GLOO_MESH)),
           "device": device.type, "probe": rep["probe"],
           "legs": rep["legs"], "wall_s": wall,
           "runs": rep.get("runs"),
           "peak_memory_gb_by_rank": rep.get("peak_memory_gb_by_rank"),
           "parent_memory_gb_at_spawn": parent_gb,
           "timing_note": "host-staged gloo collectives: reported, not "
                          "gated"}
    if os.path.exists(out_path + ".pt"):
        got = torch.load(out_path + ".pt")
        cfg, reduced = serve_config(sizes, DIST_MOE_ARCH, DIST_GLOO_CUTS,
                                    DIST_GLOO_WHY)
        out["reduced"] = reduced
        rt = Runtime(moe_impl="local")
        toks = got["tokens"].to(device)
        have = got["logits"]

        def local(run_cfg, drawn, widen: bool) -> list:
            """the local path's logits a step, fed the tokens the mesh
            chose, on weights drawn as the ranks drew them"""
            params = model_mod.init_params(
                drawn, Runtime(tp=DIST_GLOO_MESH[1]), seed=31, device=device)
            if widen:
                _widen(params)
            with torch.no_grad(), patched(moe_mod, "CAPACITY_FACTOR",
                                          DIST_GLOO_CAPACITY):
                logits, state = make_prefill_step(
                    run_cfg, rt, sizes["dist_max_len"])(params,
                                                        {"tokens": toks})
                steps_out = [logits.float().cpu()]
                decode = make_decode_step(run_cfg, rt)
                for i, tok in enumerate(got["fed"]):
                    logits, state = decode(
                        params, tok.to(device),
                        torch.tensor(toks.shape[1] + i), state)
                    steps_out.append(logits.float().cpu())
            return steps_out

        # bf16 and f32 at the bf16 run's layers (the bf16 gate), f32 at the
        # f32 run's (the f32 gate)
        bf16_cfg, drawn = _gloo_cfg(cfg, "bfloat16")
        l16 = local(bf16_cfg, drawn, False)
        l32_wide = local(dataclasses.replace(bf16_cfg, dtype="float32"),
                         drawn, True)
        l32 = local(*_gloo_cfg(cfg, "float32"), True)
        want = {"bfloat16": l16, "float32": l32}
        out.update(_logit_gates(have, l16, l32_wide, l32))
        out["max_abs_err"] = max(r["bf16_mesh_vs_local"]
                                 for r in out["steps"])
        out["share_of_bf16_flash_limit"] = max(
            _flash_limit_share(a, b)
            for a, b in zip(have["bfloat16"], want["bfloat16"]))
        out["tolerance"] = (
            f"each step: f32 mesh - f32 local <= {DIST_GLOO_F32_RTOL} * "
            f"max|f32 local|; bf16 mesh - f32 local <= "
            f"{DIST_GLOO_BF16_FACTOR} * (bf16 local - f32 local)")
        out.update(_margin_tokens(want["bfloat16"], have["bfloat16"]))
        check(all(bool(torch.isfinite(a).all()) and a.shape == b.shape
                  for dt in DIST_GLOO_DTYPES
                  for a, b in zip(have[dt], want[dt]))
              and len(have["float32"]) == len(want["float32"])
              == len(got["fed"]) + 1
              and out["tokens_equal"] == out["tokens_compared"],
              f"(d) the gloo mesh's logits are malformed or its tokens "
              f"differ from the local path's by the margin rule: {out}")
        check(out["f32_share_of_limit"] <= 1.0
              and out["bf16_share_of_limit"] <= 1.0,
              f"(d) the gloo mesh's logits are further from the local "
              f"path's than rounding: {out}")
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    return out


def _family_params(cfg, rt, device, rules=None):
    """(e)'s weights of ``cfg`` in bf16 from DIST_FAMILIES_SEED (this
    rank's shards under ``rt.mesh``, whole without), the VLM's tanh gates
    drawn N(0, 1) (zeros at init, which would cut its cross blocks out of
    the logits and the gradients), widened to f32 for an f32 ``cfg``."""
    import dataclasses

    from repro_torch.models import model as model_mod
    drawn = dataclasses.replace(cfg, dtype=DIST_GLOO_DTYPES[0])
    params = model_mod.init_params(drawn, rt, seed=DIST_FAMILIES_SEED,
                                   device=device, rules=rules)
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(DIST_FAMILIES_SEED)
        for block in params["layers"]["cross"]:
            for name in ("gate_a", "gate_m"):
                block[name].copy_(torch.randn(block[name].shape, generator=g))
    if cfg.dtype == "float32":
        _widen(params)
    return params


def _family_run(cfg, rt, params, batch, fed, greedy: bool, sizes, device,
                rows=None, rules=None) -> dict:
    """A prefill of ``batch`` and DIST_GLOO_STEPS decode steps (each fed
    the argmax of the last logits, appended to ``fed`` when ``greedy``, or
    ``fed``'s token), on ``rt``'s route: the logits of each (gathered over
    the batch's rows by ``rows``), the flash launches by call shape, the
    times (host clock, synchronised) after one untimed, uncounted
    prefill, and the bytes of this rank's decode state. ``rules``: the
    steps' sharding rules (default: the mesh's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.tree import tree_leaves
    whole = (lambda t: t) if rows is None else rows.gather
    local = (lambda t: t) if rows is None else rows.shard
    out = {}
    with torch.no_grad():
        prefill = make_prefill_step(cfg, rt, sizes["dist_max_len"], rules)
        decode = make_decode_step(cfg, rt, rules)
        prefill(params, batch)
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        logits, state = prefill(params, batch)
        _sync(device)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        steps_out = [whole(logits)]
        pos = batch["tokens"].shape[1]
        _sync(device)
        t0 = time.perf_counter()
        for i in range(DIST_GLOO_STEPS):
            if greedy:
                fed.append(steps_out[-1][:, -1:].argmax(-1).to(torch.int32))
            logits, state = decode(params, local(fed[i]),
                                   torch.tensor(pos + i), state)
            steps_out.append(whole(logits))
        _sync(device)
        out["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                     / DIST_GLOO_STEPS)
    out["flash_launches_by_shape"] = dict(fa.LAUNCHES_BY_SHAPE)
    out["logits"] = [t.float().cpu() for t in steps_out]
    out["state_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(state))
    return out


def _family_loss(cfg, rt, params, batch, device):
    """(gradient, loss, ms) of ``loss_fn`` forward and backward, timed at
    its second call; under a mesh each leaf averaged over the data axis,
    as the train step does."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel import collectives as coll
    from repro_torch.tree import tree_map
    steps_mod._grads(cfg, rt, params, batch)
    _sync(device)
    t0 = time.perf_counter()
    g, metrics = steps_mod._grads(cfg, rt, params, batch)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    if rt.mesh is not None:
        grp, n = rt.mesh.group("data"), rt.mesh.shape["data"]
        g = tree_map(lambda t: coll.all_reduce(t, grp) / n, g)
    return g, float(metrics["loss"]), ms


def _family_attn_impl(cfg, dtype: str) -> tuple:
    """(attention route, why) of an (e) or (f) ``dtype`` run: the kernel,
    or the plain route where the flash kernel of that dtype is not built
    at the config's head dims (MLA's are (qk_nope + qk_rope, v_head_dim));
    both kernels take every head dim up to 256, so every family's run
    takes the kernel, mesh and local path alike."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_tiles
    from repro_torch.models.common import torch_dtype
    if not cfg.n_heads:
        return "kernel", None
    dt = torch_dtype(dtype)
    dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
            if cfg.use_mla else (cfg.resolved_head_dim,) * 2)
    why = fa.unsupported(dt.itemsize, *dims, *flash_tiles(dt, dims))
    return ("plain", why) if why else ("kernel", None)


def _gloo_family(arch: str, rank: int, mesh, sizes, device) -> dict:
    """One family of (e) on this rank: the mesh's bf16 prefill and greedy
    decode steps, its f32 ones fed the same tokens, and its f32 loss
    forward and backward; then rank 0 runs the local path (no mesh, whole
    weights from the same seed) the same way, and holds each gathered
    gradient leaf against its own. Returns rank 0's report (the others':
    their launches and times)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models import model as model_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import (NamedSharding,
                                               named_sharding_tree)
    from repro_torch.tree import leaves_with_paths, tree_leaves
    cfg, reduced = serve_config(sizes, arch, DIST_FAMILIES[arch],
                                DIST_FAMILIES_WHY)
    tp, B = mesh.shape["model"], DIST_GLOO_MESH[0]
    S = sizes["dist_gloo_prompt"]
    rules = default_rules()
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    g = torch.Generator(device=device)
    g.manual_seed(DIST_FAMILIES_SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=device, dtype=torch.int32)
    fe = (draw_frontend(dataclasses.replace(cfg, dtype="float32"), B, g,
                        device) if cfg.frontend_seq else None)

    def batch_of(dtype, tokens, shard):
        b = {"tokens": tokens}
        if fe is not None:
            b["frontend"] = fe.to(getattr(torch, dtype))
        return {k: rows.shard(v) for k, v in b.items()} if shard else b

    rep = {"arch": arch, "reduced": reduced, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "prompt_len": S, "batch": B,
           "decode_steps": DIST_GLOO_STEPS}
    mesh_runs, fed = {}, []
    for dt in DIST_GLOO_DTYPES:
        run_cfg = dataclasses.replace(cfg, dtype=dt)
        impl, why = _family_attn_impl(cfg, dt)
        rt = Runtime(tp=tp, mesh=mesh, attn_impl=impl)
        params = _family_params(run_cfg, rt, device, rules)
        mesh_runs[dt] = _family_run(run_cfg, rt, params,
                                    batch_of(dt, toks[:, :S], True), fed,
                                    dt == DIST_GLOO_DTYPES[0], sizes, device,
                                    rows)
        mesh_runs[dt]["attn_impl"] = impl
        if why:
            mesh_runs[dt]["attn_plain_why"] = why
        if dt == "float32":
            specs = model_mod.param_specs(run_cfg, rt)
            g_mesh, loss_mesh, ms = _family_loss(
                run_cfg, rt, params, batch_of(dt, toks, True), device)
            mesh_runs[dt]["loss_fwd_bwd_ms"] = ms
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {
        dt: {k: v for k, v in r.items() if k != "logits"}
        for dt, r in mesh_runs.items()})
    rep["mesh_by_rank"] = by_rank
    local_runs, g_local = {}, None
    if rank == 0:
        for dt in DIST_GLOO_DTYPES:
            run_cfg = dataclasses.replace(cfg, dtype=dt)
            rt1 = Runtime(tp=tp, attn_impl=_family_attn_impl(cfg, dt)[0])
            params = _family_params(run_cfg, rt1, device)
            local_runs[dt] = _family_run(
                run_cfg, rt1, params, batch_of(dt, toks[:, :S], False),
                fed, False, sizes, device)
            if dt == "float32":
                g_local, loss_local, ms = _family_loss(
                    run_cfg, rt1, params, batch_of(dt, toks, False), device)
                local_runs[dt]["loss_fwd_bwd_ms"] = ms
            del params
            if device.type == "cuda":
                torch.cuda.empty_cache()
    # each gradient leaf: averaged over data above, gathered whole over
    # model here (every rank takes part), held against the local one on 0
    local_leaves = dict(leaves_with_paths(g_local)) if rank == 0 else {}
    shardings = tree_leaves(named_sharding_tree(specs, mesh))
    worst, worst_leaf, leaves, zero = 0.0, None, 0, []
    for (path, t), sh in zip(leaves_with_paths(g_mesh), shardings):
        have = sh.gather(t)
        if rank == 0:
            want = local_leaves[path]
            lim = DIST_FAMILIES_GRAD_SHARE * float(want.abs().max())
            share = (float((have - want).abs().max()) / lim if lim > 0
                     else math.inf)
            if share >= worst:
                worst, worst_leaf = share, path
            leaves += 1
            if not bool(have.abs().max() > 0):
                zero.append(path)
        del have
    del g_mesh, g_local, local_leaves
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    rep["peak_memory_gb_by_rank"] = peaks
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if rank != 0:
        return rep
    rep["local"] = {dt: {k: v for k, v in r.items() if k != "logits"}
                    for dt, r in local_runs.items()}
    have = {dt: r["logits"] for dt, r in mesh_runs.items()}
    want = {dt: r["logits"] for dt, r in local_runs.items()}
    rep.update(_logit_gates(have, want["bfloat16"], want["float32"],
                            want["float32"]))
    rep.update(_margin_tokens(want["bfloat16"], have["bfloat16"]))
    rep["shapes_ok"] = all(
        bool(torch.isfinite(a).all()) and a.shape == b.shape
        for dt in DIST_GLOO_DTYPES for a, b in zip(have[dt], want[dt])) and (
        len(have["float32"]) == len(want["float32"]) == DIST_GLOO_STEPS + 1)
    rep["loss"] = {"mesh": loss_mesh, "local": loss_local,
                   "rel_diff": abs(loss_mesh - loss_local) / abs(loss_local)}
    rep["grads"] = {"leaves": leaves, "worst_share_of_limit": worst,
                    "worst_leaf": worst_leaf, "zero_leaves": zero}
    rep["flash_launches_equal_on_every_rank"] = {
        dt: all(r[dt]["flash_launches_by_shape"]
                == local_runs[dt]["flash_launches_by_shape"]
                for r in by_rank) for dt in DIST_GLOO_DTYPES}
    return rep


def _gloo_family_rank(rank: int, world: int, store_path: str, out_path: str,
                      device_type: str, sizes: dict) -> None:
    """One of the (e) ranks: gloo over ``device_type`` tensors on the one
    card (or the CPU in the rehearsal), TF32 off: probe
    DIST_FAMILIES_COLLECTIVES, then, when gloo takes them all, each of
    DIST_FAMILIES on a DIST_GLOO_MESH mesh (:func:`_gloo_family`); rank 0
    writes the reports."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    report = {"rank": rank}
    try:
        probe = _probe_collectives(None, device)
        report["probe"] = {n: probe[n] for n in DIST_FAMILIES_COLLECTIVES}
        report["refused"] = [n for n, v in report["probe"].items()
                             if v != "ok"]
        if not report["refused"]:
            mesh = make_host_mesh(*DIST_GLOO_MESH, device_type=device_type)
            report["families"] = {}
            for arch in DIST_FAMILIES:
                t0 = time.perf_counter()
                rep = _gloo_family(arch, rank, mesh, sizes, device)
                rep["seconds"] = time.perf_counter() - t0
                report["families"][arch] = rep
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dist_gloo_families(device, sizes: dict) -> dict:
    """(e) four processes on the one card over gloo (DIST_GLOO_MESH),
    started with torch.multiprocessing: the SSM, hybrid, VLM and enc-dec
    forwards split over model (:func:`_gloo_family`), each against the
    local path on rank 0: every step's f32 logits within
    DIST_GLOO_F32_RTOL * max|logits|, the bf16 logits' distance from the
    local f32 path at most DIST_GLOO_BF16_FACTOR times the local bf16
    path's, the bf16 tokens by the margin rule, the f32 loss within
    DIST_FAMILIES_LOSS_RTOL and every gradient leaf within
    DIST_FAMILIES_GRAD_SHARE * max|g| and nonzero, and each rank's flash
    launches by call shape equal to the local path's. Times and peak
    memory are reported, not gated."""
    import shutil
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rep, wall, out_path = _spawn_gloo(_gloo_family_rank, "dist_families",
                                      device, sizes)
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    check(not rep["refused"],
          f"(e) gloo refused {rep['refused']} on {device.type} tensors: "
          f"{rep['probe']}")
    out = {"backend": "gloo", "world": DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1],
           "mesh": dict(zip(("data", "model"), DIST_GLOO_MESH)),
           "device": device.type, "probe": rep["probe"], "wall_s": wall,
           "families": rep["families"],
           "tolerance": (
               f"each step: f32 mesh - f32 local <= {DIST_GLOO_F32_RTOL} * "
               f"max|f32 local|; bf16 mesh - f32 local <= "
               f"{DIST_GLOO_BF16_FACTOR} * (bf16 local - f32 local); f32 "
               f"loss rtol {DIST_FAMILIES_LOSS_RTOL}; each gradient leaf "
               f"within {DIST_FAMILIES_GRAD_SHARE} * max|local leaf|"),
           "timing_note": "host-staged gloo collectives: reported, not "
                          "gated"}
    for arch, r in rep["families"].items():
        check(r["shapes_ok"] and r["tokens_equal"] == r["tokens_compared"],
              f"(e) {arch}: the mesh's logits are malformed or its tokens "
              f"differ from the local path's by the margin rule: {r}")
        check(r["f32_share_of_limit"] <= 1.0
              and r["bf16_share_of_limit"] <= 1.0,
              f"(e) {arch}: the mesh's logits are further from the local "
              f"path's than rounding: {r['steps']}")
        check(r["loss"]["rel_diff"] <= DIST_FAMILIES_LOSS_RTOL
              and r["grads"]["worst_share_of_limit"] <= 1.0
              and not r["grads"]["zero_leaves"] and r["grads"]["leaves"] > 5,
              f"(e) {arch}: the mesh's f32 loss or gradients differ from the "
              f"local path's: {r['loss']} {r['grads']}")
        check(all(r["flash_launches_equal_on_every_rank"].values()),
              f"(e) {arch}: a rank's flash launches differ from the local "
              f"path's: {[x for x in r['mesh_by_rank']]} {r['local']}")
    return out


def _gloo_seq_cache(rank: int, mesh, sizes, device) -> dict:
    """(f) on this rank: DIST_SEQ_ARCH with its cache split over the
    sequence on ``mesh`` (the experts over model through impl="ep" at
    DIST_GLOO_CAPACITY), a prefill and greedy decode steps in bf16 and the
    same steps fed those tokens in f32; then rank 0 runs the local path
    (no mesh, whole weights from the same seed, the local dispatch at the
    same capacity) the same way. Returns rank 0's report (the others':
    their launches, times and state bytes)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel.sharding import NamedSharding
    cfg, reduced = serve_config(sizes, DIST_SEQ_ARCH, DIST_SEQ_CUTS,
                                DIST_SEQ_WHY)
    tp, S = mesh.shape["model"], sizes["dist_gloo_prompt"]
    rules = default_rules()
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    g = torch.Generator(device=device)
    g.manual_seed(DIST_FAMILIES_SEED)
    toks = torch.randint(0, cfg.vocab_size, (DIST_SEQ_BATCH, S), generator=g,
                         device=device, dtype=torch.int32)
    moe = (dict(moe_impl="ep", moe_capacity_factor=DIST_GLOO_CAPACITY)
           if cfg.family == "moe" else {})
    rep = {"arch": cfg.name, "reduced": reduced, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "prompt_len": S, "batch": DIST_SEQ_BATCH,
           "max_len": sizes["dist_max_len"], "decode_steps": DIST_GLOO_STEPS,
           "positions_a_rank": sizes["dist_max_len"] // tp}
    mesh_runs, local_runs, fed = {}, {}, []
    for dt in DIST_GLOO_DTYPES:
        run_cfg = dataclasses.replace(cfg, dtype=dt)
        impl, why = _family_attn_impl(cfg, dt)
        rt = Runtime(tp=tp, mesh=mesh, attn_impl=impl,
                     decode_cache_shard="seq", **moe)
        params = _family_params(run_cfg, rt, device, rules)
        mesh_runs[dt] = _family_run(run_cfg, rt, params,
                                    {"tokens": rows.shard(toks)}, fed,
                                    dt == DIST_GLOO_DTYPES[0], sizes, device,
                                    rows)
        mesh_runs[dt]["attn_impl"] = impl
        if why:
            mesh_runs[dt]["attn_plain_why"] = why
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {
        dt: {k: v for k, v in r.items() if k != "logits"}
        for dt, r in mesh_runs.items()})
    rep["mesh_by_rank"] = by_rank
    if rank == 0:
        with patched(moe_mod, "CAPACITY_FACTOR", DIST_GLOO_CAPACITY):
            for dt in DIST_GLOO_DTYPES:
                run_cfg = dataclasses.replace(cfg, dtype=dt)
                rt1 = Runtime(tp=tp, attn_impl=_family_attn_impl(cfg, dt)[0])
                params = _family_params(run_cfg, rt1, device)
                local_runs[dt] = _family_run(run_cfg, rt1, params,
                                             {"tokens": toks}, fed, False,
                                             sizes, device)
                del params
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    rep["peak_memory_gb_by_rank"] = peaks
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if rank != 0:
        return rep
    rep["local"] = {dt: {k: v for k, v in r.items() if k != "logits"}
                    for dt, r in local_runs.items()}
    have = {dt: r["logits"] for dt, r in mesh_runs.items()}
    want = {dt: r["logits"] for dt, r in local_runs.items()}
    rep.update(_logit_gates(have, want["bfloat16"], want["float32"],
                            want["float32"]))
    rep.update(_margin_tokens(want["bfloat16"], have["bfloat16"]))
    rep["shapes_ok"] = all(
        bool(torch.isfinite(a).all()) and a.shape == b.shape
        for dt in DIST_GLOO_DTYPES for a, b in zip(have[dt], want[dt])) and (
        len(have["float32"]) == len(want["float32"]) == DIST_GLOO_STEPS + 1)
    rep["flash_launches_equal_on_every_rank"] = {
        dt: all(r[dt]["flash_launches_by_shape"]
                == local_runs[dt]["flash_launches_by_shape"]
                for r in by_rank) for dt in DIST_GLOO_DTYPES}
    rep["cache_bytes"] = {
        dt: {"rank0_split": by_rank[0][dt]["state_bytes"],
             "unsplit": local_runs[dt]["state_bytes"]}
        for dt in DIST_GLOO_DTYPES}
    rep["decode_ms_per_step"] = {
        dt: {"mesh_rank0": mesh_runs[dt]["decode_ms_per_step"],
             "local": local_runs[dt]["decode_ms_per_step"]}
        for dt in DIST_GLOO_DTYPES}
    return rep


def _gloo_whole_moments(rank: int, mesh, sizes, device) -> dict:
    """(g) on this rank: DIST_WHOLE_ARCH in f32 on ``mesh``,
    DIST_WHOLE_STEPS train steps with ZeRO-1 moments and the same steps
    with whole ones (zero1=False), each from the same weights (drawn from
    DIST_FAMILIES_SEED): the losses, the steps' times, each rank's moment
    shapes against its parameter shards, and every parameter leaf's
    distance from the ZeRO-1 run's, taken shard by shard. Returns rank 0's
    report."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import OptConfig
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import NamedSharding
    from repro_torch.tree import leaves_with_paths, tree_leaves
    cfg, reduced = serve_config(sizes, DIST_WHOLE_ARCH, DIST_WHOLE_CUTS,
                                DIST_WHOLE_WHY)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rt = Runtime(tp=mesh.shape["model"], mesh=mesh)
    rules = default_rules()
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    g = torch.Generator(device=device)
    g.manual_seed(DIST_FAMILIES_SEED)
    S, B = sizes["dist_gloo_prompt"], mesh.shape["data"]
    batches = []
    for _ in range(DIST_WHOLE_STEPS):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=g, device=device,
                                     dtype=torch.int32)}
        if cfg.frontend_seq:
            b["frontend"] = draw_frontend(cfg, B, g, device)
        batches.append({k: rows.shard(v) for k, v in b.items()})
    opt = OptConfig(lr=DIST_WHOLE_LR)
    rep = {"arch": cfg.name, "reduced": reduced, "n_layers": cfg.n_layers,
           "dtype": "float32", "tokens_a_step": [B, S + 1],
           "frontend": cfg.frontend_seq, "steps": DIST_WHOLE_STEPS}
    runs, finals = {}, {}
    for zero1 in (True, False):
        name = "zero1" if zero1 else "whole"
        params = _family_params(cfg, rt, device, rules)
        state = steps_mod.init_train_state(cfg, rt, params, zero1=zero1)
        step = steps_mod.make_train_step(cfg, rt, opt, zero1=zero1)
        losses, ms = [], []
        for batch in batches:
            _sync(device)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        moments = tree_leaves(state["opt"]["m"])
        shapes = [tuple(p.shape) for p in tree_leaves(state["params"])]
        runs[name] = {
            "losses": losses, "step_ms": ms,
            "moment_leaves_split_over_data": sum(
                tuple(t.shape) != sh for t, sh in zip(moments, shapes)),
            "moment_bytes_rank": 2 * sum(t.numel() * t.element_size()
                                         for t in moments)}
        finals[name] = {k: t.cpu() for k, t in leaves_with_paths(
            state["params"])}
        del params, state, moments
        if device.type == "cuda":
            torch.cuda.empty_cache()
    everyone = mesh.group(mesh.axis_names)
    shares, worst_leaf = [], None
    for k, want in finals["zero1"].items():
        top = coll.all_reduce(want.abs().max(), everyone, op="max")
        diff = coll.all_reduce((finals["whole"][k] - want).abs().max(),
                               everyone, op="max")
        shares.append(float(diff) / (DIST_WHOLE_PARAM_SHARE * float(top)))
        if shares[-1] == max(shares):
            worst_leaf = k
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    rep.update(runs=runs, peak_memory_gb_by_rank=peaks,
               params={"leaves": len(shares),
                       "worst_share_of_limit": max(shares),
                       "worst_leaf": worst_leaf},
               loss_rel_diff=max(
                   abs(a - b) / abs(b) for a, b in zip(
                       runs["whole"]["losses"], runs["zero1"]["losses"])))
    return rep


def _gloo_seq_rank(rank: int, world: int, store_path: str, out_path: str,
                   device_type: str, sizes: dict) -> None:
    """One of the (f) and (g) ranks: gloo over ``device_type`` tensors on
    the one card (or the CPU in the rehearsal), TF32 off: probe the
    collectives, then, when gloo takes them all, (f) on a DIST_SEQ_MESH
    mesh and (g) on a DIST_GLOO_MESH one (every rank builds both); rank 0
    writes the reports."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    report = {"rank": rank}
    try:
        report["probe"] = _probe_collectives(None, device)
        report["refused"] = [n for n, v in report["probe"].items()
                             if v != "ok"]
        if not report["refused"]:
            seq_mesh = make_host_mesh(*DIST_SEQ_MESH, device_type=device_type)
            dp_mesh = make_host_mesh(*DIST_GLOO_MESH, device_type=device_type)
            t0 = time.perf_counter()
            report["f"] = _gloo_seq_cache(rank, seq_mesh, sizes, device)
            report["f"]["seconds"] = time.perf_counter() - t0
            if rank == 0:      # (f)'s report stays if (g) fails
                with open(out_path, "w") as f:
                    json.dump(report, f)
            t0 = time.perf_counter()
            report["g"] = _gloo_whole_moments(rank, dp_mesh, sizes, device)
            report["g"]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _seq_gqa_leg() -> dict:
    """Why (f) has no GQA leg at full width: DIST_SEQ_GQA's arch at its
    model size pads its q heads to a count its kv heads do not divide, so
    no forward of it runs (the reference asserts ``Hq % Hkv == 0`` too)."""
    from repro_torch.configs import get_config
    arch, tp = DIST_SEQ_GQA
    cfg = get_config(arch)
    nh, nkv = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    check(nh % nkv != 0, f"{arch}'s {nh} q heads group over {nkv} kv heads "
                         f"at model = {tp}: its (f) leg can run")
    return {"arch": arch, "mesh": {"data": 1, "model": tp},
            "q_heads": [cfg.n_heads, nh], "kv_heads": [cfg.n_kv_heads, nkv],
            "not_run": f"at model = {tp} the {cfg.n_heads} q heads pad to "
                       f"{nh}, which do not group over {nkv} kv heads; the "
                       f"GQA split is held on the CPU "
                       f"(tests/test_torch_distributed.py)"}


def dist_gloo_seq_and_whole(device, sizes: dict) -> dict:
    """(f) and (g) on four processes on the one card over gloo, started
    with torch.multiprocessing: (f) the decode cache split over the
    sequence (:func:`_gloo_seq_cache`): every step's f32 logits within
    DIST_GLOO_F32_RTOL * max|logits| of the local path's, the bf16 ones no
    further from the local f32 path than DIST_GLOO_BF16_FACTOR times the
    local bf16 path, the bf16 tokens by the margin rule, each rank's flash
    launches by call shape equal to the local path's; decode ms a step,
    rank 0's peak memory and its cache bytes against the unsplit cache's
    reported. (g) whole moments against ZeRO-1 (:func:`_gloo_whole_moments`):
    losses within DIST_WHOLE_LOSS_RTOL, every parameter leaf within
    DIST_WHOLE_PARAM_SHARE * max|p|, every moment of its parameter shard's
    shape where ZeRO-1 splits some over data. Times are host-staged:
    reported, not gated."""
    import shutil
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rep, wall, out_path = _spawn_gloo(_gloo_seq_rank, "dist_seq", device,
                                      sizes)
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    check(not rep["refused"],
          f"(f) / (g) gloo refused {rep['refused']} on {device.type} "
          f"tensors: {rep['probe']}")
    f, g = rep["f"], rep["g"]
    check(f["shapes_ok"] and f["tokens_equal"] == f["tokens_compared"],
          f"(f) the split cache's logits are malformed or its tokens differ "
          f"from the local path's by the margin rule: {f}")
    check(f["f32_share_of_limit"] <= 1.0 and f["bf16_share_of_limit"] <= 1.0,
          f"(f) the split cache's logits are further from the local path's "
          f"than rounding: {f['steps']}")
    check(all(f["flash_launches_equal_on_every_rank"].values())
          and (device.type != "cuda" or any(
              f["local"]["bfloat16"]["flash_launches_by_shape"].values())),
          f"(f) a rank's flash launches differ from the local path's, or "
          f"the bf16 prefill launched none on the card: {f['mesh_by_rank']} "
          f"{f['local']}")
    check(all(c["rank0_split"] * DIST_SEQ_MESH[1] == c["unsplit"]
              for c in f["cache_bytes"].values()),
          f"(f) rank 0's cache is not 1 / {DIST_SEQ_MESH[1]} of the "
          f"unsplit one: {f['cache_bytes']}")
    check(g["loss_rel_diff"] <= DIST_WHOLE_LOSS_RTOL
          and g["params"]["worst_share_of_limit"] <= 1.0
          and g["runs"]["whole"]["moment_leaves_split_over_data"] == 0
          and g["runs"]["zero1"]["moment_leaves_split_over_data"] > 0,
          f"(g) the whole-moment steps differ from the ZeRO-1 ones, or a "
          f"moment is not its parameter shard's shape: {g}")
    return {"backend": "gloo",
            "world": DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1],
            "device": device.type, "probe": rep["probe"], "wall_s": wall,
            "f_seq_cache": {"mesh": dict(zip(("data", "model"),
                                             DIST_SEQ_MESH)), **f},
            "f_gqa": _seq_gqa_leg(),
            "g_whole_moments": {"mesh": dict(zip(("data", "model"),
                                                 DIST_GLOO_MESH)), **g},
            "tolerance": (
                f"(f) each step: f32 mesh - f32 local <= {DIST_GLOO_F32_RTOL}"
                f" * max|f32 local|; bf16 mesh - f32 local <= "
                f"{DIST_GLOO_BF16_FACTOR} * (bf16 local - f32 local); (g) "
                f"losses rtol {DIST_WHOLE_LOSS_RTOL}; each parameter leaf "
                f"within {DIST_WHOLE_PARAM_SHARE} * max|p| of the ZeRO-1 "
                f"run's"),
            "timing_note": "host-staged gloo collectives: reported, not "
                           "gated"}


def _count_drops(run):
    """(run(), the pairs the one-device local dispatch dropped in it)"""
    from repro_torch.models import moe as moe_mod
    dropped = []
    combine = moe_mod._combine

    def counting(out_buf, meta, w, T, k):
        dropped.append(int((~meta[3]).sum()))
        return combine(out_buf, meta, w, T, k)
    with patched(moe_mod, "_combine", counting):
        res = run()
    return res, sum(dropped)


def _gloo_split_serve(rank: int, mesh, sizes, device) -> dict:
    """(h)'s serving legs on this rank: DIST_MOE_ARCH (cut as (d)) on
    ``mesh``, its experts over model and its rows over data, drawn from
    (d)'s seed; a prefill and greedy decode steps through the bf16 local
    route, and the same steps fed those tokens through every
    DIST_SPLIT_ROUTES route in each of DIST_GLOO_DTYPES; then rank 0 runs
    the local path (no mesh, whole weights from the same seed) the same
    way at DIST_SPLIT_CAPACITY (the pairs its prefill drops counted) and
    at DIST_GLOO_CAPACITY (none dropped). Returns rank 0's report with
    each route's gates (the others': their launches and times)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import ShardingRules, default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import NamedSharding
    cfg, reduced = serve_config(sizes, DIST_MOE_ARCH, DIST_GLOO_CUTS,
                                DIST_GLOO_WHY)
    tp, S = mesh.shape["model"], sizes["dist_gloo_prompt"]
    rules = default_rules()
    rules2d = ShardingRules(rules={**rules.rules, "expert_ff": "data"})
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    g = torch.Generator(device=device)
    g.manual_seed(32)
    toks = torch.randint(0, cfg.vocab_size, (mesh.shape["data"], S),
                         generator=g, device=device, dtype=torch.int32)
    routes = {"local": (dict(moe_impl="local"), rules, DIST_SPLIT_CAPACITY),
              "dense": (dict(moe_impl="dense"), rules, DIST_GLOO_CAPACITY),
              "ep2d": (dict(moe_impl="ep", moe_ep2d_decode=True,
                            moe_capacity_factor=DIST_GLOO_CAPACITY),
                       rules2d, DIST_GLOO_CAPACITY)}
    rep = {"arch": cfg.name, "reduced": reduced, "prompt_len": S,
           "batch": mesh.shape["data"], "decode_steps": DIST_GLOO_STEPS,
           "local_capacity_factor": DIST_SPLIT_CAPACITY,
           "other_capacity_factor": DIST_GLOO_CAPACITY}
    mesh_runs, fed = {r: {} for r in DIST_SPLIT_ROUTES}, []
    dgrp = mesh.group("data")
    for dt in DIST_GLOO_DTYPES:
        run_cfg, drawn = _gloo_cfg(cfg, dt)
        params = model_mod.init_params(drawn, Runtime(tp=tp, mesh=mesh),
                                       seed=31, rules=rules)
        if dt == "float32":
            _widen(params)
        for route in DIST_SPLIT_ROUTES:
            kw, r_rules, cap = routes[route]
            if route == "ep2d":
                # the 2D layout: each rank keeps its data row's slice of
                # its experts' ffn
                for layer in params["layers"]:
                    ex = layer["mlp"]["experts"]
                    ex["wi"] = coll.chunk(ex["wi"], 2, dgrp)
                    ex["wg"] = coll.chunk(ex["wg"], 2, dgrp)
                    ex["wo"] = coll.chunk(ex["wo"], 1, dgrp)
            with patched(moe_mod, "CAPACITY_FACTOR", cap):
                mesh_runs[route][dt] = _family_run(
                    run_cfg, Runtime(tp=tp, mesh=mesh, **kw), params,
                    {"tokens": rows.shard(toks)}, fed,
                    (dt, route) == (DIST_GLOO_DTYPES[0], "local"), sizes,
                    device, rows, r_rules)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {
        route: {dt: {k: v for k, v in r.items() if k != "logits"}
                for dt, r in runs.items()}
        for route, runs in mesh_runs.items()})
    local = {}
    if rank == 0:
        bf16_cfg, drawn = _gloo_cfg(cfg, "bfloat16")
        for name, run_cfg, dr in (
                ("bf16", bf16_cfg, drawn),
                ("f32_wide", dataclasses.replace(bf16_cfg, dtype="float32"),
                 drawn),
                ("f32", *_gloo_cfg(cfg, "float32"))):
            params = model_mod.init_params(dr, Runtime(tp=tp), seed=31,
                                           device=device)
            if run_cfg.dtype == "float32":
                _widen(params)
            for cap in (DIST_SPLIT_CAPACITY, DIST_GLOO_CAPACITY):
                with patched(moe_mod, "CAPACITY_FACTOR", cap):
                    local[name, cap] = _family_run(
                        run_cfg, Runtime(), params, {"tokens": toks}, fed,
                        False, sizes, device)
                    if (name, cap) == ("bf16", DIST_SPLIT_CAPACITY):
                        _, rep["local_pairs_dropped_in_prefill"] = \
                            _count_drops(lambda: make_prefill_step(
                                run_cfg, Runtime(), sizes["dist_max_len"])(
                                params, {"tokens": toks}))
            del params
            if device.type == "cuda":
                torch.cuda.empty_cache()
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    rep["peak_memory_gb_by_rank"] = peaks
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if rank != 0:
        return rep
    rep["routes"] = {}
    for route in DIST_SPLIT_ROUTES:
        cap = routes[route][2]
        have = {dt: mesh_runs[route][dt]["logits"]
                for dt in DIST_GLOO_DTYPES}
        l16, l32w, l32 = (local[n, cap]["logits"]
                          for n in ("bf16", "f32_wide", "f32"))
        want = {"bfloat16": l16, "float32": l32}
        one = {"bfloat16": local["bf16", cap], "float32": local["f32", cap]}
        r = {"capacity_factor": cap, **_logit_gates(have, l16, l32w, l32),
             **_margin_tokens(l16, have["bfloat16"])}
        r["shapes_ok"] = all(
            bool(torch.isfinite(a).all()) and a.shape == b.shape
            for dt in DIST_GLOO_DTYPES for a, b in zip(have[dt], want[dt])
        ) and len(have["float32"]) == len(l32) == DIST_GLOO_STEPS + 1
        r["flash_launches_equal_on_every_rank"] = {
            dt: all(b[route][dt]["flash_launches_by_shape"]
                    == one[dt]["flash_launches_by_shape"] for b in by_rank)
            for dt in DIST_GLOO_DTYPES}
        r["local_flash_launches_by_shape"] = {
            dt: one[dt]["flash_launches_by_shape"] for dt in DIST_GLOO_DTYPES}
        r["prefill_ms"] = {dt: {"mesh_rank0": mesh_runs[route][dt][
            "prefill_ms"], "local": one[dt]["prefill_ms"]}
            for dt in DIST_GLOO_DTYPES}
        r["decode_ms_per_step"] = {dt: {"mesh_rank0": mesh_runs[route][dt][
            "decode_ms_per_step"], "local": one[dt]["decode_ms_per_step"]}
            for dt in DIST_GLOO_DTYPES}
        rep["routes"][route] = r
    return rep


def _gloo_split_train(rank: int, mesh, sizes, device) -> dict:
    """(h)'s train leg on this rank: DIST_MOE_ARCH cut by
    DIST_SPLIT_TRAIN_CUTS, in f32, DIST_SPLIT_TRAIN_STEPS steps with whole
    moments (zero1=False) through impl="ep", under the ep2d rules (the
    experts' ffn stored over data and gathered whole a layer at a time,
    its gradient reduce-scattered) and under the default ones (the ffn
    whole, its gradient all-reduced), from the same weights; rank 0 then
    takes the same steps on one device (the local dispatch, nothing
    dropped on any route). Returns rank 0's report: the losses, the steps'
    times, the moments' split, and every parameter leaf's distance from
    the default layout's and from one device's."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import ShardingRules, default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import NamedSharding, is_spec
    from repro_torch.tree import leaves_with_paths, tree_leaves
    cfg, reduced = serve_config(sizes, DIST_MOE_ARCH, DIST_SPLIT_TRAIN_CUTS,
                                DIST_SPLIT_TRAIN_WHY)
    drawn = dataclasses.replace(cfg, dtype=DIST_GLOO_DTYPES[0])
    cfg = dataclasses.replace(cfg, dtype="float32")
    tp, S, B = mesh.shape["model"], sizes["dist_gloo_prompt"], \
        mesh.shape["data"]
    rules = default_rules()
    layouts = {"ep2d": ShardingRules(rules={**rules.rules,
                                            "expert_ff": "data"}),
               "ep": rules}
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    rt = Runtime(tp=tp, mesh=mesh, moe_impl="ep", moe_ep2d_decode=True,
                 moe_capacity_factor=DIST_GLOO_CAPACITY)
    g = torch.Generator(device=device)
    g.manual_seed(DIST_FAMILIES_SEED)
    batches = [torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                             device=device, dtype=torch.int32)
               for _ in range(DIST_SPLIT_TRAIN_STEPS)]
    opt = OptConfig(lr=DIST_WHOLE_LR)
    rep = {"arch": cfg.name, "reduced": reduced, "dtype": "float32",
           "tokens_a_step": [B, S + 1], "steps": DIST_SPLIT_TRAIN_STEPS,
           "runs": {}}
    whole = {}
    for name, r_rules in layouts.items():
        params = model_mod.init_params(drawn, rt, seed=31, rules=r_rules)
        _widen(params)
        state = steps_mod.init_train_state(cfg, rt, params, r_rules,
                                           zero1=False)
        del params
        step = steps_mod.make_train_step(cfg, rt, opt, r_rules, zero1=False)
        losses, ms = [], []
        for toks in batches:
            _sync(device)
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": rows.shard(toks)})
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        wi = state["opt"]["m"]["layers"][0]["mlp"]["experts"]["wi"]
        rep["runs"][name] = {
            "losses": losses, "step_ms": ms,
            "moment_wi_local_shape": list(wi.shape),
            "moments_as_params": all(
                m.shape == p.shape for m, p in zip(
                    tree_leaves(state["opt"]["m"]),
                    tree_leaves(state["params"])))}
        specs = dict(leaves_with_paths(model_mod.param_specs(cfg, rt,
                                                             r_rules),
                                       is_leaf=is_spec))
        whole[name] = {k: NamedSharding(mesh, specs[k]).gather(t).cpu()
                       for k, t in leaves_with_paths(state["params"])}
        del state, wi
        if device.type == "cuda":
            torch.cuda.empty_cache()
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    rep["peak_memory_gb_by_rank"] = peaks
    if rank != 0:
        return rep
    params = model_mod.init_params(drawn, Runtime(tp=tp), seed=31,
                                   device=device)
    _widen(params)
    with patched(moe_mod, "CAPACITY_FACTOR", DIST_GLOO_CAPACITY):
        st1 = steps_mod.init_train_state(cfg, Runtime(), params)
        del params
        step1 = steps_mod.make_train_step(cfg, Runtime(), opt)
        losses1, ms1 = [], []
        for toks in batches:
            _sync(device)
            t0 = time.perf_counter()
            st1, m = step1(st1, {"tokens": toks})
            _sync(device)
            ms1.append((time.perf_counter() - t0) * 1e3)
            losses1.append(float(m["loss"]))
    whole["one_device"] = {k: t.cpu()
                           for k, t in leaves_with_paths(st1["params"])}

    def distance(other: str) -> dict:
        shares = {k: float((whole["ep2d"][k] - want).abs().max())
                  / (DIST_WHOLE_PARAM_SHARE * float(want.abs().max()))
                  for k, want in whole[other].items()}
        worst = max(shares, key=shares.get)
        return {"leaves": len(shares), "worst_share_of_limit": shares[worst],
                "worst_leaf": worst}
    mesh_losses = rep["runs"]["ep2d"]["losses"]
    rep.update(one_device_losses=losses1, one_device_step_ms=ms1,
               loss_rel_diff={other: max(abs(a - b) / abs(b) for a, b in zip(
                   mesh_losses, want))
                   for other, want in (("ep", rep["runs"]["ep"]["losses"]),
                                       ("one_device", losses1))},
               params_vs_ep=distance("ep"),
               params_vs_one_device=distance("one_device"),
               one_device_peak_memory_gb=(
                   torch.cuda.max_memory_allocated(device) / 1e9
                   if device.type == "cuda" else None))
    return rep


def _gloo_split_rank(rank: int, world: int, store_path: str, out_path: str,
                     device_type: str, sizes: dict) -> None:
    """One of the (h) ranks: gloo over ``device_type`` tensors on the one
    card (or the CPU in the rehearsal), TF32 off: probe the collectives,
    then, when gloo takes them all, the serving legs and the train leg on
    a DIST_GLOO_MESH mesh; rank 0 writes the reports."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    report = {"rank": rank}
    try:
        report["probe"] = _probe_collectives(None, device)
        report["refused"] = [n for n, v in report["probe"].items()
                             if v != "ok"]
        if not report["refused"]:
            mesh = make_host_mesh(*DIST_GLOO_MESH, device_type=device_type)
            for leg, fn in (("serve", _gloo_split_serve),
                            ("train", _gloo_split_train)):
                t0 = time.perf_counter()
                report[leg] = fn(rank, mesh, sizes, device)
                report[leg]["seconds"] = time.perf_counter() - t0
                if rank == 0:      # each leg's report stays if the next fails
                    with open(out_path, "w") as f:
                        json.dump(report, f)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dist_gloo_split_experts(device, sizes: dict) -> dict:
    """(h) on four processes on the one card over gloo, started with
    torch.multiprocessing: the MoE on split experts (:func:`_gloo_split_serve`):
    for each of DIST_SPLIT_ROUTES every step's f32 logits within
    DIST_GLOO_F32_RTOL * max|logits| of the local path's, the bf16 ones no
    further from the local f32 path than DIST_GLOO_BF16_FACTOR times the
    local bf16 path, the bf16 tokens by the margin rule, each rank's flash
    launches by call shape equal to the local path's; then ep2d train steps
    with whole moments (:func:`_gloo_split_train`): losses within
    DIST_WHOLE_LOSS_RTOL of one device's and of the same steps under the
    default layout (the experts' ffn whole), every parameter leaf within
    DIST_WHOLE_PARAM_SHARE * max|p| of the default layout's (as (g) holds
    two layouts on one mesh; each leaf's distance from one device's is
    reported: at full width AdamW's normalised first steps turn the f32
    noise of near-zero gradient elements into parameter differences of a
    few 1e-6), every moment of its parameter shard's shape (the experts'
    ffn over data). Times are host-staged: reported, not gated."""
    import shutil
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rep, wall, out_path = _spawn_gloo(_gloo_split_rank, "dist_split", device,
                                      sizes)
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    check(not rep["refused"],
          f"(h) gloo refused {rep['refused']} on {device.type} tensors: "
          f"{rep['probe']}")
    serve, train = rep["serve"], rep["train"]
    for route, r in serve["routes"].items():
        check(r["shapes_ok"] and r["tokens_equal"] == r["tokens_compared"],
              f"(h) {route}: the mesh's logits are malformed or its tokens "
              f"differ from the local path's by the margin rule: {r}")
        check(r["f32_share_of_limit"] <= 1.0
              and r["bf16_share_of_limit"] <= 1.0,
              f"(h) {route}: the mesh's logits are further from the local "
              f"path's than rounding: {r['steps']}")
        check(all(r["flash_launches_equal_on_every_rank"].values())
              and (device.type != "cuda" or any(
                  r["local_flash_launches_by_shape"]["bfloat16"].values())),
              f"(h) {route}: a rank's flash launches differ from the local "
              f"path's, or the bf16 prefill launched none on the card: {r}")
    check(max(train["loss_rel_diff"].values()) <= DIST_WHOLE_LOSS_RTOL
          and train["params_vs_ep"]["worst_share_of_limit"] <= 1.0
          and all(r["moments_as_params"] for r in train["runs"].values()),
          f"(h) the ep2d whole-moment steps differ from the default "
          f"layout's or one device's, or a moment is not its parameter "
          f"shard's shape: {train}")
    return {"backend": "gloo",
            "world": DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1],
            "mesh": dict(zip(("data", "model"), DIST_GLOO_MESH)),
            "device": device.type, "probe": rep["probe"], "wall_s": wall,
            "serve": serve, "train": train,
            "tolerance": (
                f"each route, each step: f32 mesh - f32 local <= "
                f"{DIST_GLOO_F32_RTOL} * max|f32 local|; bf16 mesh - f32 "
                f"local <= {DIST_GLOO_BF16_FACTOR} * (bf16 local - f32 "
                f"local); train: losses rtol {DIST_WHOLE_LOSS_RTOL} of one "
                f"device's and the default layout's, each parameter leaf "
                f"within {DIST_WHOLE_PARAM_SHARE} * max|p| of the default "
                f"layout's"),
            "timing_note": "host-staged gloo collectives: reported, not "
                           "gated"}


def _seq_rules():
    """The default rules with the sequence split over model, as the
    reference's run_cell installs them for --seq-shard."""
    from repro_torch.models.common import ShardingRules, default_rules
    return ShardingRules(rules={**default_rules().rules, "seq": "model"})


def _sp_grads(cfg, rt, params, batch, rules, device):
    """(gradient, loss, ms, GB) of ``loss_fn`` forward and backward on
    this rank under ``rules`` (``None``: no mesh); the GB are the peak of
    ``max_memory_allocated`` during the call above what was allocated when
    it started (its gradients and activations, not the weights or what
    the caller holds)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.common import sharding_ctx
    start = 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
    _sync(device)
    t0 = time.perf_counter()
    with sharding_ctx(rules, rt.mesh):
        g, metrics = steps_mod._grads(cfg, rt, params, batch)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    peak = ((torch.cuda.max_memory_allocated(device) - start) / 1e9
            if device.type == "cuda" else None)
    return g, float(metrics["loss"]), ms, peak


def _row_leaf(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in DIST_SP_ROW_LEAVES


def _leaf_stats(h, w):
    return torch.stack([(h - w).abs().max().float(), w.abs().max().float(),
                        h.abs().max().float()])


def _sp_leaf_shares(pairs, group, device) -> dict:
    """Each leaf's distance over ``GRAD_SHARE * max|want|``, from (path,
    have, want) this rank's shards of the same leaf (the max over
    ``group``, every rank taking part; ``have`` may wait on the host, and
    is brought to ``want``'s device one leaf at a time): the worst leaf,
    the worst of the row-applied leaves, the zero leaves of ``have``."""
    import torch.distributed as dist
    paths = [p for p, _, _ in pairs]
    stats = torch.stack([_leaf_stats(h.to(w.device), w)
                         for _, h, w in pairs]).to(device)
    dist.all_reduce(stats, op=dist.ReduceOp.MAX, group=group)
    stats = stats.cpu()
    shares = {p: float(d / (DIST_FAMILIES_GRAD_SHARE * m)) if m > 0
              else math.inf for p, (d, m, _) in zip(paths, stats.tolist())}
    return _shares_report(shares, [p for p, (_, _, h) in zip(
        paths, stats.tolist()) if not h > 0])


def _shares_report(shares: dict, zero: list) -> dict:
    worst = max(shares, key=shares.get)
    rows = {p: v for p, v in shares.items() if _row_leaf(p)}
    worst_row = max(rows, key=rows.get) if rows else None
    return {"leaves": len(shares), "worst_share_of_limit": shares[worst],
            "worst_leaf": worst, "row_leaves": len(rows),
            "worst_row_leaf": worst_row,
            "worst_row_leaf_share": rows.get(worst_row),
            "zero_leaves": zero}


def _gloo_seq_parallel(arch: str, rank: int, mesh, sizes, device) -> dict:
    """One family of (i) on this rank: the f32 loss forward and backward
    under the rule seq -> model and without it on the mesh (each rank's
    gradient shards held leaf by leaf, before the mean over data), then
    rank 0's local path, against which the mean of the rule's gradients,
    gathered whole, is held; for DIST_SP_SERVE, then a bf16 and an f32
    prefill and greedy decode steps under the rule against the local path.
    Returns rank 0's report (the others': their times and peaks)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import default_rules
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import (NamedSharding,
                                               named_sharding_tree)
    from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map
    cuts, impl = DIST_SP_FAMILIES[arch]
    cfg, reduced = serve_config(sizes, arch, cuts, DIST_SP_WHY)
    cfg = dataclasses.replace(cfg, dtype="float32")
    tp, B = mesh.shape["model"], DIST_GLOO_MESH[0]
    S = sizes["dist_gloo_prompt"]
    rules, seq = default_rules(), _seq_rules()
    everyone = mesh.group(mesh.axis_names)
    rows = NamedSharding(mesh, rules.mesh_axes(["batch"]))
    g = torch.Generator(device=device)
    g.manual_seed(DIST_FAMILIES_SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=device, dtype=torch.int32)
    fe = (draw_frontend(cfg, B, g, device) if cfg.frontend_seq else None)

    def batch_of(dtype, tokens, shard):
        b = {"tokens": tokens}
        if fe is not None:
            b["frontend"] = fe.to(getattr(torch, dtype))
        return {k: rows.shard(v) for k, v in b.items()} if shard else b

    impl_attn = _family_attn_impl(cfg, "float32")[0]
    rt = Runtime(tp=tp, mesh=mesh, attn_impl=impl_attn, moe_impl=impl,
                 moe_capacity_factor=DIST_GLOO_CAPACITY)
    rep = {"arch": arch, "reduced": reduced, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "tokens_a_row": S, "batch": B,
           "moe_impl": impl if cfg.family == "moe" else None}
    params = _family_params(cfg, rt, device, rules)
    specs = model_mod.param_specs(cfg, rt)
    local = batch_of("float32", toks, True)
    # the first call pays the family's warm-up: the rule's run is timed
    # (and its peak read) again after the unsplit one. Its gradients wait
    # on the host (an exact copy): four ranks holding two gradient trees
    # beside their weights filled the card (the VLM's 4.7 GB a tree a rank)
    g_seq, loss_seq, ms_first, _ = _sp_grads(cfg, rt, params, local, seq,
                                             device)
    g_seq = tree_map(lambda t: t.cpu(), g_seq)
    g_un, loss_un, ms_un, peak_un = _sp_grads(cfg, rt, params, local, rules,
                                              device)
    vs_unsplit = _sp_leaf_shares(
        [(p, h, w) for (p, h), w in zip(leaves_with_paths(g_seq),
                                        tree_leaves(g_un))], everyone,
        device)
    del g_un
    _, _, ms_seq, peak_seq = _sp_grads(cfg, rt, params, local, seq, device)
    del params
    if device.type == "cuda":
        # every rank's cache freed before rank 0 runs the local path alone
        torch.cuda.empty_cache()
    mine = {"loss_fwd_bwd_ms": {"seq": ms_seq, "unsplit": ms_un,
                                "seq_first_call": ms_first},
            "peak_above_start_gb": {"seq": peak_seq, "unsplit": peak_un}}
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, mine)
    rep["mesh_by_rank"] = by_rank
    g_local = loss_local = None
    if rank == 0:
        rt1 = Runtime(tp=tp, attn_impl=impl_attn)
        params1 = _family_params(cfg, rt1, device)
        with patched(moe_mod, "CAPACITY_FACTOR", DIST_GLOO_CAPACITY):
            g_local, loss_local, ms1, peak1 = _sp_grads(
                cfg, rt1, params1, batch_of("float32", toks, False), None,
                device)
        del params1
        rep["local"] = {"loss_fwd_bwd_ms": ms1, "peak_above_start_gb": peak1}
    # the rule's gradients averaged over data, gathered whole over model,
    # each held against the local path's leaf on rank 0
    dgrp, n = mesh.group("data"), mesh.shape["data"]
    local_leaves = dict(leaves_with_paths(g_local)) if rank == 0 else {}
    shares, zero = {}, []
    for (path, t), sh in zip(leaves_with_paths(g_seq),
                             tree_leaves(named_sharding_tree(specs, mesh))):
        have = sh.gather(coll.all_reduce(t.to(device), dgrp) / n)
        if rank == 0:
            want = local_leaves[path]
            lim = DIST_FAMILIES_GRAD_SHARE * float(want.abs().max())
            shares[path] = (float((have - want).abs().max()) / lim
                            if lim > 0 else math.inf)
            if not bool(have.abs().max() > 0):
                zero.append(path)
        del have
    del g_seq, g_local, local_leaves
    if rank == 0:
        rep["loss"] = {"seq": loss_seq, "unsplit": loss_un,
                       "local": loss_local,
                       "rel_diff_unsplit": abs(loss_seq - loss_un)
                       / abs(loss_un),
                       "rel_diff_local": abs(loss_seq - loss_local)
                       / abs(loss_local)}
        rep["grads_vs_unsplit"] = vs_unsplit
        rep["grads_vs_local"] = _shares_report(shares, zero)
    if arch == DIST_SP_SERVE:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rep.update(_sp_serve(cfg, rank, mesh, rows, batch_of, toks, sizes,
                             device))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rep


def _sp_serve(cfg, rank: int, mesh, rows, batch_of, toks, sizes,
              device) -> dict:
    """(i)'s serving leg on this rank: DIST_SP_SERVE's prefill and greedy
    decode steps in bf16 and f32 under the rule seq -> model (the encoder
    split over the frames), then rank 0's local path fed the same tokens;
    (e)'s logit and token gates and each rank's flash launches by call
    shape against the local path's."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models.transformer import Runtime
    tp, S = mesh.shape["model"], sizes["dist_gloo_prompt"]
    mesh_runs, local_runs, fed = {}, {}, []
    for dt in DIST_GLOO_DTYPES:
        run_cfg = dataclasses.replace(cfg, dtype=dt)
        impl, _ = _family_attn_impl(cfg, dt)
        rt = Runtime(tp=tp, mesh=mesh, attn_impl=impl)
        params = _family_params(run_cfg, rt, device)
        mesh_runs[dt] = _family_run(run_cfg, rt, params,
                                    batch_of(dt, toks[:, :S], True), fed,
                                    dt == DIST_GLOO_DTYPES[0], sizes, device,
                                    rows, rules=_seq_rules())
        del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {
        dt: r["flash_launches_by_shape"] for dt, r in mesh_runs.items()})
    if rank != 0:
        return {"serve_flash_launches_by_rank": by_rank}
    for dt in DIST_GLOO_DTYPES:
        run_cfg = dataclasses.replace(cfg, dtype=dt)
        rt1 = Runtime(tp=tp, attn_impl=_family_attn_impl(cfg, dt)[0])
        params = _family_params(run_cfg, rt1, device)
        local_runs[dt] = _family_run(run_cfg, rt1, params,
                                     batch_of(dt, toks[:, :S], False), fed,
                                     False, sizes, device)
        del params
    have = {dt: r["logits"] for dt, r in mesh_runs.items()}
    want = {dt: r["logits"] for dt, r in local_runs.items()}
    out = {"serve": {
        **_logit_gates(have, want["bfloat16"], want["float32"],
                       want["float32"]),
        **_margin_tokens(want["bfloat16"], have["bfloat16"]),
        "shapes_ok": all(
            bool(torch.isfinite(a).all()) and a.shape == b.shape
            for dt in DIST_GLOO_DTYPES for a, b in zip(have[dt], want[dt]))
        and len(have["float32"]) == DIST_GLOO_STEPS + 1,
        "prefill_ms": {dt: [mesh_runs[dt]["prefill_ms"],
                            local_runs[dt]["prefill_ms"]]
                       for dt in DIST_GLOO_DTYPES},
        "decode_ms_per_step": {dt: [mesh_runs[dt]["decode_ms_per_step"],
                                    local_runs[dt]["decode_ms_per_step"]]
                               for dt in DIST_GLOO_DTYPES},
        "flash_launches_by_rank": by_rank,
        "local_flash_launches_by_shape": {
            dt: r["flash_launches_by_shape"] for dt, r in local_runs.items()},
        "flash_launches_equal_on_every_rank": {
            dt: all(r[dt] == local_runs[dt]["flash_launches_by_shape"]
                    for r in by_rank) for dt in DIST_GLOO_DTYPES}}}
    return out


def _gloo_sp_rank(rank: int, world: int, store_path: str, out_path: str,
                  device_type: str, sizes: dict) -> None:
    """One of the (i) ranks: gloo over ``device_type`` tensors on the one
    card (or the CPU in the rehearsal), TF32 off: probe the collectives,
    then, when gloo takes them all, each of DIST_SP_FAMILIES on a
    DIST_GLOO_MESH mesh (:func:`_gloo_seq_parallel`); rank 0 writes the
    reports, after each family."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    report = {"rank": rank}
    try:
        probe = _probe_collectives(None, device)
        report["probe"] = {n: probe[n] for n in DIST_FAMILIES_COLLECTIVES}
        report["refused"] = [n for n, v in report["probe"].items()
                             if v != "ok"]
        if not report["refused"]:
            mesh = make_host_mesh(*DIST_GLOO_MESH, device_type=device_type)
            report["families"] = {}
            for arch in DIST_SP_FAMILIES:
                t0 = time.perf_counter()
                rep = _gloo_seq_parallel(arch, rank, mesh, sizes, device)
                rep["seconds"] = time.perf_counter() - t0
                report["families"][arch] = rep
                if rank == 0:
                    with open(out_path, "w") as f:
                        json.dump(report, f)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dist_gloo_seq_parallel(device, sizes: dict) -> dict:
    """(i) four processes on the one card over gloo (DIST_GLOO_MESH),
    started with torch.multiprocessing: sequence parallelism (the rule
    seq -> model) in the training trunks and the encoder
    (:func:`_gloo_seq_parallel`), for each of DIST_SP_FAMILIES the f32 loss
    within DIST_FAMILIES_LOSS_RTOL of the same mesh's without the rule and
    of the local path's, every gradient leaf within
    DIST_FAMILIES_GRAD_SHARE * max|g| of both and nonzero, the row-applied
    leaves (DIST_SP_ROW_LEAVES) among them; DIST_SP_SERVE's prefill and
    decode steps under the rule with (e)'s gates, each rank's flash
    launches by call shape equal to the local path's (on the card the
    encoder's non-causal launches among them). Times and each rank's peak
    memory with and without the rule are reported, not gated."""
    import shutil
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rep, wall, out_path = _spawn_gloo(_gloo_sp_rank, "dist_seq_parallel",
                                      device, sizes)
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    check(not rep["refused"],
          f"(i) gloo refused {rep['refused']} on {device.type} tensors: "
          f"{rep['probe']}")
    for arch, r in rep["families"].items():
        check(max(r["loss"]["rel_diff_unsplit"], r["loss"]["rel_diff_local"])
              <= DIST_FAMILIES_LOSS_RTOL,
              f"(i) {arch}: the loss under the rule differs from the "
              f"unsplit mesh's or the local path's: {r['loss']}")
        for side in ("grads_vs_unsplit", "grads_vs_local"):
            gr = r[side]
            check(gr["worst_share_of_limit"] <= 1.0 and not gr["zero_leaves"]
                  and gr["leaves"] > 5 and gr["row_leaves"] > 0,
                  f"(i) {arch}: a gradient leaf under the rule is zero or "
                  f"differs ({side}): {gr}")
    sv = rep["families"][DIST_SP_SERVE]["serve"]
    check(sv["shapes_ok"] and sv["tokens_equal"] == sv["tokens_compared"]
          and sv["f32_share_of_limit"] <= 1.0
          and sv["bf16_share_of_limit"] <= 1.0,
          f"(i) {DIST_SP_SERVE}: the prefill and decode under the rule "
          f"differ from the local path's: {sv}")
    check(all(sv["flash_launches_equal_on_every_rank"].values())
          and (device.type != "cuda" or any(
              "noncausal" in k for k in sv["local_flash_launches_by_shape"][
                  "bfloat16"])),
          f"(i) {DIST_SP_SERVE}: a rank's flash launches differ from the "
          f"local path's, or the encoder launched no non-causal kernel: {sv}")
    return {"backend": "gloo",
            "world": DIST_GLOO_MESH[0] * DIST_GLOO_MESH[1],
            "mesh": dict(zip(("data", "model"), DIST_GLOO_MESH)),
            "rules": "default + seq -> model", "device": device.type,
            "probe": rep["probe"], "wall_s": wall,
            "families": rep["families"],
            "tolerance": (
                f"f32 loss rtol {DIST_FAMILIES_LOSS_RTOL} of the unsplit "
                f"mesh's and the local path's; each gradient leaf within "
                f"{DIST_FAMILIES_GRAD_SHARE} * max|g| of both; "
                f"{DIST_SP_SERVE}'s steps: (e)'s gates"),
            "timing_note": "host-staged gloo collectives: reported, not "
                           "gated"}


def distributed_phase(device, sizes: dict, timer) -> dict:
    """The multi-device path on the one card: NCCL at world 1 on a 1 x 1
    mesh (its FileStore under build/) for (a) the MoE's expert-parallel
    serving against its local path, (b) DP x TP training with ZeRO-1 and
    its f32 check, (c) elastic restore; then (d) four gloo ranks on the
    card, (e) the SSM, hybrid, VLM and enc-dec families split over model
    on four gloo ranks, (f) the decode cache split over the sequence
    and (g) whole moments on four more, and (h) the MoE on split experts
    on four more. The CPU rehearsal runs gloo at world 1 on CPU tensors,
    and (d) to (h) on CPU tensors."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    backend = "nccl" if device.type == "cuda" else "gloo"
    store = os.path.join(HERE, "build", "dist_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=dist.FileStore(store, 1),
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device_type=device.type)
        moe = dist_moe_ep(device, sizes, mesh)
        train, state, rcfg, rt, batches, losses = dist_train(
            device, sizes, mesh, timer)
        elastic = dist_elastic(device, mesh, state, rcfg, rt, batches,
                               losses)
        del state
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    nccl_s = time.perf_counter() - t0
    gloo = dist_gloo_on_card(device, sizes)
    families = dist_gloo_families(device, sizes)
    seq = dist_gloo_seq_and_whole(device, sizes)
    split = dist_gloo_split_experts(device, sizes)
    sp = dist_gloo_seq_parallel(device, sizes)
    return {"backend": backend, "world": 1, "mesh": {"data": 1, "model": 1},
            "a_moe_ep": moe, "b_train": train, "c_elastic": elastic,
            "d_gloo_on_card": gloo, "e_gloo_families": families,
            "f_g_gloo_seq_and_whole": seq, "h_gloo_split_experts": split,
            "i_gloo_seq_parallel": sp,
            "gloo_headroom": GLOO_HEADROOM,
            "seconds": {"world_1": nccl_s, "gloo": gloo["wall_s"],
                        "gloo_families": families["wall_s"],
                        "gloo_seq_and_whole": seq["wall_s"],
                        "gloo_split_experts": split["wall_s"],
                        "gloo_seq_parallel": sp["wall_s"],
                        "phase": time.perf_counter() - t0}}


FULL = dict(vai_elems=2 ** 28, membw_small_rows=65536,       # 32 MiB
            membw_big_rows=2 ** 21, membw_iters=64,          # 1 GiB
            fleet_rows=9408 * 8, fleet_samples=5760, jobs=1500,
            # stream / broker: shard sizes of the fleet-day fold, the job
            # stream and the replay at scale; the broker grid's and the
            # broker benchmark's job counts
            stream_shard=2 ** 22, stream_job_shard=65536,
            replay_shard=2 ** 20, replay_sizes=(2 ** 23, 2 ** 24),
            broker_jobs=1500, broker_bench_jobs=50_000,
            # the executor: benchmarks/bench_sharded.py's trace (samples,
            # shard, jobs), and the replay at scale (samples, shard)
            exec_trace=1_000_000, exec_shard=65536, exec_jobs=100,
            exec_big=2 ** 24, exec_big_shard=2 ** 20,
            # flash: (batch*heads, seq, head dim) of SPACES; the served
            # model's prefill (seq, q heads, kv heads, head dim); MLA's
            # prefill (seq, heads) at head dims MLA_HEAD_DIMS
            flash_space=(4, 1024, 128), flash_model=(1024, 40, 8, 128),
            flash_ragged=1000, flash_mla=(1024, 128),
            flash_rg=(1024, 10, 1),
            # the head-dim sweep's (causal length, non-causal Sq, Skv);
            # the new classes' timed (batch, tokens, heads); the reduced
            # configs' (prompt, new tokens, max_len)
            flash_sweep=(300, 200, 333), flash_class=(4, 1024, 16),
            reduced_serve=(40, 6, 64),
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
            train_batch=2, train_steps=4,
            # the distributed phase: (a)'s prefill length, decode batch,
            # steps and max_len; (b)'s steps; (d)'s prompt a data row
            dist_prefill_len=DIST_PREFILL_LEN,
            dist_decode_batch=DIST_DECODE_BATCH,
            dist_decode_steps=DIST_DECODE_STEPS, dist_max_len=DIST_MAX_LEN,
            dist_train_steps=DIST_TRAIN_STEPS,
            dist_gloo_prompt=DIST_GLOO_PROMPT, dist_turns=2,
            # the dry run: (a)'s extra flags and smaller meshes (none: the
            # production meshes, full size); (c)'s prefill (batch, tokens)
            dryrun_flags=[], dryrun_mesh_shapes={},
            dryrun_prefill=DRYRUN_PREFILL)
TOY = dict(vai_elems=2 ** 16, membw_small_rows=256, membw_big_rows=2048,
           membw_iters=8, fleet_rows=64, fleet_samples=300, jobs=300,
           stream_shard=2 ** 12, stream_job_shard=4096,
           replay_shard=2 ** 10, replay_sizes=(2 ** 13, 2 ** 14),
           broker_jobs=120, broker_bench_jobs=2000,
           exec_trace=20_000, exec_shard=16384, exec_jobs=10,
           exec_big=2 ** 14, exec_big_shard=2 ** 12,
           flash_space=(2, 128, 64), flash_model=(64, 4, 2, 64),
           flash_ragged=61, flash_mla=(64, 4), flash_rg=(64, 2, 1),
           flash_sweep=(40, 24, 37), flash_class=(1, 64, 2),
           reduced_serve=(12, 3, 24),
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
           train_batch=2, train_steps=3,
           dist_prefill_len=32, dist_decode_batch=2, dist_decode_steps=2,
           dist_max_len=64, dist_train_steps=2, dist_gloo_prompt=16,
           dist_turns=1,
           dryrun_flags=["--reduced"],
           dryrun_mesh_shapes={"single": "2,4", "multi": "2,2,2"},
           dryrun_prefill=(2, 32))


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
        vai_banks, flash_sass = {}, {}
        try:
            for key, (kernel, op) in counts.items():
                text = build.sass(kernel)
                in_sass[key] = text.count(op)
                (build.build_dir() / f"{kernel}.sass").write_text(text)
            vai_banks = vai_sass_banks(build)
            flash_sass = flash_sass_by_instantiation(build)
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
                                          "flash_fwd_sm90_kernel"),
             flash_tensor_core_products_by_instantiation=flash_sass)
        built = flash_instantiations()
        check(all(flash_sass.get(key, 0) > 0 for key in built)
              and len(flash_sass) == len(built),
              f"a flash instantiation shows no HMMA / HGMMA, or the library "
              f"holds other instantiations than the rules build: "
              f"{sorted(set(built) ^ set(flash_sass))}, "
              f"{[k for k in built if not flash_sass.get(k)]}")
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
    # tune() at other head dims, each space's launches counted on its own
    tuning_dims = tune_flash_head_dims(device, sizes)
    emit(phase="flash_attention_tuning_head_dims", spaces=tuning_dims)

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
    stream_report, flat, day = stream_phase(device, sizes, jobs_raw["table"])
    emit(phase="stream", **stream_report)
    emit(phase="executor", **executor_phase(device, sizes, flat, day),
         nvidia_smi=smi)
    del flat
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
    # the f32 prefills at MLA's and RecurrentGemma's head dims, then the
    # reduced configs, each with the counts set to 0 just before it
    if device.type == "cuda":
        torch.cuda.empty_cache()
    f32_prefills = f32_model_prefills(device, sizes)
    emit(phase="f32_prefill", models=f32_prefills)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reduced_serve = serve_reduced_configs(device, sizes)
    emit(phase="serve_reduced", models=reduced_serve)
    # training, one phase after another, each with the counts set to 0
    # just before it: no kernel of the port's may launch (the reference's
    # training never reaches its Pallas kernel; the flash kernel has no
    # backward)
    train_counts = {}
    keep = {}
    for name, fn in (("train_attention_grad",
                      lambda: train_attention_grad(device, sizes, timer)),
                     ("train_card_vs_host",
                      lambda: train_card_vs_host(device, sizes)),
                     ("train", lambda: train_phase(device, sizes, timer,
                                                   keep))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ops.reset_launch_counts()
        report = fn()
        train_counts[name] = ops.launch_counts()
        emit(phase=name, **report, launches=train_counts[name])
        check(not any(train_counts[name].values()),
              f"the {name} phase launched a kernel: {train_counts[name]}")
    # the dry run and its cost model: counts set to 0 just before it; its
    # flash launches are (c)'s kernel route's, held there
    ops.reset_launch_counts()
    emit(phase="dryrun", **dryrun_phase(device, sizes, keep),
         nvidia_smi=smi)
    dryrun_counts = ops.launch_counts()
    # the multi-device path: counts set to 0 just before it, read after;
    # its flash launches are (a)'s two routes (the rank-local heads of a
    # 1 x 1 mesh are all the heads), (d)'s ranks count their own
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    dist_report = distributed_phase(device, sizes, timer)
    dist_counts = ops.launch_counts()
    emit(phase="distributed", **dist_report, launches=dist_counts,
         nvidia_smi=smi)
    check(device.type != "cuda" or dist_counts["flash_attention"] > 0,
          f"the distributed path never launched the flash kernel: "
          f"{dist_counts}")
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
                "flash_attention_f32_192x128":
                    sum(f32_prefills["deepseek-v3-671b"][
                        "flash_launches_by_shape"].values())
                    + tuning_dims["192x128"]["launches"],
                "flash_attention_f32_256x256":
                    sum(f32_prefills["recurrentgemma-2b"][
                        "flash_launches_by_shape"].values())
                    + tuning_dims["256x256"]["launches"],
                "flash_attention_f32_96x96": tuning_dims["96x96"]["launches"],
                "flash_attention_f32_32x32": tuning_dims["32x32"]["launches"],
                "flash_attention_32x32": sum(
                    sum(r["flash_launches_by_head_dims"].values())
                    for r in reduced_serve.values()),
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
         train=train_counts, dryrun=dryrun_counts,
         distributed=dist_counts)
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
    check(all(launches[k["name"]] > 0 for k in kernels),
          f"a kernel of the kernels line was not launched on its path: "
          f"{launches}")
    torch.cuda.synchronize()
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
