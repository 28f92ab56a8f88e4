#!/usr/bin/env python3
"""What the compiler made of the f32 (3xTF32) flash-attention kernel, and
every tile at the tuning space's shape timed in turns with
``F.scaled_dot_product_attention``, causal and not.

Builds the kernels, prints what ``ptxas`` said about each instantiation of
the f32 kernel (registers, spills) and its SASS counts of TF32 tensor-core
products (HMMA) and of the other instructions that matter to its loop
(shared loads, conversions, exp2). Then times each tile at q, k, v
``[4, 1024, 128]`` (causal) in turns with SDPA, ``--rounds`` times, and
once more without the mask, with ``chip_smoke.py``'s queued timer. One JSON
line per result. The kernel's cases and tiles are held against the plain
version by ``chip_smoke.py``, not here.

    python3 tools/flash_f32_check.py [--rounds 3] [--sass-out FILE]

Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNEL = "flash_fwd_f32_kernel"


def sass_counts(text: str) -> dict:
    """Instruction counts over every instantiation's SASS."""
    ops = {"HMMA": r"\bHMMA", "LDS": r"\bLDS", "LDSM": r"\bLDSM",
           "LDGSTS": r"\bLDGSTS", "BAR": r"\bBAR\.SYNC", "MUFU.EX2":
           r"\bMUFU\.EX2", "F2F": r"\bF2F", "LOP3": r"\bLOP3",
           "IADD3": r"\bIADD3", "FADD": r"\bFADD", "FMUL": r"\bFMUL"}
    return {k: len(re.findall(v, text)) for k, v in ops.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of (SDPA, every tile) timings")
    ap.add_argument("--sass-out", default=None,
                    help="write the f32 kernel's SASS to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_check: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.load_library()
    cs.emit(phase="ptxas", nvcc_seconds=build.build_seconds,
            f32=cs.ptxas_facts(build.build_log(), KERNEL))
    text = build.sass(KERNEL)
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            f.write(text)
    per = {}
    for chunk in text.split("Function : ")[1:]:
        m = re.search(KERNEL + r"ILi(\d+)ELi(\d+)ELi(\d+)E", chunk)
        if m:
            per[f"D{m[1]}_{m[2]}x{m[3]}"] = sass_counts(chunk)
    cs.emit(phase="sass", total=sass_counts(text), by_instantiation=per)

    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    # the tuning space's shape: [4, 1024, 128] as [B=4, S, H=1, D]
    bh, S, D = 4, 1024, 128
    q, k, v = (torch.randn((bh, S, 1, D), generator=g, device=dev)
               for _ in range(3))
    tiles = [(tq, tk) for tq in fa.BLOCK_Q_OPTIONS
             for tk in fa.BLOCK_K_OPTIONS
             if fa.unsupported(4, D, D, tq, tk) is None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound, by, flops, _ = cs.flash_bound_ms(bh, 1, 1, S, S, D, 4, True)
    rounds = []
    for _ in range(args.rounds):
        row = {"sdpa": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=20, queued=True)}
        for tq, tk in tiles:
            row[f"{tq}x{tk}"] = timer(lambda: fa.flash_attention_bshd(
                q, k, v, causal=True, block_q=tq, block_k=tk), reps=20,
                queued=True)
        rounds.append(row)
    best = min(min(r[t] for t in r if t != "sdpa") for r in rounds)
    # the same shape without the mask: every block walks every kv tile, so
    # the per-tile cost shows without the causal imbalance
    noncausal = {"sdpa": timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt), reps=20, queued=True)}
    for tq, tk in tiles:
        noncausal[f"{tq}x{tk}"] = timer(lambda: fa.flash_attention_bshd(
            q, k, v, causal=False, block_q=tq, block_k=tk), reps=20,
            queued=True)
    cs.emit(phase="tiles", shape="q, k, v [4, 1024, 128] f32 causal",
            ms_rounds=rounds, bound_ms=bound, bound_by=by, best_ms=best,
            best_tflops=flops / best / 1e9, noncausal_ms=noncausal,
            device=torch.cuda.get_device_name(0),
            nvidia_smi=cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
