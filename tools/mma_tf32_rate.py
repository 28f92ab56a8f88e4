#!/usr/bin/env python3
"""The rate of ``mma.sync`` m16n8k8 TF32 products on the card.

The f32 flash-attention kernel does its products as 3xTF32 on this
instruction. This script builds ``tools/mma_tf32_rate.cu`` with the
kernels' ``nvcc`` flags into ``build/`` (``kernels/build.py:build_probe``),
runs one block on each SM with 1 to 32 warps, each warp issuing rounds of
1 to 8 independent products, and prints one JSON line per
(warps, chains) with the time, the TF32 TFLOP/s and the SM cycles a product
takes on one SM sub-partition (from the SM clock read under load); then the
card's name and power limit. Needs one CUDA device:

    python3 tools/mma_tf32_rate.py
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ITERS = 4096
FLOPS_PER_MMA = 2 * 16 * 8 * 8


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_rate: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(build.build_probe(
        Path(HERE) / "mma_tf32_rate.cu")))
    lib.repro_mma_tf32_loop.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(chains, warps):
        code = lib.repro_mma_tf32_loop(chains, sms, 32 * warps, ITERS,
                                       out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    for warps in (1, 2, 4, 8, 16, 32):
        for chains in (1, 2, 4, 8):
            run(chains, warps)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run(chains, warps)
            stop.record()
            for _ in range(20):   # keep the card busy while the clock is read
                run(chains, warps)
            clock_mhz = float(smi("clocks.sm").split()[0])
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 5
            mmas = sms * warps * chains * ITERS
            # products a sub-partition (a quarter of an SM) issues
            per_sub = warps * chains * ITERS / min(warps, 4)
            print(json.dumps({
                "warps_per_sm": warps, "chains_per_warp": chains, "ms": ms,
                "tf32_tflops": mmas * FLOPS_PER_MMA / ms / 1e9,
                "sm_clock_mhz": clock_mhz,
                "cycles_per_mma_per_subpartition":
                    ms * 1e-3 * clock_mhz * 1e6 / per_sub}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
