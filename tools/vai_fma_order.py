#!/usr/bin/env python3
"""Time three orderings of the VAI kernel's FMA chain on the card.

The VAI kernel of ``repro_torch`` reaches about two thirds of an H100's fp32
FMA rate where it is bound by operations. This script builds
``tools/vai_fma_order.cu`` (the kernel's loop in three orderings, and once
with two register operands an FMA instead of three, at two unroll depths) with ``nvcc`` into ``build/``, checks that the orderings agree
bit for bit, and prints one JSON line per (unroll, ordering) with the time
and the achieved TFLOP/s at each loopsize, then the card's SM clock and
power draw sampled while the kernel runs. Needs one CUDA device:

    python3 tools/vai_fma_order.py
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ROWS = 2 ** 21                  # 2**28 elements, the main path's size
BLOCK_ROWS = 256
LOOPSIZES = (8, 64, 160, 1024, 8192)
ORDERS = ("together", "one_after_the_other", "two_steps_each",
          "together_two_operands")
SAME_ARITHMETIC = (0, 1, 2)     # the last ordering computes a*a + z


def time_ms(fn, reps: int = 3) -> float:
    fn()
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
    return min(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    if not torch.cuda.is_available():
        print("vai_fma_order: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    out_dir = os.path.join(ROOT, "build", "vai_fma_order")
    os.makedirs(out_dir, exist_ok=True)
    smi = ["nvidia-smi", "--format=csv,noheader"]
    print(subprocess.run(smi + ["--query-gpu=name,power.limit"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    a, b, c = (torch.randn((ROWS, 128), generator=g, device="cuda")
               for _ in range(3))
    out = torch.empty_like(c)
    ptr = ctypes.c_void_p
    for unroll in (8, 16):
        so = os.path.join(out_dir, f"libvai_order_u{unroll}.so")
        subprocess.run(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", f"-DCHAIN_UNROLL={unroll}", "-shared", "-o", so,
             os.path.join(HERE, "vai_fma_order.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.vai_order.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr,
                                  ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_int, ptr]
        lib.vai_order.restype = ctypes.c_int

        def launch(order: int, loopsize: int) -> None:
            code = lib.vai_order(
                order, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                out.data_ptr(), ROWS, BLOCK_ROWS, loopsize,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed with CUDA error {code}")

        want = {}
        # first, second, third, then back: a drift of the card would show
        for order in (0, 1, 2, 3, 3, 2, 1, 0):
            cells = {}
            for loopsize in LOOPSIZES:
                ms = time_ms(lambda: launch(order, loopsize))
                torch.cuda.synchronize()
                if order not in SAME_ARITHMETIC:
                    pass
                elif loopsize not in want:
                    want[loopsize] = out.clone()
                elif not torch.equal(out, want[loopsize]):
                    raise SystemExit(
                        f"ordering {ORDERS[order]} differs at {loopsize}")
                cells[str(loopsize)] = {
                    "ms": ms,
                    "tflops": 2 * loopsize * ROWS * 128 / ms / 1e9}
            print(json.dumps({"unroll": unroll, "order": ORDERS[order],
                              "by_loopsize": cells}), flush=True)
    for _ in range(10):                 # about a second of queued work
        launch(0, 8192)
    under_load = subprocess.run(
        smi + ["--query-gpu=clocks.sm,power.draw"], capture_output=True,
        text=True).stdout.strip()
    torch.cuda.synchronize()
    print(json.dumps({"under_load": under_load}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
