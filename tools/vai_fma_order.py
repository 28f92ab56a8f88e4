#!/usr/bin/env python3
"""Time orderings and register placements of the VAI kernel's FMA chain.

Builds ``tools/vai_fma_order.cu`` (the chain of the PR 11 kernel in ten
variants, described in that file) with the kernels' ``nvcc`` flags into
``build/`` (``kernels/build.py:build_probe``), checks that every variant
with the kernel's arithmetic equals variant A bit for bit, and prints one
JSON line per variant: what its FFMAs read by the SASS
(``build.ffma_bank_counts``: FFMAs, those whose three source registers sit
in one register bank, those with a ``.reuse`` operand), its time and
TFLOP/s at each loopsize, and the card's SM clock and power draw while it
runs at loopsize 8192. Then the same SASS counts of the shipped kernel's
``vai_fma_kernel`` instantiations, and the card's name and power limit.
The variants run first to last, then last to first, so a drift of the card
shows. Needs one CUDA device:

    python3 tools/vai_fma_order.py
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

ROWS = 2 ** 21                  # 2**28 elements, the main path's size
BLOCK_ROWS = 256
LOOPSIZES = (8, 64, 160, 1024, 8192)
VARIANTS = ("A", "B", "C", "D", "E", "Fb", "Fc", "P", "R1", "R2")
OTHER_ARITHMETIC = {"D"}        # a*a + z: timed, not compared


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()


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
    so = build.build_probe(Path(HERE) / "vai_fma_order.cu")
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    lib.vai_order.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr,
                              ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ptr]
    lib.vai_order.restype = ctypes.c_int
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    a, b, c = (torch.randn((ROWS, 128), generator=g, device="cuda")
               for _ in range(3))
    out = torch.empty_like(c)

    def launch(v: int, loopsize: int) -> None:
        code = lib.vai_order(v, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             out.data_ptr(), ROWS, BLOCK_ROWS, loopsize,
                             torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed with CUDA error {code}")

    want = {}
    order = list(range(len(VARIANTS)))
    for v in order + order[::-1]:
        name = VARIANTS[v]
        text = build.sass(f"vai_order_kernelILi{v}E", library=so)
        (build.build_dir() / f"vai_order_{name}.sass").write_text(text)
        cells = {}
        for loopsize in LOOPSIZES:
            ms = time_ms(lambda: launch(v, loopsize))
            torch.cuda.synchronize()
            if name in OTHER_ARITHMETIC:
                pass
            elif loopsize not in want:
                want[loopsize] = out.clone()
            elif not torch.equal(out, want[loopsize]):
                raise SystemExit(f"variant {name} differs from A at "
                                 f"loopsize {loopsize}")
            cells[str(loopsize)] = {
                "ms": ms, "tflops": 2 * loopsize * ROWS * 128 / ms / 1e9}
        for _ in range(8):              # about a second of queued work
            launch(v, 8192)
        under_load = smi("clocks.sm,power.draw")
        torch.cuda.synchronize()
        print(json.dumps({"variant": name,
                          "sass": build.ffma_bank_counts(text),
                          "by_loopsize": cells,
                          "sm_clock_power_under_load": under_load}),
              flush=True)
    shipped = build.sass("vai_fma_kernel")
    (build.build_dir() / "vai_fma_kernel.sass").write_text(shipped)
    print(json.dumps({"shipped_vai_fma_kernel": {
        chunk.split("\n", 1)[0].split("vai_fma_kernel", 1)[1][:12]:
        build.ffma_bank_counts(chunk)
        for chunk in shipped.split("Function : ")[1:]}}))
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
