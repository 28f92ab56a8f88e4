#!/usr/bin/env python3
"""The VAI kernel on the card, timed in turns with the PyTorch call that
computes the same function, and beside the other designs of its streaming
end.

At the main path's shape (a, b, c ``[2097152, 128]`` f32) it prints one
JSON line per measurement; every side is timed in each of ``--rounds``
rounds, the order of the sides turning from round to round, and reported as
the min / median / max of its launches (CUDA events around each):

- ``in_turns``: the kernel (through ``kernels.vai.vai``) and
  ``torch.addcmul(c, a, b, value=L)`` (``b.clone()`` at L = 0), at
  loopsizes 0, 8, 256, 1024 and 8192 and ``block_rows`` 128 to 1024, with
  the bound and the achieved rate;
- ``designs``: at loopsizes 0 and 8 and every ``block_rows``, the kernel
  beside the designs of ``tools/vai_stream.cu`` (the register path at other
  block sizes, depths, cache hints and grids, and TMA bulk-copy rings),
  each checked bit for bit against the kernel;
- ``threshold``: at loopsizes 16 to 256, the kernel beside the shapes of
  its bytes end and its operations end, to show where one gives way to the
  other;
- ``ops``: at loopsizes 1024 and 8192, the kernel beside a few designs;
- ``against``: with ``--against FILE.cu``, another source with the same C
  entry point ``repro_vai_f32`` (for example the kernel of an earlier
  commit) is built by ``build.build_probe``, timed as one more side in every
  section and checked bit for bit against the kernel.

Then the SASS counts of the kernel's FMA instantiations
(``build.ffma_bank_counts``), the SM clock and power under load at loopsize
8192, and the card's name and power limit. Needs one CUDA device:

    python3 tools/vai_check.py [--against OTHER/vai.cu] [--rounds 3]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ROWS = 2 ** 21                  # 2**28 elements, the main path's size
HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet
FP32_FMA_FLOPS = 66.9e12        # 132 SMs x 128 lanes x 2 x 1.98 GHz
IN_TURNS_LOOPSIZES = (0, 8, 256, 1024, 8192)
BLOCK_ROWS = (128, 256, 512, 1024)
DESIGN_LOOPSIZES = (0, 8)
#: tools/vai_stream.cu's designs by number: (i) the register path as
#: threads x float4s in flight a thread (loads .nc, stores .wb, one block a
#: tile unless named otherwise); (ii) TMA rings as stages x chunk
DESIGNS = {"reg_256x1": 0, "reg_256x2": 1, "reg_512x2": 2, "reg_512x4": 3,
           "reg_1024x1": 4, "reg_1024x2": 5, "reg_1024x4": 6,
           "reg_1024x8": 7, "reg_1024x16": 8, "reg_128x2": 9,
           "reg_256x1_cs_cs": 10, "reg_256x4_wave": 11, "tma_3x16KB": 12,
           "tma_3x8KB": 13}
#: where bytes give way to operations: the kernel's two shapes beside it
THRESHOLD_LOOPSIZES = (16, 32, 64, 128, 256)
THRESHOLD_DESIGNS = ("reg_1024x4", "reg_256x2", "reg_512x2")
#: the operations end: the kernel beside a few register-path shapes
OPS_LOOPSIZES = (1024, 8192)
OPS_DESIGNS = ("reg_256x1", "reg_256x2", "reg_512x2", "reg_1024x4",
               "tma_3x16KB")

def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()


def bound_ms(loopsize: int):
    from repro_torch.kernels import vai_flops_bytes
    flops, byts = vai_flops_bytes(ROWS * 128, loopsize)
    by_bytes = byts / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FMA_FLOPS * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", flops, byts)


def ptxas_registers(log: str, substring: str) -> dict:
    """Registers (and spill bytes, if any) that ``ptxas -v`` reported for
    each kernel whose name holds ``substring``."""
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if substring in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current and int(m.group(1)):
            found[current + ":spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            found[current] = int(m.group(1))
            current = None
    return found


def launches_ms(fn, reps: int):
    """Milliseconds of each of ``reps`` runs of ``fn`` after a warm-up."""
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
    return [s.elapsed_time(e) for s, e in pairs]


def in_turns(sides: dict, rounds: int, reps: int) -> dict:
    """Each side timed once a round; the order of the sides turns by one
    each round."""
    names = list(sides)
    got = {n: [] for n in names}
    for r in range(rounds):
        k = r % len(names)
        for n in names[k:] + names[:k]:
            got[n] += launches_ms(sides[n], reps)
    return {n: {"min_ms": min(v), "median_ms": statistics.median(v),
                "max_ms": max(v)} for n, v in got.items()}


def c_entry(lib: ctypes.CDLL, name: str, extra: int):
    fn = getattr(lib, name)
    ptr = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int] * extra + [ptr] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another vai.cu with the C entry point "
                         "repro_vai_f32, timed and compared as one more side")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vai_check: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import vai as vai_mod
    print(json.dumps({"device": smi("name,power.limit")}), flush=True)
    build.load_library()
    probe = build.build_probe(Path(HERE) / "vai_stream.cu")
    stream_fn = c_entry(ctypes.CDLL(str(probe)), "vai_stream", 1)
    other_fn = None
    if args.against is not None:
        src = args.against.resolve()
        other_fn = c_entry(ctypes.CDLL(str(build.build_probe(src))),
                           "repro_vai_f32", 0)
    print(json.dumps({"ptxas_registers": {
        "kernel": ptxas_registers(build.build_log(), "vai_"),
        "probe": ptxas_registers(probe.with_suffix(".log").read_text(),
                                 "vai_")}}), flush=True)

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    a, b, c = (torch.randn((ROWS, 128), generator=g, device="cuda")
               for _ in range(3))
    outs = {}

    def buf(name):
        if name not in outs:
            outs[name] = torch.empty_like(c)
        return outs[name]

    def call(fn, name, *lead):
        def run(L, br):
            out = buf(name)
            code = fn(*lead, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      out.data_ptr(), ROWS, br, L,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
            return out
        return run

    def kernel(L, br):
        return vai_mod.vai(a, b, c, loopsize=L, block_rows=br)

    def library(L, br):
        return b.clone() if L == 0 else torch.addcmul(c, a, b, value=L)

    others = {}
    if other_fn is not None:
        others["against"] = call(other_fn, "against")

    def same_bits(sides, L, br):
        want = kernel(L, br)
        for name, fn in sides.items():
            got = fn(L, br)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"vai_check: {name} differs from the kernel "
                                 f"at loopsize {L}, block_rows {br}")

    def sides_at(L, br, extra):
        every = {"kernel": kernel, "library": library, **others, **extra}
        return {n: (lambda f=f: f(L, br)) for n, f in every.items()}

    for L in IN_TURNS_LOOPSIZES:
        bound, by, flops, byts = bound_ms(L)
        for br in BLOCK_ROWS:
            same_bits(others, L, br)
            t = in_turns(sides_at(L, br, {}), args.rounds, reps=3)
            k = t["kernel"]["median_ms"]
            print(json.dumps({
                "section": "in_turns", "loopsize": L, "block_rows": br,
                "sides": t, "bound_ms": bound, "bound_by": by,
                "kernel_over_library": k / t["library"]["median_ms"],
                "gbytes_s": byts / k / 1e6, "tflops": flops / k / 1e9}),
                flush=True)

    designs = {n: call(stream_fn, n, k) for n, k in DESIGNS.items()}
    for L in DESIGN_LOOPSIZES:
        bound, by, flops, byts = bound_ms(L)
        for br in BLOCK_ROWS:
            same_bits({**others, **designs}, L, br)
            t = in_turns(sides_at(L, br, designs), args.rounds, reps=5)
            print(json.dumps({
                "section": "designs", "loopsize": L, "block_rows": br,
                "sides": t, "bound_ms": bound, "bound_by": by,
                "gbytes_s_by_side": {n: byts / v["median_ms"] / 1e6
                                     for n, v in t.items()}}), flush=True)

    for L in THRESHOLD_LOOPSIZES:
        bound, by, flops, byts = bound_ms(L)
        near = {n: designs[n] for n in THRESHOLD_DESIGNS}
        same_bits(near, L, 256)
        t = in_turns(sides_at(L, 256, near), args.rounds, reps=5)
        print(json.dumps({
            "section": "threshold", "loopsize": L, "block_rows": 256,
            "sides": t, "bound_ms": bound, "bound_by": by,
            "tflops_by_side": {n: flops / v["median_ms"] / 1e9
                               for n, v in t.items()}}), flush=True)

    ops = {n: designs[n] for n in OPS_DESIGNS}
    for L in OPS_LOOPSIZES:
        bound, by, flops, byts = bound_ms(L)
        same_bits(ops, L, 256)
        t = in_turns(sides_at(L, 256, ops), args.rounds, reps=3)
        print(json.dumps({
            "section": "ops", "loopsize": L, "block_rows": 256,
            "sides": t, "bound_ms": bound, "bound_by": by,
            "tflops_by_side": {n: flops / v["median_ms"] / 1e9
                               for n, v in t.items()}}), flush=True)

    text = build.sass("vai_fma_kernel")
    counts = {}
    for chunk in text.split("Function : ")[1:]:
        m = re.search(r"vai_fma_kernelILi(\d+)ELi(\d+)E", chunk)
        counts[f"{m.group(1)}x{m.group(2)}" if m else "?"] = (
            build.ffma_bank_counts(chunk))
    for _ in range(8):                  # about a second of queued work
        kernel(8192, 256)
    under_load = smi("clocks.sm,power.draw")
    torch.cuda.synchronize()
    print(json.dumps({"sass": counts,
                      "sm_clock_power_under_load_8192": under_load}))
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
