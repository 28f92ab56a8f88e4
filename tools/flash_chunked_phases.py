#!/usr/bin/env python3
"""Where a 64 x 64 tile of the chunked wgmma flash kernel spends its cycles.

Builds the kernels with ``-DREPRO_FLASH_PHASES`` into build/phases/, which
turns on the clock64 probes of flash_fwd_sm90_chunked_kernel
(``REPRO_PHASE`` in ``csrc/flash_attention_sm90.cuh``) and the reader of
their sums, and runs it in bf16 at three wide shapes (causal, [4, 1024, 16,
·]). The probes time warpgroup 0's waits for the K ring, its waits for its
products, its refills of the ring, its softmax, its wait for warpgroup 1
and its waits for V, and warpgroup 1's waits for P, for V, for its products
and for the next V tile; each is summed by the first thread of its
warpgroup over every block. Prints, for each shape, those sums divided by
the kv tiles the grid visits, beside each warpgroup's whole walk. The
probes cost cycles of their own, so the walk runs a little longer than the
unprobed kernel's.

    python3 tools/flash_chunked_phases.py

Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

#: (name, slot of g_phase_cycles): warpgroup 0's phases and walk, then
#: warpgroup 1's (csrc/flash_attention_sm90.cuh, REPRO_PHASE)
PHASES = (("k_full wait", 0), ("wait<1>", 1), ("refill", 2), ("wait<0>", 3),
          ("softmax", 4), ("wait for P free", 5), ("V wait", 6),
          ("walk", 7), ("wg1 wait for P", 8), ("wg1 V wait", 9),
          ("wg1 wait<0>", 10), ("wg1 next V", 11), ("wg1 walk", 15))
#: (name, B, S, H, D, Dv), causal, H q heads over H kv heads
SHAPES = (("512x128", 4, 1024, 16, 512, 128), ("512", 4, 1024, 16, 512, 512),
          ("300x64", 4, 1024, 16, 300, 64))


def probed_library() -> ctypes.CDLL:
    """The kernels built with their phase probes, under build/phases."""
    lib = build.bind(build.build(bdir=ROOT / "build" / "phases",
                                 flags=["-DREPRO_FLASH_PHASES"]))
    lib.repro_flash_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_chunked_phases: no CUDA device", file=sys.stderr)
        return 2
    lib = probed_library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name, B, S, H, D, Dv in SHAPES:
        q, k, v = (torch.randn((B, S, H, w), generator=g, device=dev).to(
            torch.bfloat16) for w in (D, D, Dv))
        q, k, v = (t if fa.copy_rule_holds(t) else fa._padded(t)
                   for t in (q, k, v))
        o = torch.empty((B, S, H, Dv), dtype=torch.bfloat16, device=dev)

        def launch():
            code = lib.repro_flash_attention(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                H, H, S, S, D, Dv, *fa.tma_strides(q)[:3],
                *fa.tma_strides(k)[:3], *fa.tma_strides(v)[:3],
                *o.stride()[:3], 1, D ** -0.5, 64, 64, stream)
            if code != 0:
                raise RuntimeError(f"flash_chunked_phases: CUDA error {code}")
        launch()                           # warm: build, first launch
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 16)()
        lib.repro_flash_phases(sums, 1)
        launch()
        torch.cuda.synchronize()
        lib.repro_flash_phases(sums, 0)
        tiles = B * H * sum(i + 1 for i in range(-(-S // 64)))
        print(json.dumps({
            "phase": "cycles_a_tile", "shape": name, "dtype": "bfloat16",
            "q": [B, S, H, D], "v": [B, S, H, Dv], "tiles": tiles,
            "device": torch.cuda.get_device_name(0),
            "cycles": {n: sums[i] / tiles for n, i in PHASES}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
