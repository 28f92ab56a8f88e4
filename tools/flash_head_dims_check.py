#!/usr/bin/env python3
"""Both flash kernels at every head-dim class: what the compiler made of
each instantiation, every built tile against the plain version at head
dims from 1 to 256, and one timed shape a class.

Builds the kernels and prints ``nvcc``'s seconds, what ``ptxas`` said
about every instantiation of the f32 kernel (``flash_fwd_f32_kernel``) and
the bf16 kernel (``flash_fwd_sm90_kernel``): registers and spill bytes, and
their SASS counts of tensor-core products (HMMA for f32, HGMMA for bf16),
keyed ``D<class D>_<class Dv>_<block_q>x<block_k>``. Then, in f32 and in
bf16, at head dims ``(D, Dv)`` that cover every class and its edges
(:data:`SWEEP`, with ``Dv != D`` and widths that break the 16-byte copy
rule, which the wrapper copies into padded buffers), holds every tile the
kernel is built for at the class against the plain version
(``chip_smoke.py``'s tolerance, p rounded as in the kernel), causal over a
ragged length with GQA and non-causal with ``Sq != Skv``. Last, one shape
a class (:data:`TIMED`) at the model's tile, every built tile and
``F.scaled_dot_product_attention`` in turns for ROUNDS rounds: the median
and the spread, beside the bound on the true head dims. One JSON line per
result; exit 1 if an instantiation shows no tensor-core product or a tile
is outside the tolerance.

    python3 tools/flash_head_dims_check.py [--no-time]

Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS = 3
#: (D, Dv) checked in both dtypes: each class, its edges, Dv != D, and
#: widths whose rows break the 16-byte rule (1, 8 in f32, 20, 100)
SWEEP = ((1, 1), (8, 8), (16, 16), (20, 20), (24, 16), (32, 32), (33, 33),
         (48, 40), (80, 80), (96, 96), (100, 100), (128, 64), (150, 100),
         (160, 160), (170, 100), (192, 128), (192, 192), (200, 200),
         (64, 256), (256, 1), (256, 256))
#: (name, B, S, Hq, Hkv, D, Dv) timed causal, at the model's tile and
#: every built one: a class of each width at 4 x 1024 tokens of 16 heads,
#: MLA's prefill and RecurrentGemma's as served
TIMED = (("32", 4, 1024, 16, 16, 32, 32),
         ("96", 4, 1024, 16, 16, 96, 96),
         ("192", 4, 1024, 16, 16, 192, 192),
         ("16 (class 32)", 4, 1024, 16, 16, 16, 16),
         ("200 (class 256)", 4, 1024, 10, 1, 200, 200),
         ("mla", 1, 1024, 128, 128, 192, 128),
         ("rg", 4, 1024, 10, 1, 256, 256))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_head_dims_check: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    build.load_library()
    log = build.build_log()
    sass = cs.flash_sass_by_instantiation(build)
    built = cs.flash_instantiations()
    no_product = sorted(k for k in built if not sass.get(k))
    cs.emit(phase="build", nvcc_seconds=build.build_seconds,
            f32_ptxas=cs.ptxas_facts(log, "flash_fwd_f32_kernel"),
            bf16_ptxas=cs.ptxas_facts(log, "flash_fwd_sm90_kernel"),
            sass=sass, instantiations=len(sass),
            without_tensor_core_products=no_product)
    bad = len(no_product)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    for dt in (torch.float32, torch.bfloat16):
        it = dt.itemsize
        for D, Dv in SWEEP:
            dc, dvc = fa.head_dim_class(D, Dv)
            shares, copies = {}, 0
            for causal, B, Sq, Skv, Hq, Hkv in ((True, 1, 300, 300, 4, 2),
                                                (False, 2, 200, 333, 4, 4)):
                q = rnd((B, Sq, Hq, D), dt)
                k, v = rnd((B, Skv, Hkv, D), dt), rnd((B, Skv, Hkv, Dv), dt)
                q_opts, k_opts = fa.tile_options(it)
                for bq in q_opts:
                    for bk in k_opts:
                        if fa.unsupported(it, D, Dv, bq, bk):
                            continue
                        before = fa.PADDED_COPIES
                        got = fa.flash_attention_bshd(
                            q, k, v, causal=causal, block_q=bq, block_k=bk)
                        copies += fa.PADDED_COPIES - before
                        want = fa.flash_attention_plain(
                            q, k, v, causal=causal, block_q=bq, block_k=bk,
                            round_p=True)
                        _, share = cs.flash_error(got, want)
                        ok = share <= 1.0 and bool(torch.isfinite(got).all())
                        bad += not ok
                        shares[f"{'c' if causal else 'nc'} {bq}x{bk}"] = share
            torch.cuda.synchronize()
            cs.emit(phase="sweep", dtype=str(dt).replace("torch.", ""),
                    head_dims=[D, Dv], head_dim_class=[dc, dvc],
                    padded_copies=copies, worst_share=max(shares.values()),
                    share_of_limit_by_tile=shares,
                    tolerance=cs.flash_tolerance(dt))
    if args.no_time:
        cs.emit(phase="done", failures=bad)
        return 1 if bad else 0

    timer = cs.Timer(dev)
    for dt in (torch.float32, torch.bfloat16):
        for name, B, S, Hq, Hkv, D, Dv in TIMED:
            q = rnd((B, S, Hq, D), dt)
            k, v = rnd((B, S, Hkv, D), dt), rnd((B, S, Hkv, Dv), dt)
            runs = {}
            q_opts, k_opts = fa.tile_options(dt.itemsize)
            for bq in q_opts:
                for bk in k_opts:
                    if not fa.unsupported(dt.itemsize, D, Dv, bq, bk):
                        runs[f"{bq}x{bk}"] = functools.partial(
                            fa.flash_attention_bshd, q, k, v, causal=True,
                            block_q=bq, block_k=bk)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            runs["sdpa"] = functools.partial(
                F.scaled_dot_product_attention, qt, kt, vt, is_causal=True,
                enable_gqa=Hq != Hkv)
            times = {n: [] for n in runs}
            for _ in range(ROUNDS):
                for n, fn in runs.items():
                    times[n].append(timer(fn, reps=10, queued=True))
            sdpa = times.pop("sdpa")
            bound, by, flops, _ = cs.flash_bound_ms(B, Hq, Hkv, S, S, D,
                                                    dt.itemsize, True, Dv)
            model = "x".join(map(str, attn.flash_tiles(dt, (D, Dv))))
            med = {t: statistics.median(x) for t, x in times.items()}
            cs.emit(phase="timed", dtype=str(dt).replace("torch.", ""),
                    case=name, shape=f"q [{B},{S},{Hq},{D}], k [{B},{S},"
                    f"{Hkv},{D}], v [{B},{S},{Hkv},{Dv}] causal",
                    head_dim_class=list(fa.head_dim_class(D, Dv)),
                    model_tile=model, ms=med[model], ms_by_tile=med,
                    spread_by_tile={t: [min(x), max(x)]
                                    for t, x in times.items()},
                    sdpa_ms=statistics.median(sdpa),
                    sdpa_spread=[min(sdpa), max(sdpa)], rounds=ROUNDS,
                    bound_ms=bound, bound_by=by,
                    achieved_share=bound / med[model],
                    tflops=flops / med[model] / 1e9,
                    device=torch.cuda.get_device_name(0))
            del q, k, v, qt, kt, vt
    cs.emit(phase="done", failures=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
