#!/usr/bin/env python3
"""Both flash kernels at every head-dim class: what the compiler made of
each instantiation, every built tile against the plain version at head
dims from 1 to 1024, and one timed shape a class.

Builds the kernels and prints ``nvcc``'s seconds, what ``ptxas`` said
about every instantiation of the f32 kernel (``flash_fwd_f32_kernel``,
``flash_fwd_f32_chunked_kernel``) and the wgmma kernel
(``flash_fwd_sm90_kernel``, ``flash_fwd_sm90_chunked_kernel``, bf16 and
f16): registers and spill bytes, and their SASS counts of tensor-core
products (HMMA for f32, HGMMA for bf16 and f16), keyed as
``chip_smoke.flash_key`` keys them. Then, in f32, bf16 and f16, at head
dims ``(D, Dv)`` that cover every class and its edges and the chunked
kernels' widths above 256 (:data:`SWEEP`, with ``Dv != D`` and widths that
break the 16-byte copy rule, which the wrapper copies into padded
buffers), holds every tile the kernel is built for at the class against
the plain version
(``chip_smoke.py``'s tolerance, p rounded as in the kernel), causal over a
ragged length with GQA and non-causal with ``Sq != Skv``. Last, one shape
a class (:data:`TIMED`) at the model's tile, every built tile and
``F.scaled_dot_product_attention`` in turns for ROUNDS rounds: the median
and the spread, beside the bound on the true head dims.

``--baseline-src DIR`` names another copy of the kernels' ``csrc/`` (an
earlier commit's, unpacked with ``git archive``), which is built into its
own directory under ``build/`` and called through the same C entry point:
at the head dims above 256 (:data:`TIMED_WIDE`) every tile of that design
runs in the same turns as this one's, and its registers and spills are
reported beside this build's. One JSON line per result; exit 1 if an
instantiation shows no tensor-core product or a tile is outside the
tolerance.

    python3 tools/flash_head_dims_check.py [--no-time] [--baseline-src DIR]
    # the parent commit's design beside this one:
    mkdir -p build/parent && git archive HEAD~1 src/repro_torch/kernels/csrc \
        | tar -x -C build/parent
    python3 tools/flash_head_dims_check.py \
        --baseline-src build/parent/src/repro_torch/kernels/csrc

Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS = 3
#: (D, Dv) checked in every dtype: each class, its edges, Dv != D, widths
#: whose rows break the 16-byte rule (1, 8 in f32, 20, 100), and the
#: chunked kernels' widths above 256 (each slice class, D or Dv alone
#: wide, up to (1024, 1024))
SWEEP = ((1, 1), (8, 8), (16, 16), (20, 20), (24, 16), (32, 32), (33, 33),
         (48, 40), (80, 80), (96, 96), (100, 100), (128, 64), (150, 100),
         (160, 160), (170, 100), (192, 128), (192, 192), (200, 200),
         (64, 256), (256, 1), (256, 256), (257, 257), (300, 64), (64, 300),
         (320, 320), (512, 128), (512, 512), (576, 512), (1000, 20),
         (1024, 1024))
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: (name, B, S, Hq, Hkv, D, Dv) timed causal in every dtype, at the model's
#: tile and every built one: a class of each width at 4 x 1024 tokens of 16
#: heads, MLA's prefill and RecurrentGemma's as served, and one pair of
#: each slice class of the chunked kernels
TIMED = (("32", 4, 1024, 16, 16, 32, 32),
         ("96", 4, 1024, 16, 16, 96, 96),
         ("192", 4, 1024, 16, 16, 192, 192),
         ("16 (class 32)", 4, 1024, 16, 16, 16, 16),
         ("200 (class 256)", 4, 1024, 10, 1, 200, 200),
         ("mla", 1, 1024, 128, 128, 192, 128),
         ("rg", 4, 1024, 10, 1, 256, 256),
         ("300x64 (slice 128)", 4, 1024, 16, 16, 300, 64),
         ("512x128 (slice 128)", 4, 1024, 16, 16, 512, 128),
         ("512 (slice 512)", 4, 1024, 16, 16, 512, 512))
#: the head dims above 256 timed beside the baseline design: TIMED's wide
#: rows, and (300, 64), (512, 512) and DeepSeek-V3's absorbed MLA shape
#: (576, 512) at one batch row
TIMED_WIDE = TIMED[-3:] + (
    ("300x64 [1,1024,16]", 1, 1024, 16, 16, 300, 64),
    ("512 [1,1024,16]", 1, 1024, 16, 16, 512, 512),
    ("576x512 [1,1024,16]", 1, 1024, 16, 16, 576, 512))
#: the tiles of the chunked kernels before their redesign (the design that
#: recomputed S for each 256-column slice of v: f32 32 x 64 and 64 x 64,
#: bf16 and f16 64 x 64), run for the baseline
BASELINE_TILES = {4: ((32, 64), (64, 64)), 2: ((64, 64),)}
#: the chunked kernels' names in the build log
CHUNKED = ("flash_fwd_f32_chunked_kernel", "flash_fwd_sm90_chunked_kernel")


def baseline_runner(src: str):
    """Build the kernels of ``src`` (another copy of ``csrc/``) into
    build/baseline and return ``(call, ptxas)``: ``call(q, k, v, causal,
    block_q, block_k)`` launches that library's flash kernel as the
    wrapper launches this one's (no padded copies: the timed shapes keep
    the 16-byte rule), and ``ptxas`` its chunked kernels' registers and
    spills."""
    from pathlib import Path

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    bdir = Path(HERE).parent / "build" / "baseline"
    lib = build.bind(build.build(Path(src), bdir))
    log = build.build_log(bdir)
    ptxas = {k: cs.ptxas_facts(log, k) for k in CHUNKED}

    def call(q, k, v, causal, block_q, block_k):
        B, Sq, Hq, D = q.shape
        _, Skv, Hkv, Dv = v.shape
        # as the wrapper does: a tensor breaking the 16-byte rule is copied
        q, k, v = (t if fa.copy_rule_holds(t) else fa._padded(t)
                   for t in (q, k, v))
        out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
        code = lib.repro_flash_attention(
            {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, Dv, *fa.tma_strides(q)[:3],
            *fa.tma_strides(k)[:3], *fa.tma_strides(v)[:3],
            *out.stride()[:3], int(causal), D ** -0.5, block_q, block_k,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if code != 0:
            raise RuntimeError(
                f"baseline flash_attention: CUDA error {code} "
                f"({lib.repro_error_string(code).decode()})")
        return out
    return call, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    ap.add_argument("--baseline-src", default=None,
                    help="another copy of csrc/ to time beside this one "
                         "at the head dims above 256")
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
            f32_chunked_ptxas=cs.ptxas_facts(log,
                                             "flash_fwd_f32_chunked_kernel"),
            sm90_ptxas=cs.ptxas_facts(log, "flash_fwd_sm90_kernel"),
            sm90_chunked_ptxas=cs.ptxas_facts(
                log, "flash_fwd_sm90_chunked_kernel"),
            sass=sass, instantiations=len(sass),
            without_tensor_core_products=no_product)
    bad = list(no_product)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    for dt in DTYPES:
        it = dt.itemsize
        for D, Dv in SWEEP:
            dc, dvc = fa.head_dim_class(D, Dv)
            shares, copies = {}, 0
            for causal, B, Sq, Skv, Hq, Hkv in ((True, 1, 300, 300, 4, 2),
                                                (False, 2, 200, 333, 4, 4)):
                q = rnd((B, Sq, Hq, D), dt)
                k, v = rnd((B, Skv, Hkv, D), dt), rnd((B, Skv, Hkv, Dv), dt)
                q_opts, k_opts = fa.tile_options(it, D, Dv)
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
                        tile = f"{'c' if causal else 'nc'} {bq}x{bk}"
                        if not ok:
                            bad.append(f"{dt} {D}x{Dv} {tile}: {share}")
                        shares[tile] = share
            torch.cuda.synchronize()
            cs.emit(phase="sweep", dtype=str(dt).replace("torch.", ""),
                    head_dims=[D, Dv], head_dim_class=[dc, dvc],
                    padded_copies=copies, worst_share=max(shares.values()),
                    share_of_limit_by_tile=shares,
                    tolerance=cs.flash_tolerance(dt))
    if args.no_time:
        cs.emit(phase="done", failures=len(bad), failed=bad)
        return 1 if bad else 0

    timer = cs.Timer(dev)
    base, base_ptxas = (baseline_runner(args.baseline_src)
                        if args.baseline_src else (None, None))
    if base_ptxas is not None:
        cs.emit(phase="baseline_build", src=args.baseline_src,
                chunked_ptxas=base_ptxas,
                chunked_ptxas_new={k: cs.ptxas_facts(log, k)
                                   for k in CHUNKED})
    for dt in DTYPES:
        for name, B, S, Hq, Hkv, D, Dv in TIMED + TIMED_WIDE[3:]:
            wide = fa.is_wide(D, Dv)
            q = rnd((B, S, Hq, D), dt)
            k, v = rnd((B, S, Hkv, D), dt), rnd((B, S, Hkv, Dv), dt)
            runs = {}
            q_opts, k_opts = fa.tile_options(dt.itemsize, D, Dv)
            for bq in q_opts:
                for bk in k_opts:
                    if not fa.unsupported(dt.itemsize, D, Dv, bq, bk):
                        runs[f"{bq}x{bk}"] = functools.partial(
                            fa.flash_attention_bshd, q, k, v, causal=True,
                            block_q=bq, block_k=bk)
            if base is not None and wide:
                # the earlier design's tiles: each held against the plain
                # version before it is timed
                for bq, bk in BASELINE_TILES[dt.itemsize]:
                    try:
                        got = base(q, k, v, True, bq, bk)
                    except RuntimeError as exc:
                        bad.append(f"baseline {dt} {name} {bq}x{bk}: {exc}")
                        continue
                    want = fa.flash_attention_plain(
                        q, k, v, causal=True, block_q=bq, block_k=bk,
                        round_p=True)
                    _, share = cs.flash_error(got, want)
                    if share > 1.0:
                        bad.append(f"baseline {dt} {name} {bq}x{bk}: {share}")
                    runs[f"baseline {bq}x{bk}"] = functools.partial(
                        base, q, k, v, True, bq, bk)
                    del got, want
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
            row = dict(
                phase="timed", dtype=str(dt).replace("torch.", ""),
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
            base_ms = {t: x for t, x in med.items()
                       if t.startswith("baseline ")}
            if base_ms:
                best_new = min(x for t, x in med.items() if t not in base_ms)
                row.update(baseline_best_ms=min(base_ms.values()),
                           speedup_best_tile=min(base_ms.values()) / best_new)
            cs.emit(**row)
            del q, k, v, qt, kt, vt
    cs.emit(phase="done", failures=len(bad), failed=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
