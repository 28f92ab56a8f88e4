#!/usr/bin/env python3
"""What the compiler made of the bf16 tensor-core flash-attention kernel,
and its tiles at more shapes.

Builds the kernels, prints what ``ptxas`` said about the bf16 kernel
(registers, spills, setmaxnreg), its SASS counts of tensor-core products
(HGMMA) and TMA loads (UTMALDG) and the highest register each
instantiation uses. Then, at the lock-step route's ragged prefill (q
``[1,1000,40,128]``), at head dim 160 (q ``[1,1024,32,160]``), at MLA's
prefill (q/k ``[1,1024,128,192]``, v ``[1,1024,128,128]``) and at
RecurrentGemma's local-attention prefill (q ``[1,1024,10,256]``, k/v
``[1,1024,1,256]``, and its ragged 1000), and non-causal at the shapes the
VLM and enc-dec paths give it (llama-3.2-vision-11b's cross-attention, q
``[4,1024,32,128]`` and at a decode step ``[4,1,32,128]`` over k/v
``[4,1600,8,128]``; seamless-m4t-large-v2's encoder, q/k/v
``[4,4096,16,64]``, and its cross-attention at a decode step, q
``[4,1,16,64]`` over k/v ``[4,4096,16,64]``), holds every tile the kernel
is built for against the plain version and times it beside
``F.scaled_dot_product_attention``, with ``chip_smoke.py``'s timer and
tolerance (``chip_smoke.py`` checks every other case), in ROUNDS rounds
that take the tiles and SDPA in turns: the median of the rounds and their
spread (least, most). One JSON line per result; exit 1 if a tile is
outside the tolerance.

    python3 tools/flash_sm90_check.py

Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import functools
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import statistics  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: rounds of timing, each taking every tile and SDPA in turn
ROUNDS = 5
#: (B, Sq, Skv, Hq, Hkv, D, Dv, causal) of each timed shape
SHAPES = ((1, 1000, 1000, 40, 8, 128, 128, True),
          (1, 1024, 1024, 32, 8, 160, 160, True),
          (1, 1024, 1024, 128, 128, *cs.MLA_HEAD_DIMS, True),
          (1, 1024, 1024, 10, 1, 256, 256, True),
          (1, 1000, 1000, 10, 1, 256, 256, True),
          (4, 1024, 1600, 32, 8, 128, 128, False),
          (4, 1, 1600, 32, 8, 128, 128, False),
          (4, 4096, 4096, 16, 16, 64, 64, False),
          (4, 1, 4096, 16, 16, 64, 64, False))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sm90_check: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.load_library()
    log = build.build_log()
    part = log[log.find("flash_attention_sm90"):]
    cs.emit(phase="ptxas", nvcc_seconds=build.build_seconds,
            lines=[ln for ln in part.splitlines()[:200]
                   if re.search(r"flash_fwd_sm90|registers|spill|setmaxnreg|"
                                r"warning|error", ln)])
    text = build.sass("flash_fwd_sm90")
    regs = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        used = [int(r) for r in re.findall(r"\bR(\d+)\b", chunk)]
        regs[re.sub(r".*kernelIL", "", name)[:40]] = max(used, default=-1)
    cs.emit(phase="sass", hgmma=text.count("HGMMA"),
            utmaldg=text.count("UTMALDG"), highest_register=regs)

    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    bad = 0
    for B, Sq, Skv, Hq, Hkv, D, Dv, causal in SHAPES:
        q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, Dv)
        runs, share = {}, {}
        for bq in fa.BF16_BLOCK_Q_OPTIONS:
            for bk in fa.BF16_BLOCK_K_OPTIONS:
                if fa.unsupported(2, D, Dv, bq, bk):
                    continue
                tile = f"{bq}x{bk}"
                got = fa.flash_attention_bshd(q, k, v, causal=causal,
                                              block_q=bq, block_k=bk)
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                block_q=bq, block_k=bk,
                                                round_p=True)
                _, share[tile] = cs.flash_error(got, want)
                bad += share[tile] > 1.0
                runs[tile] = functools.partial(
                    fa.flash_attention_bshd, q, k, v, causal=causal,
                    block_q=bq, block_k=bk)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        runs["sdpa"] = functools.partial(
            F.scaled_dot_product_attention, qt, kt, vt, is_causal=causal,
            enable_gqa=Hq != Hkv)
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):
            for name, fn in runs.items():
                times[name].append(timer(fn, reps=20, queued=True))
        bound, by, _, _ = cs.flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, 2, causal,
                                            Dv)
        sdpa = times.pop("sdpa")
        cs.emit(phase="tiles", shape=f"q [{B},{Sq},{Hq},{D}], k [{B},{Skv},"
                f"{Hkv},{D}], v [{B},{Skv},{Hkv},{Dv}] bf16 "
                + ("causal" if causal else "non-causal"),
                ms_by_tile={t: statistics.median(x) for t, x in times.items()},
                spread_by_tile={t: [min(x), max(x)] for t, x in times.items()},
                sdpa_ms=statistics.median(sdpa), sdpa_spread=[min(sdpa),
                                                              max(sdpa)],
                rounds=ROUNDS, bound_ms=bound, bound_by=by,
                share_of_limit_by_tile=share,
                tolerance=cs.flash_tolerance(torch.bfloat16),
                device=torch.cuda.get_device_name(0))
        del q, k, v, qt, kt, vt
    cs.emit(phase="done", tiles_outside_tolerance=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
