#!/usr/bin/env python3
"""Where the serving path's time goes on the card: one prefill (through the
flash kernel, then through the plain attention route) and a run of decode
steps of the port's qwen2.5-14b at full width and depth (bf16, random
weights from a seeded generator), traced with ``torch.profiler``; or of
another served config at full width, its depth cut by ``--layers`` (an MoE
model runs the local path; a multi-token-prediction head, which serving
never reads, is not built). The dense and MoE configs run the slot pool
(one prompt a prefill, ``--slots`` slots a decode step); the recurrent
ones (``mamba2-2.7b``, ``recurrentgemma-2b``), the VLM
(``llama-3.2-vision-11b``) and the enc-dec (``seamless-m4t-large-v2``)
the lock-step route that serves them (``--slots`` prompts in one prefill,
then decode steps of the batch); the last two read a frontend ``[slots,
frontend_seq, d_model]``, standard normal in bf16, drawn on the card.

    python3 tools/serve_profile.py [--arch qwen2.5-14b] [--prompt-len 1000]
                                   [--slots 4] [--decode-steps 8]
                                   [--layers 48]
    python3 tools/serve_profile.py --arch dbrx-132b --layers 8
    python3 tools/serve_profile.py --arch deepseek-v3-671b --layers 2
    python3 tools/serve_profile.py --arch mamba2-2.7b --prompt-len 1024
    python3 tools/serve_profile.py --arch recurrentgemma-2b --prompt-len 1024
    python3 tools/serve_profile.py --arch llama-3.2-vision-11b \
        --prompt-len 1024
    python3 tools/serve_profile.py --arch seamless-m4t-large-v2 \
        --prompt-len 256

For each phase it prints one JSON line: the wall time (host clock around
work that ends in a synchronise), the device time summed over the phase's
kernels, their ratio as the device's busy share (one stream, so kernels do
not overlap), the number of kernel launches, and the device time by class —
the flash-attention kernel, matrix products (cuBLAS / CUTLASS kernels) and
everything else — with the ten kernels that took the most. ``--trace DIR``
also writes a Chrome trace of each phase to
``DIR/serve_profile_<phase>.json``. The last line gives the card's name and
power limit. It needs one CUDA device and ``nvcc`` (the flash
kernel is built at first use).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:  # flash_fwd_f32_kernel, flash_fwd_sm90_kernel
        return "flash_attention"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "sm90_")):
        return "matmul"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _phase(name: str, fn, out_dir) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"serve_profile_{name}.json"))
    by_class = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = []
    launches = 0
    for evt in prof.key_averages():
        dev = _device_us(evt)
        if dev <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_class[_kernel_class(evt.key)] += dev
        launches += evt.count
        kernels.append((dev, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    device_s = sum(by_class.values()) * 1e-6
    return {"phase": name, "wall_ms": wall_s * 1e3,
            "device_ms": device_s * 1e3,
            "device_busy_share": device_s / wall_s if wall_s else None,
            "kernel_launches": launches,
            "device_ms_by_class": {k: v * 1e-3 for k, v in by_class.items()},
            "top_kernels": [{"ms": d * 1e-3, "count": c, "name": n}
                            for d, c, n in kernels[:10]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0 = the config's own)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a Chrome trace of each phase into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving import ContinuousEngine, Request
    from repro_torch.serving.engine import SLOT_FAMILIES

    device = torch.device("cuda", 0)
    out_dir = args.trace
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cfg = dataclasses.replace(get_config(args.arch), mtp_depth=0)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rt = Runtime(tp=1, moe_impl="local")
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    params = model_mod.init_params(cfg, rt, gen, device=device)
    rng = np.random.default_rng(0)
    plain_rt = Runtime(moe_impl="local", attn_impl="plain")
    if cfg.family in SLOT_FAMILIES:
        route = "slot pool"
        eng = ContinuousEngine(cfg, rt, params, max_slots=args.slots,
                               max_len=2048)
        req = Request(rng.integers(0, cfg.vocab_size, args.prompt_len,
                                   dtype=np.int32), max_new_tokens=32)
        # warm: build the kernel, let cuBLAS pick its algorithms
        for slot in range(args.slots):
            eng.insert(eng.prefill(req), slot)
        plain = ContinuousEngine(cfg, plain_rt, params, max_slots=1,
                                 max_len=2048)

        def prefill():
            eng.prefill(req)

        def prefill_plain():
            plain.prefill(req)

        def step():
            eng.generate_step()
    else:
        route = "lock-step"
        from repro_torch.models import decode as decode_mod
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.slots, args.prompt_len),
            dtype=np.int32)).to(device)}
        if cfg.frontend_seq:
            batch["frontend"] = torch.randn(
                (args.slots, cfg.frontend_seq, cfg.d_model),
                generator=gen, device=device).to(torch.bfloat16)
        state = {}

        def run_prefill(r):
            return decode_mod.prefill(cfg, r, params, batch, 2048)

        def prefill():
            state["s"] = run_prefill(rt)[1]

        def prefill_plain():
            run_prefill(plain_rt)

        tok = torch.zeros((args.slots, 1), dtype=torch.int32, device=device)
        pos = torch.tensor(args.prompt_len, dtype=torch.int32, device=device)

        def step():
            decode_mod.decode_step(cfg, rt, params, tok, pos, state["s"])
        prefill()
    for _ in range(2):
        step()
    prefill_plain()
    rows = [_phase("prefill", prefill, out_dir),
            _phase("prefill_plain_attention", prefill_plain, out_dir)]

    def decode():
        for _ in range(args.decode_steps):
            step()
    rows.append(_phase("decode", decode, out_dir))
    rows[-1]["steps"] = args.decode_steps
    for r in rows:
        r.update(arch=cfg.name, n_layers=cfg.n_layers, route=route,
                 prompt_len=args.prompt_len, slots=args.slots)
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
