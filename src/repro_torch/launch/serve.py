"""Serving CLI: batched generation with energy telemetry + power policy,
on the card.

    python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --batch 4 --new-tokens 16 --policy energy-aware

``--reduced`` serves the arch's tiny same-family config in f32 (add
``--device cpu`` to run it without a card). Weights are random, drawn from
a generator seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import get_config
from repro_torch.models import model as model_mod
from repro_torch.models.transformer import Runtime
from repro_torch.power import EnergySession
from repro_torch.serving import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--policy", default="nominal",
                    choices=["nominal", "static", "power-cap",
                             "energy-aware"])
    ap.add_argument("--slowdown-budget", type=float, default=0.0)
    ap.add_argument("--freq-mhz", type=int, default=None)
    ap.add_argument("--power-cap-w", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with "
                         "--reduced) to serve on the host")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    rt = Runtime()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model_mod.init_params(cfg, rt, gen, device=device)

    session = EnergySession(policy=args.policy,
                            slowdown_budget=args.slowdown_budget,
                            freq_mhz=args.freq_mhz,
                            cap_w=args.power_cap_w, device=device)
    engine = ServeEngine(cfg, rt, params, max_len=args.max_len,
                         session=session)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.batch)]
    outs = engine.generate(reqs, temperature=args.temperature,
                           seed=args.seed)
    for i, o in enumerate(outs[: min(4, len(outs))]):
        print(f"req{i}: {o.tolist()}")
    s = session.summary()
    print(f"policy {s['policy']}  energy {s['energy_j']:.1f} J  "
          f"savings {s['savings_pct']:.1f}%  "
          f"mode-hours {s['mode_hours_pct']}")
    return {"outputs": outs, "summary": s}


if __name__ == "__main__":
    main()
