#!/usr/bin/env python3
"""Where a broker tick's time goes on the card: ``simulate_cluster`` over a
synthetic cluster trace (``ClusterTrace.synthetic``, the shape of
benchmarks/bench_broker.py at fewer jobs), traced with ``torch.profiler``.

    python3 tools/broker_profile.py [--jobs 3000] [--budget-mw 2.0]
                                    [--broker greedy]

It prints one JSON line per broker run: the wall time and ticks, the host
tensor operations a tick issues (``aten::`` ops, views included), the
kernel launches and device time a tick takes, and the device's busy share
(device time over wall time; one stream, so kernels do not overlap), with
the ten kernels that took the most; then the same run on CPU tensors,
untraced, for its wall time. The last line gives the card's name and power
limit. It needs one CUDA device.
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

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=3000)
    ap.add_argument("--budget-mw", type=float, default=2.0)
    ap.add_argument("--arrival-gap-s", type=float, default=130.0)
    ap.add_argument("--broker", action="append", default=None,
                    help="repeatable; default greedy, uniform, "
                         "class-schedule")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("broker_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.power import ClusterTrace, simulate_cluster

    device = torch.device("cuda", 0)
    brokers = args.broker or ["greedy", "uniform", "class-schedule"]
    traces = {d: ClusterTrace.synthetic(args.jobs, seed=0,
                                        arrival_gap_s=args.arrival_gap_s,
                                        device=d)
              for d in (device, torch.device("cpu"))}

    def run(dev, broker):
        return simulate_cluster(traces[dev], broker, args.budget_mw,
                                n_nodes=10_000, kind="power")

    for broker in brokers:
        run(device, broker)                        # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rep = run(device, broker)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        ops = launches = 0
        device_us = 0.0
        kernels = []
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                dev_us = _device_us(evt)
                if dev_us > 0:
                    device_us += dev_us
                    launches += evt.count
                    kernels.append((dev_us, evt.count, evt.key[:90]))
            elif evt.key.startswith("aten::"):
                ops += evt.count
        kernels.sort(reverse=True)
        t0 = time.perf_counter()
        host = run(torch.device("cpu"), broker)
        host_s = time.perf_counter() - t0
        ticks = max(rep.n_ticks, 1)
        print(json.dumps({
            "broker": broker, "jobs": args.jobs,
            "budget_mw": args.budget_mw, "n_events": rep.n_events,
            "n_ticks": rep.n_ticks, "wall_s_profiled": wall_s,
            "aten_ops_per_tick": ops / ticks,
            "kernel_launches_per_tick": launches / ticks,
            "device_ms_per_tick": device_us * 1e-3 / ticks,
            "wall_ms_per_tick_profiled": wall_s * 1e3 / ticks,
            "device_busy_share": device_us * 1e-6 / wall_s,
            "host_tensors_wall_s": host_s,
            "same_outcome_on_host": (host.n_events, host.makespan_s)
            == (rep.n_events, rep.makespan_s),
            "top_kernels": [{"ms": d * 1e-3, "count": c, "name": n}
                            for d, c, n in kernels[:10]]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
