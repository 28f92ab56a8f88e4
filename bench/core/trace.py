"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the result line take: the device's busy seconds (the
union of every operation's interval on the card), device seconds by
operation name, device seconds launched under each of the benchmark's own
``record_function`` ranges (``bench.*``), and the idle gaps on the card by
the range the host was in when each began. The by-name sums follow
``tools/serve_profile.py``'s arithmetic (self device time of each device
event), copied here."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

RANGE_PREFIX = "bench."
WINDOW_RANGE = "bench.window"
#: where the host was when no benchmark range was open: the program's own
#: loop between the calls the benchmark makes into it
OUTSIDE = "program.loop"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _total_device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(prof) -> Dict:
    """The trace's numbers, in seconds. ``window`` is the span of the
    ``bench.window`` range (the host's clock over the traced ticks or
    steps)."""
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    ranges: Dict[str, float] = defaultdict(float)
    window: Optional[Tuple[float, float]] = None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range also shows on the device's timeline
            if not e.name.startswith(RANGE_PREFIX):
                dev.append((tr.start, tr.end, e.name))
        elif e.name == WINDOW_RANGE:
            window = (tr.start, tr.end)
        elif e.name.startswith(RANGE_PREFIX):
            host.append((tr.start, tr.end, e.name))
            ranges[e.name] += _total_device_us(e) * 1e-6
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window
    by_name: Dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith(RANGE_PREFIX)):
            by_name[evt.key] += _device_us(evt) * 1e-6
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, _ in dev
                   if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    starts = [h[0] for h in host]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # the benchmark's ranges follow one another and never nest
        i = bisect.bisect_right(starts, a) - 1
        name = host[i][2] if i >= 0 and a < host[i][1] else OUTSIDE
        gaps[name] += (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_by_name": dict(by_name), "range_device_s": dict(ranges),
            "idle_by_range": dict(gaps)}


def breakdown(red: Dict, top: int = 10) -> Dict:
    ops = sorted(red["device_by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_by_range"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
