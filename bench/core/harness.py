"""Runs one cell once: ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

Everything a cell is made of is found by name: the workload's entry in
``BENCHMARK.json`` names its configuration (``bench/configs/<config>.json``,
whose ``layout`` and ``reference`` name its weight layout and its plain
reference) and its traffic (``bench/traffic/<traffic>.json``, whose
``kind`` names the driver ``bench/drivers/<kind>.py``); the cell's check
sizes and limits are ``bench/cells/<workload>.json``; each per-layer metric
is read by ``bench/metrics/<metric>.py``. A later cell, configuration,
family, mix, kind of traffic or metric is new files and entries, and no
edit here.

The last line on standard output is the result; the last lines on standard
error are each number the check compared beside its limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload and the files it names."""

    def __init__(self, bench: Dict, workload: str, root: Path = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"there are {sorted(by_name)}")
        self.bench, self.root = bench, root
        self.w = by_name[workload]
        self.name = workload
        cfg = {c["name"]: c for c in bench["configs"]}[self.w["config"]]
        self.config = load_json(root / cfg["file"])
        self.model = self.config["model"]
        self.traffic = load_json(root / "bench" / "traffic"
                                 / f"{self.w['traffic']}.json")
        self.cell = load_json(root / "bench" / "cells" / f"{workload}.json")
        self.reference_path = root / self.config["reference"]
        self.layout_path = root / self.config["layout"]
        self.driver_path = (root / "bench" / "drivers"
                            / f"{self.traffic['kind']}.py")

    def reference(self):
        return load_module(self.reference_path, "bench_reference")

    def driver(self):
        """The module that runs this cell's kind of traffic: its
        ``run(cell, seed, seconds, trace, device, control)``."""
        return load_module(self.driver_path,
                           "bench_driver_" + self.traffic["kind"])

    def weights(self, seed: int, device):
        """The configuration's weights under ``seed`` (drawn on demand)."""
        from bench.core.weights import Weights
        leaves = load_module(self.layout_path, "bench_layout").layout(
            self.model)
        return Weights(leaves, self.model["dtype"], seed, device)

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def read_per_layer(cell: Cell, records: Dict) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer():
        mod = load_module(cell.root / "bench" / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(records)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def check_limits(numbers: Dict[str, float], limits: Dict[str, Dict]
                 ) -> Dict[str, Dict]:
    """Each compared number beside its limit; a limit not yet set fails."""
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]}
            for k in limits}


def is_correct(checks: Dict[str, Dict]) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=30
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> Dict:
    """One run of ``cell`` on ``device`` by its driver: set-up, window,
    check. Returns the end-to-end numbers (``e2e``), what the per-layer
    readers take (``records``), the check's ``numbers`` and ``checks``, the
    requests or steps ``attempted`` and the ``peak`` memory before the
    check. ``control`` also reads the fp8 control beside the program."""
    out = cell.driver().run(cell, seed, seconds, trace, device, control)
    setup_s = out["t0"] - t_start
    out["e2e"]["setup_s"] = setup_s
    out["numbers"]["setup_s"] = setup_s
    out["checks"] = check_limits(out["numbers"], cell.cell["limits"])
    return out


def result_line(cell: Cell, out: Dict, trace: bool, device) -> Dict:
    import torch
    if trace:
        metrics = read_per_layer(cell, out["records"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.w["chips"], "memory_peak_bytes": int(out["peak"]),
           "power_limit": power_limit() if device.type == "cuda" else None}
    line = {"correct": is_correct(out["checks"]),
            "attempted": out["attempted"],
            "failed": sum(1 for c in out["checks"].values()
                          if c["limit"] is None or c["value"] > c["limit"]),
            "metrics": metrics, "device": dev}
    tr = out["records"].get("trace")
    if trace and tr is not None:
        from bench.core import trace as trace_mod
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = trace_mod.breakdown(tr)
    line["numbers"] = {k: v for k, v in out["numbers"].items()
                       if k not in out["checks"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the fp8 control (measurement only)")
    args = ap.parse_args(argv)
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.w["chips"]:
        print(f"bench: {args.workload} needs {cell.w['chips']} CUDA "
              f"device(s); found {n}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_start, bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), device)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
