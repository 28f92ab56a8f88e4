"""On the card, at each cell's own size: the control (the reference put in
the program's place in the next precision below the configuration's, fp8
for bf16) fails at least one of the cell's compared numbers, while the
program's own run, on the same seed, passes them all; and a training step
on half of its batch fails them. ``-rP`` shows each run's numbers."""
import json
import time
from pathlib import Path

import pytest

from bench.core import harness
from bench.tests import faults

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 4099, 3_000_000_061, 4_000_000_133)


def control_key(name: str) -> str:
    return "control_" + name.removeprefix("served_")


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      BENCH["workloads"]])
def test_control_fails_where_the_program_passes(workload, seed,
                                                cuda_device):
    cell = harness.Cell(BENCH, workload)
    out = harness.run_cell(cell, seed, 10.0, False, cuda_device,
                           time.perf_counter(), control=True)
    n, limits = out["numbers"], cell.cell["limits"]
    print(json.dumps({"workload": workload, "seed": seed,
                      "checks": out["checks"],
                      "control": {k: n[control_key(k)] for k in limits}}))
    assert harness.is_correct(out["checks"]), out["checks"]
    failed = [k for k in limits if n[control_key(k)] > limits[k]["limit"]]
    assert failed, {k: (n[control_key(k)], limits[k]["limit"])
                    for k in limits}


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_half_batch_fails_the_training_cell(seed, cuda_device, monkeypatch):
    cell = harness.Cell(BENCH, "stablelm-12b.train-4k")
    faults.train_half_batch(monkeypatch)
    out = harness.run_cell(cell, seed, 10.0, False, cuda_device,
                           time.perf_counter())
    print(json.dumps({"seed": seed, "checks": out["checks"]}))
    assert not harness.is_correct(out["checks"]), out["checks"]
