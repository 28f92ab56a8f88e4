"""The plain references against the port's CPU path at the reduced sizes
in float32, and whole runs on the CPU with the timed path broken
underneath: each fault a cell can have turns ``correct`` false under the
cell's own limits, and the same run without it stays correct."""
import json
import time
from pathlib import Path

import pytest
import torch

from bench.core import harness
from bench.tests import faults

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 977
CPU = torch.device("cpu")


def reduced_cell(workload: str) -> harness.Cell:
    """The cell at its configuration's ``reduced()`` sizes, float32, with
    a traffic cut to match; its check and limits as committed."""
    from bench.core import program
    cell = harness.Cell(BENCH, workload)
    r = program.config(cell.model).reduced()
    cell.model = dict(cell.model, dtype="float32",
                      **{k: getattr(r, k) for k in cell.model
                         if k not in ("arch", "dtype") and hasattr(r, k)})
    if cell.traffic["kind"] == "train":
        cell.traffic = dict(cell.traffic, seq_len=32)
    else:
        cell.traffic = dict(
            cell.traffic, clients=4, max_len=64, n_requests=256, block=16,
            prompt_len=dict(dist="lognormal", median=16, sigma=0.8, min=4,
                            max=40),
            output_len=dict(dist="lognormal", median=8, sigma=0.8, min=4,
                            max=20), ramp_ticks=4, trace_ticks=6)
        cell.cell = dict(cell.cell, check={"min_tokens": 40,
                                           "max_requests": 8})
    return cell


def run(cell, seconds=1.0, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, CPU,
                            time.perf_counter())


def test_serving_reference_matches_the_port():
    out = run(reduced_cell("dbrx-132b.chat"))
    n = out["numbers"]
    assert n["tokens"] >= 40
    assert n["served_gap_max"] < 1e-4 and n["served_miss"] == 0.0


def test_training_reference_matches_the_port():
    n = run(reduced_cell("stablelm-12b.train-4k"))["numbers"]
    for k in ("loss", "grad1_norm", "grad1_leaf", "change_leaf"):
        assert n[k] < 1e-5, (k, n[k])


@pytest.mark.parametrize("tokens", [1, 16, 31, 32, 64, 100, 256, 1024,
                                    2048, 2560])
def test_stated_capacity_is_the_ports(tokens):
    from bench.core import program
    from bench.refs import decoder
    from repro_torch.models import moe
    m = harness.Cell(BENCH, "dbrx-132b.chat").model
    assert decoder.capacity(m, tokens) == moe._capacity(
        tokens, program.config(m))


@pytest.mark.parametrize("rows,page", [(28, 32), (32, 32), (56, 64)])
def test_reference_drops_the_pairs_the_port_drops(rows, page):
    """A prompt's prefill with a router that sends most rows to one
    expert: the reference's capacity (the group of the prompt's rows at
    its page) gives the port's ``local`` output row for row, where the
    dropless reference does not."""
    from bench.core import program
    from bench.refs import decoder
    from repro_torch.models import moe
    m = reduced_cell("dbrx-132b.chat").model
    d, E, ff = m["d_model"], m["n_experts"], m["d_ff"]
    g = torch.Generator().manual_seed(rows)
    u = torch.randn(d, generator=g)
    x = torch.randn(page, d, generator=g) + 2.0 * u
    router = torch.randn(d, E, generator=g) * d ** -0.5
    router[:, 0] += u / u.norm()
    experts = {"wi": torch.randn(E, d, ff, generator=g) * d ** -0.5,
               "wg": torch.randn(E, d, ff, generator=g) * d ** -0.5,
               "wo": torch.randn(E, ff, d, generator=g) * ff ** -0.5}
    port = moe.moe_block_local({"router": router, "experts": experts},
                               program.config(m), x[None])[0][0, :rows]
    leaves = {"mlp/router": router, **{f"mlp/experts/{k}": v
                                       for k, v in experts.items()}}
    L = decoder.Layer(m, leaves, "f32")
    capped = decoder._moe(L, x[:rows], [(0, rows, decoder.capacity(
        m, page))])
    dropless = decoder._moe(L, x[:rows])
    torch.testing.assert_close(capped, port, rtol=1e-5, atol=1e-5)
    assert (dropless - port).abs().amax() > 1e-2


def test_traced_run_reads_its_per_layer_metrics():
    cell = reduced_cell("dbrx-132b.chat")
    out = run(cell, trace=True)
    line = harness.result_line(cell, out, True, CPU)
    assert {"slot_occupancy.serve", "decode_step_ms.serve",
            "mfu.serve"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
    assert line["device"]["window_s"] > 0


# --------------------------------------------------------------- faults
FAULTS = {"dbrx-132b.chat": faults.SERVE,
          "stablelm-12b.train-4k": faults.TRAIN}
CASES = [(w, f) for w in FAULTS for f in [None, *FAULTS[w]]]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f or 'sound'}" for w, f in CASES])
def test_a_fault_in_the_timed_path_turns_correct_false(workload, fault,
                                                       monkeypatch):
    cell = reduced_cell(workload)
    assert all(v["limit"] is not None for v in cell.cell["limits"].values())
    if fault is not None:
        FAULTS[workload][fault](monkeypatch)
    out = run(cell)
    assert harness.is_correct(out["checks"]) == (fault is None), out[
        "checks"]
