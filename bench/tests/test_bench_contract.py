"""BENCHMARK.json and the files it names; what the harness imports."""
import ast
import json
from pathlib import Path

import pytest

from bench.core import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_by_name(workload):
    cell = harness.Cell(BENCH, workload)
    for path in (cell.reference_path, cell.layout_path, cell.driver_path):
        assert path.is_file(), path
    assert callable(cell.driver().run)
    assert cell.cell["limits"], "a cell compares at least one number"
    for m in cell.per_layer():
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer(), "every cell reports a per-layer metric"
    assert {m["moves"] for m in cell.per_layer()} <= e2e


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(cfg):
    f = json.loads((ROOT / cfg["file"]).read_text())
    assert f["source"] == cfg["source"]
    assert sorted(f["reduced"]) == sorted(cfg["reduced"])
    for key, cut in f["reduced"].items():
        have = f["model"].get(key, f.get(key))
        assert have == cut["to"] and f["published"][key] == cut["from"]


def test_per_layer_metrics_name_their_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", WORKLOADS)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "refs").glob(
    "*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "torch"}, tops


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType(
        "repro.core"))
    assert "repro" in harness.forbidden_modules()
