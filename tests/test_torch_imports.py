"""The port stands alone: a fresh interpreter imports every module of
``repro_torch`` and ``chip_smoke`` and ends with neither ``jax`` nor the
reference package ``repro`` loaded."""
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("MODULES", len(names))
print("BAD", bad)
"""


def test_fresh_interpreter_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT])
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 20
    assert lines["BAD"] == "[]"


def _sources():
    import repro_torch
    pkg = os.path.dirname(repro_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_line_imports_jax_or_the_reference():
    offenders = []
    for path in _sources():
        for i, line in enumerate(open(path), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and any(
                    tok in s.split()[1].split(".")[:1]
                    for tok in ("jax", "jaxlib", "repro")):
                offenders.append(f"{path}:{i}: {s}")
    assert offenders == []


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


SERVING_SLICE = (
    "repro_torch.configs.base", "repro_torch.configs.qwen2_5_14b",
    "repro_torch.configs.dbrx_132b", "repro_torch.configs.deepseek_v3_671b",
    "repro_torch.core.roofline", "repro_torch.core.telemetry",
    "repro_torch.core.governor", "repro_torch.kernels.flash_attention",
    "repro_torch.models", "repro_torch.models.common",
    "repro_torch.models.attention", "repro_torch.models.moe",
    "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.models.decode",
    "repro_torch.power.policies", "repro_torch.power.session",
    "repro_torch.serving", "repro_torch.serving.engine",
    "repro_torch.serving.scheduler", "repro_torch.launch.serve",
    "repro_torch.tuning.space", "repro_torch.convert")


def test_serving_slice_modules_import_no_jax_and_no_reference():
    """The modules of the serving path, one after the other in a fresh
    interpreter, each checked right after its own import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {SERVING_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines] == list(SERVING_SLICE)
    assert all(l.endswith(" []") for l in lines), lines


JOB_SLICE = (
    "repro_torch.core.telemetry", "repro_torch.power.chip",
    "repro_torch.power.jobs", "repro_torch.power.fleet",
    "repro_torch.power.scenarios", "repro_torch.power.stream",
    "repro_torch.power.broker", "repro_torch.power",
    "repro_torch.core.projection", "repro_torch.convert")


def test_job_slice_modules_import_no_jax_and_no_reference():
    """The modules of the job, scenario, stream and broker layer, one after
    the other in a fresh interpreter, each checked right after its own
    import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {JOB_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines] == list(JOB_SLICE)
    assert all(l.endswith(" []") for l in lines), lines


TRAIN_SLICE = (
    "repro_torch.optim", "repro_torch.optim.compression", "repro_torch.data",
    "repro_torch.checkpoint", "repro_torch.launch.steps",
    "repro_torch.launch.train")


def test_train_slice_modules_import_no_jax_and_no_reference():
    """The modules of the training path, one after the other in a fresh
    interpreter, each checked right after its own import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {TRAIN_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines] == list(TRAIN_SLICE)
    assert all(l.endswith(" []") for l in lines), lines


PARALLEL_SLICE = ("repro_torch.parallel", "repro_torch.parallel.executor")


def test_parallel_modules_import_no_jax_and_no_reference():
    """The sharded executor's package, first thing in a fresh interpreter,
    checked right after each import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {PARALLEL_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n"
             "from repro_torch.parallel import ShardedExecutor\n"
             "print('EXECUTOR', ShardedExecutor(devices=['cpu']))\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines[:-1]] == list(PARALLEL_SLICE)
    assert all(l.endswith(" []") for l in lines[:-1]), lines
    assert lines[-1] == ("EXECUTOR ShardedExecutor(ndev=1, chunk=65536, "
                         "dedup='auto', isa='AVX')")


MULTI_DEVICE_SLICE = (
    "repro_torch.parallel.collectives", "repro_torch.parallel.sharding",
    "repro_torch.parallel", "repro_torch.launch.mesh",
    "repro_torch.models.common", "repro_torch.models.moe",
    "repro_torch.launch.steps", "repro_torch.checkpoint.checkpointer",
    "repro_torch.launch.elastic")


def test_multi_device_modules_import_no_jax_and_no_reference():
    """The multi-device modules (collectives, specs, meshes, the sharded
    steps, the checkpointer, elastic restore), one after the other in a
    fresh interpreter, each checked right after its own import; then a
    spec bound to an abstract mesh."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {MULTI_DEVICE_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n"
             "from repro_torch.launch.mesh import AbstractMesh\n"
             "from repro_torch.parallel import P, NamedSharding\n"
             "ns = NamedSharding(AbstractMesh((2, 4), ('data', 'model')),\n"
             "                   P(None, 'model'))\n"
             "print('LOCAL', ns.local_shape((6, 8)))\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines[:-1]] == list(MULTI_DEVICE_SLICE)
    assert all(l.endswith(" []") for l in lines[:-1]), lines
    assert lines[-1] == "LOCAL (6, 2)"


DRYRUN_SLICE = ("repro_torch.core.hlo_cost", "repro_torch.core.roofline",
                "repro_torch.core.governor", "repro_torch.launch.dryrun")


def test_dry_run_modules_import_no_jax_and_no_reference():
    """The cost counter, the roofline, the governor shims and the dry run,
    one after the other in a fresh interpreter, each checked right after
    its own import; importing the dry run starts no process group."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    probe = ("import importlib, sys\n"
             f"for m in {DRYRUN_SLICE!r}:\n"
             "    importlib.import_module(m)\n"
             "    bad = sorted(n for n in sys.modules if n.split('.')[0]\n"
             "                 in ('jax', 'jaxlib', 'repro'))\n"
             "    print(m, bad)\n"
             "import torch.distributed as dist\n"
             "print('PROCESS_GROUP', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines[:-1]] == list(DRYRUN_SLICE)
    assert all(l.endswith(" []") for l in lines[:-1]), lines
    assert lines[-1] == "PROCESS_GROUP False"


def _reference_modules():
    """Every module of the reference package, from its files: the port has
    a counterpart of each (``repro.x.y`` -> ``repro_torch.x.y``)."""
    from pathlib import Path
    root = Path(ROOT, "src")
    names = []
    for path in sorted((root / "repro").rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


#: every module of the reference package
REFERENCE_MODULES = _reference_modules()

#: public names of each reference module that its counterpart does not
#: have yet, each with the ROADMAP queue A item that brings it: none, the
#: port has them all
STILL_MISSING = {name: {} for name in REFERENCE_MODULES}


#: public names of a ported reference module that have no counterpart by
#: design, each with its reason (``STILL_MISSING`` is what is still to come)
_UNREAD_FIELD = "a field the reference declares and never reads"
NOT_APPLICABLE = {
    "repro.core.hlo_cost": dict.fromkeys(
        ("Instr", "HloCostModel", "analyze_hlo"),
        "no HLO in the port: repro_torch.core.hlo_cost counts dispatched "
        "ops (CostCounter, analyze_step)"),
    "repro.tuning.space": {
        "MXU": "the TPU's 128-wide matrix unit, which the reference's "
               "flash space aligns blocks to; the card's tiles are "
               "flash_attention.tile_options and unsupported",
        "SUBLANE_F32": "the TPU's f32 sublane tile, which the reference's "
                       "membw space aligns chunks to; the port's spaces "
                       "prune by the thread-block step instead"},
    "repro.tuning.calibrate": {
        "CHIPS": "an import the reference's module never reads; the table "
                 "is repro_torch.core.hardware.CHIPS"},
    "repro.models.transformer": {
        "StackedMaker": "a ParamMaker view for layers stacked on a leading "
                        "axis, which jax.lax.scan walks; the port keeps a "
                        "list of per-layer parameters and loops over it",
        "Runtime.max_decode_len": _UNREAD_FIELD},
    "repro.models": {"Runtime.max_decode_len": _UNREAD_FIELD},
}

#: reference modules whose import changes the process (the dry run sets
#: XLA_FLAGS for 512 host devices): their names are read in a subprocess
_IMPORT_ELSEWHERE = ("repro.launch.dryrun",)


def _public(mod):
    """A module's ``__all__``, or its own public names; a package without
    ``__all__`` also names the classes and functions it re-exports from
    its own modules."""
    import inspect
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and not inspect.ismodule(v)
                 and (getattr(v, "__module__", mod.__name__) == mod.__name__
                      or (hasattr(mod, "__path__")
                          and (inspect.isclass(v) or inspect.isfunction(v))
                          and v.__module__.startswith(mod.__name__ + ".")))]
    return set(names)


def _public_in_subprocess(ref_name):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    probe = ("import importlib, json, test_torch_imports as t\n"
             f"print(json.dumps(sorted(t._public(importlib.import_module("
             f"{ref_name!r})))))\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ref_name", REFERENCE_MODULES)
def test_public_names_of_ported_modules_resolve(ref_name):
    """Every public name of every reference module resolves in its
    counterpart, except those NOT_APPLICABLE names with their reasons (and
    any still to come); so do the methods and fields of the counterpart's
    classes that the reference has (``"Class.attr"`` in NOT_APPLICABLE
    for one that does not apply)."""
    import importlib
    port = importlib.import_module(ref_name.replace("repro", "repro_torch",
                                                    1))
    absent = {n for n in set(STILL_MISSING[ref_name])
              | set(NOT_APPLICABLE.get(ref_name, {})) if "." not in n}
    absent_attrs = {n for n in NOT_APPLICABLE.get(ref_name, {}) if "." in n}
    if ref_name in _IMPORT_ELSEWHERE:
        names = _public_in_subprocess(ref_name)
        assert sorted(n for n in names if not hasattr(port, n)) == sorted(
            absent)
        return
    ref = importlib.import_module(ref_name)
    missing = sorted(n for n in _public(ref) if not hasattr(port, n))
    assert missing == sorted(absent)
    for n in sorted(_public(ref) - absent):
        r, p = getattr(ref, n), getattr(port, n)
        if isinstance(r, type) and isinstance(p, type):
            lost = {a for a in vars(r) if not a.startswith("_")
                    and f"{n}.{a}" not in absent_attrs} - set(dir(p))
            assert not lost, (n, sorted(lost))
    for na in sorted(absent_attrs):
        cls, attr = na.split(".")
        assert hasattr(getattr(ref, cls), attr)
        assert not hasattr(getattr(port, cls), attr)
