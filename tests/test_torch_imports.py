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


#: the multi-device half of ROADMAP queue A item 6
MULTI_DEVICE = "item 6: the multi-device half"

#: public names of a ported reference module that its counterpart does not
#: have yet, each with the ROADMAP queue A item that brings it
STILL_MISSING = {
    "repro.power": dict.fromkeys(("GovernorConfig", "PowerGovernor"),
                                 "item 7: the legacy governor shims"),
    "repro.power.chip": {},
    "repro.power.jobs": {},
    "repro.power.fleet": {},
    "repro.power.scenarios": {},
    "repro.power.stream": {},
    "repro.power.broker": {},
    "repro.core.telemetry": {},
    "repro.optim.adamw": {"opt_state_specs": MULTI_DEVICE},
    "repro.optim.compression": {},
    "repro.data.synthetic": {},
    "repro.checkpoint.checkpointer": {},
    "repro.launch.steps": dict.fromkeys(
        ("abstract_params", "batch_specs", "abstract_state",
         "abstract_decode_state", "input_specs", "rules_for_shape"),
        MULTI_DEVICE),
    "repro.launch.train": {},
    "repro.models.model": {"param_specs": MULTI_DEVICE},
}


def _public(mod):
    import inspect
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and not inspect.ismodule(v)
                 and getattr(v, "__module__", mod.__name__) == mod.__name__]
    return set(names)


@pytest.mark.parametrize("ref_name", sorted(STILL_MISSING))
def test_public_names_of_ported_modules_resolve(ref_name):
    """Every public name of a ported reference module resolves in its
    counterpart, except the listed ones still to come; so do the methods
    of the counterpart's classes that the reference has."""
    import importlib
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(ref_name.replace("repro", "repro_torch",
                                                    1))
    missing = sorted(n for n in _public(ref) if not hasattr(port, n))
    assert missing == sorted(STILL_MISSING[ref_name])
    for n in sorted(_public(ref) - set(STILL_MISSING[ref_name])):
        r, p = getattr(ref, n), getattr(port, n)
        if isinstance(r, type) and isinstance(p, type):
            lost = {a for a in vars(r) if not a.startswith("_")} \
                - set(dir(p))
            assert not lost, (n, sorted(lost))
