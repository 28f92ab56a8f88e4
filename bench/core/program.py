"""What the harness takes from the program under test, the port
(``repro_torch``), and nothing else: its configuration registry, runtime,
serving entry points and train step. The references never import this."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import serving  # noqa: F401  (the serving entry points)
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import init_opt_state

from bench.core import weights

_FIELDS = {f.name for f in dataclasses.fields(get_config("stablelm-12b"))}


def config(model: Dict):
    """The port's ModelConfig of ``model["arch"]`` with every size the
    configuration file states."""
    cfg = get_config(model["arch"])
    return dataclasses.replace(
        cfg, **{k: v for k, v in model.items() if k in _FIELDS})


def runtime(model: Dict) -> Runtime:
    """The port's runtime on one card. A MoE configuration states its
    expert capacity (``moe_capacity``); the port's ``local`` dispatch takes
    no factor but its own, so a run whose factor is another stops."""
    cap = model.get("moe_capacity")
    if cap is not None and cap["factor"] != moe.CAPACITY_FACTOR:
        raise RuntimeError(f"the configuration states the capacity factor "
                           f"{cap['factor']}; the port's local dispatch "
                           f"sizes {moe.CAPACITY_FACTOR}")
    return Runtime(tp=1, moe_impl=model.get("moe_impl", "local"))


def check_layout(cfg, rt, params: Dict) -> None:
    """The benchmark's tree has every leaf of the port's own, path for
    path, at its shape and dtype (the port's tree built on ``meta``)."""
    want = {p: (tuple(t.shape), t.dtype) for p, t in weights.tree_paths(
        model_mod.init_params(cfg, rt, device="meta"))}
    have = {p: (tuple(t.shape), t.dtype)
            for p, t in weights.tree_paths(params)}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the benchmark's weights are not the port's "
                           f"layout: {diff}")


def train_step(cfg, opt: Dict):
    """The port's train step and a fresh optimizer state's maker."""
    oc = OptConfig(**opt)
    step = make_train_step(cfg, Runtime(), oc)

    def state(params):
        return {"params": params,
                "opt": init_opt_state(params, oc.moment_dtype)}
    return step, state


def free_memory() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
