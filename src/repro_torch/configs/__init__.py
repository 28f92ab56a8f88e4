"""Architecture registry: ``get_config(arch_id)`` + shape tables, and the
paper's VAI benchmark suite.

The model configurations are pure data, copied from the reference package
(same names, same fields, same ``reduced()``), so that both packages build
the same model from one arch id. The port serves the ``dense`` family; the
model code raises ``NotImplementedError`` for the others."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    SUBQUADRATIC_FAMILIES,
    applicable_shapes,
)
from repro_torch.configs.paper_vai import CONFIG, VAISuiteConfig  # noqa: F401

# arch-id -> module name
_REGISTRY: Dict[str, str] = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "dbrx-132b": "dbrx_132b",
    "stablelm-12b": "stablelm_12b",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen1.5-32b": "qwen1_5_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "mamba2-2.7b": "mamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "paper-vai": "paper_vai",
}

ARCH_IDS = tuple(k for k in _REGISTRY if k != "paper-vai")


def get_config(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
