"""Step builders: train, prefill and decode, each one function on the
port's parameters and tensors.

The reference also builds abstract input specs here (``abstract_params``,
``batch_specs``, ``abstract_state``, ``abstract_decode_state``,
``input_specs``, ``rules_for_shape``) for its multi-pod dry run; they
belong to ``launch/dryrun.py`` and the multi-device half of ROADMAP queue A
item 6.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as decode_mod
from repro_torch.models import model as model_mod
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig, apply_updates
from repro_torch.optim.compression import compress_grads
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_train_step(cfg: ModelConfig, rt: Runtime,
                    opt_cfg: OptConfig) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: ``loss_fn``,
    its gradient with respect to ``state["params"]``, the int8 error-
    feedback compression where ``opt_cfg.grad_compression`` says so (state
    key ``grad_error``), then AdamW. ``state`` is ``{"params", "opt"}``
    (plus ``grad_error``), ``batch`` a dict of tensors on the parameters'
    device; the metrics are detached 0-d tensors, the loss's and the
    optimizer's. The parameters need not require grad: the step takes its
    gradient through detached copies that do."""
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        loss, metrics = model_mod.loss_fn(cfg, rt, params, batch)
        leaves = tree_leaves(params)
        grads = tree_unflatten(params, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
        del params, leaves, loss
        extra = {}
        if opt_cfg.grad_compression == "int8":
            grads, extra["grad_error"] = compress_grads(
                grads, state["grad_error"])
        new_params, new_opt, om = apply_updates(
            state["params"], grads, state["opt"], opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return ({"params": new_params, "opt": new_opt, **extra},
                {**metrics, **om})

    return train_step


def make_prefill_step(cfg: ModelConfig, rt: Runtime,
                      max_len: int) -> Callable:
    """``prefill_step(params, batch) -> (logits, decode_state)``."""
    def prefill_step(params: Dict, batch: Dict):
        return decode_mod.prefill(cfg, rt, params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, rt: Runtime) -> Callable:
    """``serve_step(params, token, pos, state) -> (logits, state)``."""
    def serve_step(params: Dict, token: torch.Tensor, pos: torch.Tensor,
                   state: Dict):
        return decode_mod.decode_step(cfg, rt, params, token, pos, state)

    return serve_step
