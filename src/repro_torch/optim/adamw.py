"""AdamW from scratch: f32 arithmetic, f32 or bf16 moments, global-norm
clipping, warmup + cosine schedule, decoupled weight decay on matrices.

Parameters, gradients and moments are trees of tensors (nested dicts and
lists, :mod:`repro_torch.tree`). The update is out of place: it returns new
trees and leaves its inputs as they were, as the reference's does. The
reference's ``opt_state_specs`` (moment shardings over a mesh) belongs to
the multi-device half of ROADMAP queue A item 6.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import torch_dtype
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves the optimizer's memory
    grad_compression: str = "none"  # none | int8 (error feedback)


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``decay_steps``; f32, on ``step``'s device."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Any, moment_dtype: str = "float32") -> Dict:
    """Zero moments ``m`` and ``v`` shaped as ``params`` (in
    ``moment_dtype``, on each leaf's device) and ``step`` 0, an int32 0-d
    tensor."""
    dt = torch_dtype(moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """The 2-norm of every leaf together, summed in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def apply_updates(params: Any, grads: Any, opt: Dict, cfg: OptConfig
                  ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step. Returns (new_params, new_opt_state, metrics) with
    metrics ``grad_norm`` and ``lr`` (0-d f32 tensors); the inputs are not
    changed."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        mdt = m.dtype
        g = g.float() * scale
        m = b1 * m.float() + (1 - b1) * g
        v = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m.to(mdt), v.to(mdt)

    out = tree_map(upd, params, grads, opt["m"], opt["v"])
    new_p, new_m, new_v = (tree_map(lambda _, o: o[i], params, out)
                           for i in range(3))
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
