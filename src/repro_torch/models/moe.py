"""Mixture-of-Experts on one card: token-choice top-k routing, the
sort-scatter dispatch into per-expert capacity buffers, and the dense
oracle.

Two dispatch paths, as the reference's single-device ones:

* ``dense`` — every expert applied to every token, mask-weighted. O(E/k)
  flop waste; the numerical *oracle* for tiny configs and tests.
* ``local`` — the tokens' (token, expert) pairs are sorted by expert
  (stable), each pair takes the next position of its expert's capacity
  buffer, the experts run as one batched product per weight over
  ``[E, C, d]``, and the outputs are gathered back and combined with the
  router weights. Pairs past an expert's capacity are dropped and
  contribute exactly zero.

The reference's expert-parallel paths (``ep_a2a``, ``ep_gather``: an
``all_to_all`` / ``all_gather`` over a mesh axis inside ``shard_map``) are
the multi-device half of this module, ROADMAP queue A item 6.

The local path keeps its writes free of host synchronisation: a dropped
pair is written to one spare row past the capacity (``[E, C + 1, d]``),
which the experts never read, where the reference drops the write
(``mode="drop"``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamMaker, gated_mlp, gated_mlp_params

CAPACITY_FACTOR = 1.25


def moe_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
               tp: int = 1) -> Dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": mk(f"{prefix}.router", (d, E), scale=0.02),
        "experts": {
            "wi": mk(f"{prefix}.e_wi", (E, d, ff)),
            "wg": mk(f"{prefix}.e_wg", (E, d, ff)),
            "wo": mk(f"{prefix}.e_wo", (E, ff, d)),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = gated_mlp_params(
            mk, f"{prefix}.shared", d, ff * cfg.n_shared_experts)
    return p


def _route(router_w: torch.Tensor, x: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing. Returns (weights [T,k], idx [T,k],
    aux_loss scalar). Router math in f32.

    ``jax.lax.top_k`` takes the lower index first among equal values;
    ``torch.topk`` promises no order there, so the top k are the first k of
    a stable descending sort."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :k], order[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # switch-style load balance loss: E * sum_e f_e * p_e
    E = probs.shape[-1]
    hard = torch.zeros_like(probs).scatter_(1, idx, 1.0)
    f = hard.mean(dim=0)
    pbar = probs.mean(dim=0)
    aux = E * torch.sum(f * pbar)
    return w.to(x.dtype), idx.to(torch.int32), aux


def _expert_ffn(experts: Dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """xs: [E_loc, C, d] -> [E_loc, C, d], one batched product per
    weight."""
    a = torch.bmm(xs, experts["wi"])
    g = torch.bmm(xs, experts["wg"])
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.bmm(a * g, experts["wo"])


def _dispatch_indices(idx: torch.Tensor):
    """Sort (token, expert) pairs by expert; compute within-expert positions.
    Returns (order [T*k], sorted_e, pos_in_expert) — pairs whose position
    exceeds capacity are dropped by the scatter."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = (torch.arange(sorted_e.shape[0], dtype=torch.int32,
                        device=idx.device) - first.to(torch.int32))
    return order, sorted_e, pos


def _local_moe(x: torch.Tensor, router_w: torch.Tensor, experts: Dict,
               cfg: ModelConfig, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE via sort-scatter dispatch (no collectives).
    x: [T, d]."""
    T, d = x.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    w, idx, aux = _route(router_w, x, k)
    order, sorted_e, pos = _dispatch_indices(idx)
    tok = order // k
    e, kept = sorted_e.long(), pos < capacity
    # row `capacity` of each expert takes the dropped pairs and is never read
    slot = torch.clamp(pos, max=capacity).long()
    buf = torch.zeros((E, capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[e, slot] = x[tok]
    out_buf = _expert_ffn(experts, buf[:, :capacity], cfg.act)
    y_sorted = out_buf[e, torch.clamp(slot, max=capacity - 1)]
    # pairs that exceeded capacity must contribute zero, not a wrong slot
    y_sorted = torch.where(kept[:, None], y_sorted, 0.0)
    y_pairs = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    y_pairs[order] = y_sorted
    y = torch.sum(y_pairs.reshape(T, k, d) * w[..., None], dim=1)
    return y, aux


def moe_block_dense(p: Dict, cfg: ModelConfig, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert on every token (tests / tiny configs only)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    w, idx, aux = _route(p["router"], xt, cfg.experts_per_token)
    dense_w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=x.dtype,
                          device=x.device)
    dense_w.scatter_add_(1, idx.long(), w)
    ys = _expert_ffn(p["experts"], xt[None].expand(
        (cfg.n_experts,) + tuple(xt.shape)), cfg.act)      # [E, T, d]
    y = torch.einsum("etd,te->td", ys, dense_w)
    if cfg.n_shared_experts:
        y = y + gated_mlp(p["shared"], xt, cfg.act)
    return y.reshape(B, S, d), aux


def _capacity(tokens: int, cfg: ModelConfig,
              factor: Optional[float] = None) -> int:
    c = int(tokens * cfg.experts_per_token / max(cfg.n_experts, 1)
            * (factor if factor is not None else CAPACITY_FACTOR))
    return max(8, ((c + 7) // 8) * 8)


def moe_block_local(p: Dict, cfg: ModelConfig, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-scatter MoE without expert parallelism (single device)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    y, aux = _local_moe(xt, p["router"], p["experts"], cfg,
                        _capacity(B * S, cfg))
    if cfg.n_shared_experts:
        y = y + gated_mlp(p["shared"], xt, cfg.act)
    return y.reshape(B, S, d), aux


def moe_block(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "local", mesh=None,
              batch_axes: Tuple[str, ...] = ("data",),
              decode: bool = False,
              dispatch_dtype: str = "bfloat16",
              capacity_factor: float = 1.25,
              ep2d: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``impl`` ``"dense"`` (the oracle) or ``"local"``. As in the
    reference, the local path sizes its buffers with the module's
    :data:`CAPACITY_FACTOR`; ``capacity_factor`` and the mesh arguments
    belong to the expert-parallel path."""
    if impl == "dense":
        return moe_block_dense(p, cfg, x)
    if impl == "local":
        return moe_block_local(p, cfg, x)
    if impl == "ep":
        raise NotImplementedError(
            "expert-parallel MoE (impl='ep': all_to_all / all_gather over a "
            "device mesh) is ROADMAP queue A item 6, the multi-device half "
            "of models/moe.py; one card serves with impl='local'")
    raise ValueError(impl)
