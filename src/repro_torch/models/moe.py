"""Mixture-of-Experts: token-choice top-k routing, the sort-scatter
dispatch into per-expert capacity buffers, the dense oracle, and expert
parallelism over a device mesh.

Three dispatch paths, as the reference's:

* ``dense`` — every expert applied to every token, mask-weighted. O(E/k)
  flop waste; the numerical *oracle* for tiny configs and tests.
* ``local`` — the tokens' (token, expert) pairs are sorted by expert
  (stable), each pair takes the next position of its expert's capacity
  buffer, the experts run as one batched product per weight over
  ``[E, C, d]``, and the outputs are gathered back and combined with the
  router weights. Pairs past an expert's capacity are dropped and
  contribute exactly zero.
* ``ep`` (:func:`moe_block_ep`) — the experts split over the mesh's
  ``model`` axis, ``E / tp`` on each rank. Train and prefill
  (``_ep_a2a``): the sequence is split over ``model`` before dispatch,
  each rank sort-scatters its own tokens into ``[E, C, d]`` (``C`` from
  its own token count), an ``all_to_all`` over ``model`` sends each
  expert block to its rank (``dispatch_dtype="f8"``: the bytes on the wire
  in ``float8_e4m3fn``), the local experts run over every peer's slots,
  and the inverse ``all_to_all`` and the weighted combine bring the
  outputs home, gathered back along the sequence. Decode (``_ep_gather``):
  every rank routes all of its tokens and keeps only the pairs routed to
  its own experts (the rest go to a drop bucket), and the partial outputs
  are summed over ``model``; with ``ep2d`` the experts' ffn dim is split
  over the data axes too, the tokens are gathered over them, the partial
  sums run over both, and each rank keeps its own rows.

The load-balancing aux loss is computed from the router's statistics over
every token of the step: where the tokens are split over ranks (the data
axes, and ``model`` inside ``_ep_a2a``), the per-expert counts and mean
probabilities are summed over those ranks before the product, so the loss
and its gradient are the single-device ones. (The reference averages each
shard's own aux loss with ``pmean``, which differs from the single-device
value by the shards' covariance of counts and probabilities.)

The dispatch keeps its writes free of host synchronisation: a dropped pair
is written to one spare row past the capacity (``[E, C + 1, d]``, and in
decode one spare expert for the pairs of other ranks), which the experts
never read, where the reference drops the write (``mode="drop"``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamMaker, axis_group, gated_mlp,
                                       gated_mlp_params)
from repro_torch.parallel import collectives as coll

CAPACITY_FACTOR = 1.25


def moe_params(mk: ParamMaker, prefix: str, cfg: ModelConfig,
               tp: int = 1) -> Dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": mk(f"{prefix}.router", (d, E), ("dmodel", None),
                     scale=0.02),
        "experts": {
            "wi": mk(f"{prefix}.e_wi", (E, d, ff),
                     ("experts", "dmodel", "expert_ff")),
            "wg": mk(f"{prefix}.e_wg", (E, d, ff),
                     ("experts", "dmodel", "expert_ff")),
            "wo": mk(f"{prefix}.e_wo", (E, ff, d),
                     ("experts", "expert_ff", "dmodel")),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = gated_mlp_params(
            mk, f"{prefix}.shared", d, ff * cfg.n_shared_experts)
    return p


def _route(router_w: torch.Tensor, x: torch.Tensor, k: int,
           model_group=None, data_group=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing. Returns (weights [T,k], idx [T,k],
    aux_loss scalar). Router math in f32.

    ``jax.lax.top_k`` takes the lower index first among equal values;
    ``torch.topk`` promises no order there, so the top k are the first k of
    a stable descending sort.

    Where the step's tokens are split over ``model_group`` and / or
    ``data_group``, the aux loss's per-expert counts and probability sums
    are summed over them first (over ``model`` the gradient comes back as
    it is, over the data axes it is summed too, as the train step averages
    it there: :mod:`repro_torch.parallel.collectives`)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :k], order[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # switch-style load balance loss: E * sum_e f_e * p_e
    E = probs.shape[-1]
    hard = torch.zeros_like(probs).scatter_(1, idx, 1.0)
    if model_group is None and data_group is None:
        f = hard.mean(dim=0)
        pbar = probs.mean(dim=0)
    else:
        # one reduction of [counts, probability sums, tokens] a group
        stats = torch.cat([hard.sum(dim=0), probs.sum(dim=0),
                           probs.new_tensor([float(probs.shape[0])])])
        stats = coll.reduce_both(coll.reduce_from(stats, model_group),
                                 data_group)
        f, pbar = stats[:E] / stats[-1], stats[E:2 * E] / stats[-1]
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


def _dispatch(xt: torch.Tensor, idx: torch.Tensor, k: int, n_exp: int,
              capacity: int, bucket: bool = False):
    """Sort-scatter the pairs ``idx [T, k]`` of ``xt [T, d]`` into
    ``[n_exp, capacity, d]``. Pairs past their expert's capacity, and with
    ``bucket`` the pairs of expert ``n_exp`` (the drop bucket), land on a
    spare row the experts never read. Returns (buffer, what
    :func:`_combine` needs)."""
    d = xt.shape[-1]
    order, sorted_e, pos = _dispatch_indices(idx)
    tok = order // k
    kept = pos < capacity
    if bucket:
        kept = kept & (sorted_e < n_exp)
    e = sorted_e.long()
    # row `capacity` of each expert takes the dropped pairs and is never read
    slot = torch.clamp(pos, max=capacity).long()
    buf = torch.zeros((n_exp + bucket, capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[e, slot] = xt[tok]
    return buf[:n_exp, :capacity], (order, e, slot, kept)


def _combine(out_buf: torch.Tensor, meta, w: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """The experts' outputs ``[n_exp, capacity, d]`` back at their pairs,
    weighted and summed over each token's k experts; a dropped pair
    contributes exactly zero."""
    order, e, slot, kept = meta
    n_exp, capacity, d = out_buf.shape
    y_sorted = out_buf[torch.clamp(e, max=n_exp - 1),
                       torch.clamp(slot, max=capacity - 1)]
    # pairs that exceeded capacity must contribute zero, not a wrong slot
    y_sorted = torch.where(kept[:, None], y_sorted, 0.0)
    y_pairs = torch.empty((T * k, d), dtype=out_buf.dtype,
                          device=out_buf.device)
    y_pairs[order] = y_sorted
    return torch.sum(y_pairs.reshape(T, k, d) * w[..., None], dim=1)


def _local_moe(x: torch.Tensor, router_w: torch.Tensor, experts: Dict,
               cfg: ModelConfig, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE via sort-scatter dispatch (no collectives; under a
    mesh the aux loss's statistics are summed over the batch's ranks).
    x: [T, d]."""
    T = x.shape[0]
    k, E = cfg.experts_per_token, cfg.n_experts
    if experts["wi"].shape[0] != E:
        raise ValueError(
            f"{experts['wi'].shape[0]} of {E} experts on this rank: the "
            f"experts are split over the mesh, which impl='ep' computes on")
    w, idx, aux = _route(router_w, x, k, data_group=axis_group("batch"))
    buf, meta = _dispatch(x, idx, k, E, capacity)
    out_buf = _expert_ffn(experts, buf, cfg.act)
    return _combine(out_buf, meta, w, T, k), aux


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


# ---------------------------------------------------------------------------
# Expert-parallel paths (the mesh's model axis; decode: also its data axes)
# ---------------------------------------------------------------------------
def _axes_in_order(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in axes)


def moe_block_ep(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, mesh,
                 batch_axes: Tuple[str, ...], model_axis: str = "model",
                 decode: bool = False, dispatch_dtype: str = "bfloat16",
                 capacity_factor: float = 1.25,
                 ep2d: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. x: [B_loc, S, d], this rank's rows of the batch
    (split over ``batch_axes``), whole over ``model``. Expert weights split
    over ``model_axis``; with ``ep2d`` (decode) the expert FFN dim is also
    split over the data axes, a weight layout that fits 100B+ MoEs for
    serving. Returns (y [B_loc, S, d], aux), both whole over ``model``."""
    E = cfg.n_experts
    tp = mesh.shape[model_axis]
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} ranks")
    ff_axes = _axes_in_order(mesh, batch_axes) if (decode and ep2d) else ()
    ff_loc = cfg.d_ff // (mesh.axis_size(ff_axes) if ff_axes else 1)
    want = (E // tp, cfg.d_model, ff_loc)
    if tuple(p["experts"]["wi"].shape) != want:
        raise ValueError(
            f"expert weights of local shape {tuple(p['experts']['wi'].shape)}"
            f"; this path ({'decode' if decode else 'train / prefill'}"
            f"{', ep2d' if ff_axes else ''}) computes on {want}")
    body = _ep_gather if decode else _ep_a2a
    y, aux = body(x, p, cfg, mesh, model_axis, batch_axes, ff_axes,
                  dispatch_dtype, capacity_factor)
    if cfg.n_shared_experts:
        y = y + gated_mlp(p["shared"], x, cfg.act)
    return y, aux


def _batch_group(mesh, batch_axes):
    axes = _axes_in_order(mesh, batch_axes)
    return mesh.group(axes) if axes and mesh.axis_size(axes) > 1 else None


def _ep_a2a(x, p, cfg, mesh, model_axis, batch_axes, ff_axes,
            dispatch_dtype, capacity_factor):
    """Per-rank body, train / prefill path: the sequence split over
    ``model``, two all-to-alls over it."""
    B, S, d = x.shape
    tp = mesh.shape[model_axis]
    mgrp = mesh.group(model_axis)
    if S % tp:
        raise ValueError(f"a sequence of {S} tokens does not split over "
                         f"{tp} ranks of {model_axis!r}")
    x_loc = coll.split_to(x, 1, mgrp)
    Sl = S // tp
    T = B * Sl
    k, E = cfg.experts_per_token, cfg.n_experts
    E_loc = E // tp
    C = _capacity(T, cfg, capacity_factor)
    xt = x_loc.reshape(T, d)
    router = coll.copy_to(p["router"], mgrp)
    w, idx, aux = _route(router, xt, k, model_group=mgrp,
                         data_group=_batch_group(mesh, batch_axes))
    buf, meta = _dispatch(xt, idx, k, E, C)
    # exchange expert shards within the model axis:
    # [E, C, d] -> [tp, E_loc, C, d] -> a2a -> [tp, E_loc, C, d] (peers')
    wire = torch.float8_e4m3fn if dispatch_dtype == "f8" else None
    buf = coll.all_to_all(buf.reshape(tp, E_loc, C, d), mgrp, wire=wire)
    buf = buf.transpose(0, 1).reshape(E_loc, tp * C, d)
    out = _expert_ffn(p["experts"], buf, cfg.act)
    out = out.reshape(E_loc, tp, C, d).transpose(0, 1)
    out = coll.all_to_all(out, mgrp).reshape(E, C, d)
    y = _combine(out, meta, w, T, k).reshape(B, Sl, d)
    return coll.gather_from(y, 1, mgrp), aux


def _ep_gather(x, p, cfg, mesh, model_axis, batch_axes, ff_axes,
               dispatch_dtype, capacity_factor):
    """Per-rank body, decode path: every rank routes all of its tokens
    (gathered over ``ff_axes`` in 2D), keeps the pairs of its own experts,
    and the partial outputs are summed over ``model`` (and ``ff_axes``)
    before this rank's rows are kept."""
    fgrp = mesh.group(ff_axes) if ff_axes else None
    if ff_axes:
        x = coll.gather_from(x, 0, fgrp)
    B, S, d = x.shape
    T = B * S
    k, E = cfg.experts_per_token, cfg.n_experts
    tp = mesh.shape[model_axis]
    E_loc = E // tp
    C = _capacity(T, cfg, capacity_factor)
    my = mesh.axis_index(model_axis)
    xt = x.reshape(T, d)
    w, idx, aux = _route(p["router"], xt, k, data_group=None if ff_axes
                         else _batch_group(mesh, batch_axes))
    # keep only pairs routed to my local experts; E_loc = drop bucket
    local = (idx >= my * E_loc) & (idx < (my + 1) * E_loc)
    idx_l = torch.where(local, idx - my * E_loc, E_loc)
    buf, meta = _dispatch(xt, idx_l, k, E_loc, C, bucket=True)
    out = _expert_ffn(p["experts"], buf, cfg.act)
    y = _combine(out, meta, w, T, k)
    # combine expert-group (model) and, in 2D, ffn-slice (data) partials
    y = coll.reduce_from(y, mesh.group(_axes_in_order(
        mesh, (model_axis,) + tuple(ff_axes))))
    y = y.reshape(B, S, d)
    if ff_axes:
        y = coll.split_to(y, 0, fgrp)
    return y, aux


def moe_block(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "local", mesh=None,
              batch_axes: Tuple[str, ...] = ("data",),
              decode: bool = False,
              dispatch_dtype: str = "bfloat16",
              capacity_factor: float = 1.25,
              ep2d: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``impl`` ``"dense"`` (the oracle), ``"local"`` or ``"ep"`` (needs
    ``mesh``). As in the reference, the local path sizes its buffers with
    the module's :data:`CAPACITY_FACTOR`; ``capacity_factor`` and the mesh
    arguments belong to the expert-parallel path."""
    if impl == "dense":
        return moe_block_dense(p, cfg, x)
    if impl == "local":
        return moe_block_local(p, cfg, x)
    if impl == "ep":
        if mesh is None:
            raise ValueError("impl='ep' splits the experts over a device "
                             "mesh: give Runtime(mesh=...) or run inside "
                             "sharding_ctx(rules, mesh)")
        return moe_block_ep(p, cfg, x, mesh=mesh, batch_axes=batch_axes,
                            decode=decode, dispatch_dtype=dispatch_dtype,
                            capacity_factor=capacity_factor, ep2d=ep2d)
    raise ValueError(impl)
