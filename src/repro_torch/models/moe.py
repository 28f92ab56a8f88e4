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

  Under a mesh ``dense`` and ``local`` keep their one-device meaning, as
  XLA keeps the reference's: the capacity is the global batch's, and a
  pair's slot is its place in the stable sort over the global batch (its
  place on this rank plus the pairs of its expert on the earlier batch
  ranks, whose counts are all-gathered). Where the experts are split over
  ``model``, each rank runs its own ``E / tp`` on every token of its rows
  and the partial outputs are summed over ``model``.
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
  sums run over both, and each rank keeps its own rows. Off decode an
  expert ffn stored split over ``data`` is gathered whole a layer at a
  time.

Under a sequence split (``seq``: training under the rule ``seq -> model``)
``dense`` and ``local`` gather the rank's rows whole before the router and
reduce-scatter the output back onto them; ``ep`` takes the rows as they
come, the very chunk it would cut, and returns its own.

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
from repro_torch.models.common import (ParamMaker, axis_group, axis_size,
                                       current_rules, enter, gated_mlp,
                                       gated_mlp_params, leave)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import entry_axes

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


def _split_experts(experts: Dict, cfg: ModelConfig):
    """(group, first, n) of the experts this rank holds: ``(None, 0, E)``
    where it holds all of them; else the group the rule ``experts`` splits
    them over, and this rank's ``n = E / tp`` from expert ``first``."""
    E, n = cfg.n_experts, experts["wi"].shape[0]
    if n == E:
        return None, 0, E
    grp = axis_group("experts")
    if coll.size(grp) * n != E:
        raise ValueError(f"{n} of {E} experts on this rank, and the "
                         f"experts' axis has {coll.size(grp)} ranks")
    return grp, coll.rank(grp) * n, n


def _earlier_counts(idx: torch.Tensor, E: int, bgrp) -> torch.Tensor:
    """``[E]`` int32: each expert's pairs on the batch ranks before this
    one (in the order the batch's rows are laid out over them), from the
    ranks' counts all-gathered over ``bgrp``."""
    flat = idx.reshape(-1).long()
    counts = torch.zeros(E, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    every = coll.all_gather(counts[None], 0, bgrp)            # [dp, E]
    return every[:coll.rank(bgrp)].sum(dim=0, dtype=torch.int32)


def _dispatch_global(xt: torch.Tensor, idx: torch.Tensor, k: int,
                     first: int, n_exp: int, capacity: int,
                     offset: torch.Tensor, rows: int):
    """:func:`_dispatch` at global slots: a pair is kept iff it is routed
    to one of experts ``first .. first + n_exp - 1`` and its place among
    its expert's pairs, counted on from ``offset`` (the earlier batch
    ranks' pairs), is below ``capacity``. A kept pair's place on this rank
    is below both ``capacity`` and the rank's token count, so
    ``[n_exp, rows, d]`` (``rows = min(capacity, T)``) holds it there; the
    other pairs land on a spare row or expert that the experts never
    read."""
    d = xt.shape[-1]
    order, sorted_e, pos = _dispatch_indices(idx)
    tok = order // k
    e = sorted_e.long() - first
    mine = (e >= 0) & (e < n_exp)
    kept = mine & (pos + offset[sorted_e.long()] < capacity)
    e = torch.where(mine, e, n_exp)
    slot = torch.where(kept, pos, rows).long()
    buf = torch.zeros((n_exp + 1, rows + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[e, slot] = xt[tok]
    return buf[:n_exp, :rows], (order, e, slot, kept)


def _local_moe(x: torch.Tensor, router_w: torch.Tensor, experts: Dict,
               cfg: ModelConfig, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE via sort-scatter dispatch. x: [T, d], this rank's tokens.

    With the batch whole and every expert on the rank (one device) no
    collective runs. Else the aux loss's statistics are summed over the
    batch's ranks, the slots are global (:func:`_earlier_counts`), and
    where the experts are split over ``model`` the tokens enter the
    experts through ``copy_to`` (their gradient summed over ``model``) and
    the router weights enter the combine the same way (each rank's
    gradient covers only its own experts' pairs). The routing runs alike
    on every model rank, and its gradient is not summed. Returns (the
    output, partial over the group the experts split over, that group,
    aux)."""
    T = x.shape[0]
    k, E = cfg.experts_per_token, cfg.n_experts
    bgrp = axis_group("batch")
    mgrp, first, n = _split_experts(experts, cfg)
    w, idx, aux = _route(router_w, x, k, data_group=bgrp)
    if bgrp is None and mgrp is None:
        buf, meta = _dispatch(x, idx, k, E, capacity)
        out_buf = _expert_ffn(experts, buf, cfg.act)
        return _combine(out_buf, meta, w, T, k), None, aux
    buf, meta = _dispatch_global(coll.copy_to(x, mgrp), idx, k, first, n,
                                 capacity, _earlier_counts(idx, E, bgrp),
                                 min(capacity, T))
    out_buf = _expert_ffn(experts, buf, cfg.act)
    y = _combine(out_buf, meta, coll.copy_to(w, mgrp), T, k)
    return y, mgrp, aux


def _moe_out(p: Dict, cfg: ModelConfig, y: torch.Tensor, grp,
             xt: torch.Tensor, x: torch.Tensor, seq=None) -> torch.Tensor:
    """The routed experts' output ``y [T, d]`` of the tokens ``xt [T,
    d]`` (``x`` reshaped, or gathered whole under ``seq``), partial over
    ``grp``, summed, plus the shared experts' output (where the config has
    them), in ``x``'s shape. Under a sequence split the sum is
    reduce-scattered onto ``x``'s rows, where the shared experts run."""
    if seq is None:
        y = coll.reduce_from(y, grp)
        if cfg.n_shared_experts:
            y = y + gated_mlp(p["shared"], xt, cfg.act)
        return y.reshape(x.shape)
    y = leave(y.reshape(x.shape[0], -1, x.shape[-1]), grp, seq)
    if cfg.n_shared_experts:
        y = y + gated_mlp(p["shared"], x, cfg.act, seq=seq)
    return y


def moe_block_dense(p: Dict, cfg: ModelConfig, x: torch.Tensor, seq=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert on every token (tests / tiny configs only).
    Where the experts are split over ``model``, each rank applies its own
    to every token, weighed by its columns of the dense weights, and the
    partial outputs are summed over ``model`` (the f / g placement of
    :func:`_local_moe`). ``seq``: ``x`` is this rank's rows of a sequence
    split over ``model``; the router and the experts take the gathered
    whole, and the output is reduce-scattered back onto the rows."""
    xs = enter(x, None, seq)
    xt = xs.reshape(-1, xs.shape[-1])
    w, idx, aux = _route(p["router"], xt, cfg.experts_per_token,
                         data_group=axis_group("batch"))
    dense_w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=x.dtype,
                          device=x.device)
    dense_w.scatter_add_(1, idx.long(), w)
    mgrp, first, n = _split_experts(p["experts"], cfg)
    xe = xt
    if mgrp is not None:
        xe = coll.copy_to(xt, mgrp)
        dense_w = coll.copy_to(dense_w, mgrp)[:, first:first + n]
    ys = _expert_ffn(p["experts"], xe[None].expand(
        (n,) + tuple(xe.shape)), cfg.act)                  # [E_loc, T, d]
    y = torch.einsum("etd,te->td", ys, dense_w)
    return _moe_out(p, cfg, y, mgrp, xt, x, seq), aux


def _capacity(tokens: int, cfg: ModelConfig,
              factor: Optional[float] = None) -> int:
    c = int(tokens * cfg.experts_per_token / max(cfg.n_experts, 1)
            * (factor if factor is not None else CAPACITY_FACTOR))
    return max(8, ((c + 7) // 8) * 8)


def moe_block_local(p: Dict, cfg: ModelConfig, x: torch.Tensor, seq=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-scatter MoE without expert parallelism. x: [B, S, d], this
    rank's rows; the capacity is the global batch's (``B`` times the
    ranks the rule ``batch`` splits the rows over). ``seq``: as in
    :func:`moe_block_dense`."""
    xs = enter(x, None, seq)
    B, S, d = xs.shape
    xt = xs.reshape(-1, d)
    y, mgrp, aux = _local_moe(xt, p["router"], p["experts"], cfg,
                              _capacity(B * axis_size("batch") * S, cfg))
    return _moe_out(p, cfg, y, mgrp, xt, x, seq), aux


# ---------------------------------------------------------------------------
# Expert-parallel paths (the mesh's model axis; decode: also its data axes)
# ---------------------------------------------------------------------------
def _axes_in_order(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in axes)


def _stored_ff_axes(mesh, ff_axes) -> Tuple[str, ...]:
    """The mesh axes the installed rules store the expert ffn over
    (``expert_ff``), in mesh order; ``ff_axes`` where none are
    installed."""
    rules = current_rules()
    if rules is None:
        return ff_axes
    return _axes_in_order(mesh, entry_axes(rules.rules.get("expert_ff")))


def moe_block_ep(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, mesh,
                 batch_axes: Tuple[str, ...], model_axis: str = "model",
                 decode: bool = False, dispatch_dtype: str = "bfloat16",
                 capacity_factor: float = 1.25, ep2d: bool = False,
                 seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. x: [B_loc, S, d], this rank's rows of the batch
    (split over ``batch_axes``), whole over ``model`` (``seq``, train
    only: this rank's chunk of the sequence over ``model``, the very
    chunk the all-to-all path cuts, which it then takes as it comes and
    returns as it is). Expert weights split
    over ``model_axis``; with ``ep2d`` (decode) the expert FFN dim is also
    split over the data axes, a weight layout that fits 100B+ MoEs for
    serving. Returns (y [B_loc, S, d], aux), both whole over ``model``.

    The weights come as the rules store them: the expert ffn split over
    the axes the rule ``expert_ff`` names (the reference's ``--moe-ep2d``
    maps it to ``data`` for every cell), or over ``ff_axes`` where no rules
    are installed. Where that is fewer axes than decode's ``ff_axes`` (the
    multi-pod mesh: ``data`` of ``(pod, data)``) each rank takes its chunk
    of the stored shard over the rest; off decode the shard is gathered to
    the whole ffn, layer by layer, with ``gather_to`` (its gradient a
    reduce-scatter: each data rank's gradient of the whole comes from its
    own tokens), as the reference's ``shard_map`` takes it whole."""
    E = cfg.n_experts
    tp = mesh.shape[model_axis]
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} ranks")
    ff_axes = _axes_in_order(mesh, batch_axes) if (decode and ep2d) else ()
    stored = _stored_ff_axes(mesh, ff_axes)
    want = (E // tp, cfg.d_model, cfg.d_ff // mesh.axis_size(stored)
            if stored else cfg.d_ff)
    if tuple(p["experts"]["wi"].shape) != want:
        raise ValueError(
            f"expert weights of local shape {tuple(p['experts']['wi'].shape)}"
            f"; this path ({'decode' if decode else 'train / prefill'}"
            f"{', ep2d' if ff_axes else ''}, expert_ff stored over "
            f"{stored or None}) computes on {want}")
    ex = p["experts"]
    if ff_axes and stored != ff_axes:
        if not set(stored) <= set(ff_axes):
            raise ValueError(f"expert_ff stored over {stored}, which decode's "
                             f"ffn split over {ff_axes} does not hold")
        rest = mesh.group(tuple(a for a in ff_axes if a not in stored))
        ex = {"wi": coll.chunk(ex["wi"], 2, rest),
              "wg": coll.chunk(ex["wg"], 2, rest),
              "wo": coll.chunk(ex["wo"], 1, rest)}
    elif not ff_axes and stored:
        grp = mesh.group(stored)
        ex = {"wi": coll.gather_to(ex["wi"], 2, grp),
              "wg": coll.gather_to(ex["wg"], 2, grp),
              "wo": coll.gather_to(ex["wo"], 1, grp)}
    p_ep = {"router": p["router"], "experts": ex}
    if decode:
        y, aux = _ep_gather(x, p_ep, cfg, mesh, model_axis, batch_axes,
                            ff_axes, dispatch_dtype, capacity_factor)
    else:
        y, aux = _ep_a2a(x, p_ep, cfg, mesh, model_axis, batch_axes,
                         dispatch_dtype, capacity_factor, split=seq is None)
    if cfg.n_shared_experts:
        y = y + gated_mlp(p["shared"], x, cfg.act, seq=seq)
    return y, aux


def _batch_group(mesh, batch_axes):
    axes = _axes_in_order(mesh, batch_axes)
    return mesh.group(axes) if axes and mesh.axis_size(axes) > 1 else None


def _ep_a2a(x, p, cfg, mesh, model_axis, batch_axes, dispatch_dtype,
            capacity_factor, split=True):
    """Per-rank body, train / prefill path: the sequence split over
    ``model`` (``split`` false: ``x`` is this rank's chunk already, and
    so is the output), two all-to-alls over it."""
    tp = mesh.shape[model_axis]
    mgrp = mesh.group(model_axis)
    x_loc = x
    if split:
        if x.shape[1] % tp:
            raise ValueError(f"a sequence of {x.shape[1]} tokens does not "
                             f"split over {tp} ranks of {model_axis!r}")
        x_loc = coll.split_to(x, 1, mgrp)
    B, Sl, d = x_loc.shape
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
    return (coll.gather_from(y, 1, mgrp) if split else y), aux


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
              capacity_factor: float = 1.25, ep2d: bool = False,
              seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``impl`` ``"dense"`` (the oracle), ``"local"`` or ``"ep"`` (needs
    ``mesh``). As in the reference, the local path sizes its buffers with
    the module's :data:`CAPACITY_FACTOR`; ``capacity_factor`` and the mesh
    arguments belong to the expert-parallel path. ``seq``: ``x`` is this
    rank's rows of a sequence split over ``model`` (training), and so is
    the output."""
    if impl == "dense":
        return moe_block_dense(p, cfg, x, seq)
    if impl == "local":
        return moe_block_local(p, cfg, x, seq)
    if impl == "ep":
        if mesh is None:
            raise ValueError("impl='ep' splits the experts over a device "
                             "mesh: give Runtime(mesh=...) or run inside "
                             "sharding_ctx(rules, mesh)")
        return moe_block_ep(p, cfg, x, mesh=mesh, batch_axes=batch_axes,
                            decode=decode, dispatch_dtype=dispatch_dtype,
                            capacity_factor=capacity_factor, ep2d=ep2d,
                            seq=seq)
    raise ValueError(impl)
