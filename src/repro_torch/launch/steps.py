"""Step builders (train / prefill / decode) and abstract input specs for the
multi-pod dry run, each one function on the port's parameters and tensors.

Under ``rt.mesh`` a step runs on this rank's shards inside
:func:`~repro_torch.models.common.sharding_ctx`: the parameters are split
as :func:`~repro_torch.models.model.param_specs` says, the batch's rows
over the batch axes. The train step is data x tensor parallel with ZeRO-1:
each gradient leaf is averaged over the batch axes by a reduce-scatter into
the shard of the moments :func:`~repro_torch.parallel.sharding.zero1_specs`
gives it (an all-reduce where no dim divides), AdamW updates that shard of
the parameter, and the updated shards are all-gathered back. With
``zero1=False`` (the reference's ``abstract_state(zero1=False)``) the
moments take the parameters' specs: every gradient is all-reduced over the
batch axes, AdamW updates the whole local parameter, and nothing is
gathered after it. A parameter the rules split over a batch axis (the
expert ffn over ``data`` under ``--moe-ep2d``) trains only so: the model
gathers it with ``gather_to``, whose backward sums its gradient over that
axis, so the step sums it only over the batch axes its spec does not hold
(``pod``) before the mean. With ZeRO-1 it raises, as the reference does.

The abstract specs are ``meta`` tensors of the global shapes (nothing is
allocated), each carrying ``.spec`` (its PartitionSpec) and ``.sharding``
(the spec bound to the mesh, ``None`` without one): the reference's
``ShapeDtypeStruct(sharding=NamedSharding(...))``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decode as decode_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import (ShardingRules, default_rules,
                                       sharding_ctx)
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig, apply_updates
from repro_torch.optim.adamw import moment_torch_dtype
from repro_torch.optim.compression import compress_grads
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (NamedSharding, P, entry_axes,
                                           is_spec, named_sharding_tree,
                                           zero1_specs)
from repro_torch.tree import (leaves_with_paths, tree_leaves, tree_map,
                              tree_unflatten)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def _grads(cfg: ModelConfig, rt: Runtime, params: Any, batch: Dict):
    """(grads, metrics) of ``loss_fn`` with respect to ``params``, through
    detached copies that require grad."""
    leaves_p = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model_mod.loss_fn(cfg, rt, leaves_p, batch)
    leaves = tree_leaves(leaves_p)
    grads = tree_unflatten(leaves_p, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True))
    return grads, {k: v.detach() for k, v in metrics.items()}


def _rules_for(rt: Runtime, rules: Optional[ShardingRules]):
    """``rules``, the mesh's :func:`default_rules` by default; none without
    a mesh."""
    if rt.mesh is None:
        return None
    return rules or default_rules("pod" in rt.mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A parameter leaf's ZeRO-1 plan: the dim its moments split over the
    batch axes (``None``: kept whole, the gradient all-reduced), how many
    ranks hold each of its moment elements (the global norm counts each
    once), the group its parameter is split over (``None``: whole), and,
    for a leaf split over batch axes itself (the expert ffn under
    ``--moe-ep2d``), ``held``: its gradient comes summed over those axes
    (``gather_to``'s reduce-scatter), and ``rest`` is the group of the
    batch axes its spec does not hold, over which it is still summed."""
    zdim: Optional[int]
    copies: int
    group: Any
    held: bool = False
    rest: Any = None


_WHOLE = _Leaf(None, 1, None)


def _moment_specs(cfg: ModelConfig, rt: Runtime, rules: ShardingRules,
                  zero1: bool = True):
    """(parameter spec tree, moment spec tree, batch axes in mesh order)
    under ``rt.mesh`` (any mesh with ``shape`` and ``axis_names``): with
    ``zero1`` false every leaf's moments take its parameter's spec. A leaf
    split over a batch axis takes ZeRO-1 as the reference does:
    :func:`zero1_specs` puts the batch axes on its first free dim, and a
    spec that names an axis twice raises ``ValueError`` naming the leaf
    (where the reference's NamedSharding raises ``DuplicateSpecError``)."""
    mesh = rt.mesh
    batch_axes = tuple(a for a in mesh.axis_names if a in rt.batch_axes)
    p_specs = model_mod.param_specs(cfg, rt, rules)
    m_specs = (zero1_specs(p_specs, _meta_params(cfg, rt), mesh, batch_axes)
               if zero1 else p_specs)
    for (path, ps), ms in zip(leaves_with_paths(p_specs, is_leaf=is_spec),
                              tree_leaves(m_specs, is_leaf=is_spec)):
        named = [a for e in ms for a in entry_axes(e)]
        twice = sorted({a for a in named if named.count(a) > 1})
        if twice:
            raise ValueError(
                f"the ZeRO-1 moments of {path} ({ps}) take the spec {ms}, "
                f"which names axis {twice[0]!r} twice: the parameter is "
                f"split over a batch axis already (as the reference's "
                f"zero1_specs gives, whose NamedSharding refuses it); "
                f"run with zero1=False")
    return p_specs, m_specs, batch_axes


def _zero1_plan(cfg: ModelConfig, rt: Runtime, rules: ShardingRules,
                zero1: bool = True):
    """(plan tree, moment spec tree, batch axes in mesh order). Without a
    mesh every leaf is whole (and there are no specs); else the specs of
    :func:`_moment_specs`."""
    mesh = rt.mesh
    if mesh is None:
        return tree_map(lambda _: _WHOLE, _meta_params(cfg, rt)), None, ()
    p_specs, m_specs, batch_axes = _moment_specs(cfg, rt, rules, zero1)

    def leaf(ps: P, ms: P):
        zdim = next((i for i, (a, b) in enumerate(zip(
            tuple(ps) + (None,) * (len(ms) - len(ps)), ms)) if a != b), None)
        used = {a for e in ms for a in entry_axes(e)}
        copies = math.prod(n for a, n in mesh.shape.items() if a not in used)
        split = tuple(a for a in mesh.axis_names
                      if any(a in entry_axes(e) for e in ps))
        group = (mesh.group(split) if split and mesh.axis_size(split) > 1
                 else None)
        if not any(a in batch_axes for a in split):
            return _Leaf(zdim, copies, group)
        rest = tuple(a for a in batch_axes if a not in split)
        return _Leaf(zdim, copies, group, True,
                     mesh.group(rest) if rest and mesh.axis_size(rest) > 1
                     else None)

    plan = tree_map(leaf, p_specs, m_specs, is_leaf=is_spec)
    return plan, m_specs, batch_axes


def train_state_shardings(cfg: ModelConfig, rt: Runtime,
                          rules: Optional[ShardingRules] = None,
                          zero1: bool = True) -> Optional[Dict]:
    """The :class:`~repro_torch.parallel.sharding.NamedSharding` tree of
    the state :func:`init_train_state` makes under ``rt.mesh``: the
    parameters' specs for ``params``, each leaf's ZeRO-1 moment spec for
    ``opt["m"]`` and ``opt["v"]`` (the parameter's own with ``zero1``
    false), ``step`` replicated (``grad_error`` leaves, where there are
    any, take the parameters'). What :func:`~repro_torch.checkpoint.save`
    gathers by and :func:`~repro_torch.checkpoint.restore` cuts by.
    ``None`` without a mesh: every leaf whole."""
    if rt.mesh is None:
        return None
    p_specs, m_specs, _ = _moment_specs(cfg, rt, _rules_for(rt, rules),
                                        zero1)
    m_sh = named_sharding_tree(m_specs, rt.mesh)
    return {"params": named_sharding_tree(p_specs, rt.mesh),
            "opt": {"m": m_sh, "v": m_sh,
                    "step": NamedSharding(rt.mesh, P())}}


def init_train_state(cfg: ModelConfig, rt: Runtime, params: Any,
                     rules: Optional[ShardingRules] = None,
                     moment_dtype: str = "float32",
                     zero1: bool = True) -> Dict:
    """``{"params", "opt"}`` for :func:`make_train_step`: zero moments of
    the shapes the step keeps (under ``rt.mesh``: this rank's ZeRO-1 shard
    of each leaf, or of its local parameter with ``zero1`` false, see
    :func:`train_state_shardings`), ``step`` 0, on the parameters'
    device."""
    plan, _, batch_axes = _zero1_plan(cfg, rt, _rules_for(rt, rules), zero1)
    dp = rt.mesh.axis_size(batch_axes) if batch_axes else 1
    dt = moment_torch_dtype(moment_dtype)

    def zeros(p: torch.Tensor, pl: _Leaf) -> torch.Tensor:
        shape = list(p.shape)
        if pl.zdim is not None:
            shape[pl.zdim] //= dp
        return torch.zeros(shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"params": params,
            "opt": {"m": tree_map(zeros, params, plan),
                    "v": tree_map(zeros, params, plan),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=device)}}


def make_train_step(cfg: ModelConfig, rt: Runtime, opt_cfg: OptConfig,
                    rules: Optional[ShardingRules] = None,
                    zero1: bool = True) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: ``loss_fn``,
    its gradient with respect to ``state["params"]``, the int8 error-
    feedback compression where ``opt_cfg.grad_compression`` says so (state
    key ``grad_error``), then AdamW. ``state`` is ``{"params", "opt"}``
    (plus ``grad_error``), ``batch`` a dict of tensors on the parameters'
    device; the metrics are detached 0-d tensors, the loss's and the
    optimizer's. The parameters need not require grad: the step takes its
    gradient through detached copies that do.

    Under ``rt.mesh`` (module docstring): the parameters are this rank's
    shards under ``rules`` (default: the mesh's :func:`default_rules`),
    ``batch`` its rows, and ``state["opt"]`` the moments
    :func:`init_train_state` makes with the same ``zero1`` (each leaf's
    ZeRO-1 shard, or its whole local parameter's with ``zero1`` false).
    The loss is the whole batch's; gradients are averaged over the batch
    axes and clipped by their global norm. Without a mesh every group is
    ``None`` and every leaf whole, and the same body is one device's
    step."""
    mesh = rt.mesh
    rules = _rules_for(rt, rules)
    plan, _, batch_axes = _zero1_plan(cfg, rt, rules, zero1)
    dp = mesh.axis_size(batch_axes) if batch_axes else 1
    dgrp = mesh.group(batch_axes) if dp > 1 else None
    everyone = None if mesh is None else mesh.group(mesh.axis_names)

    def own(t: torch.Tensor, pl: _Leaf) -> torch.Tensor:
        """this rank's ZeRO-1 shard of a whole (data-replicated) leaf"""
        return t if pl.zdim is None else coll.chunk(t, pl.zdim, dgrp)

    def mean(g: torch.Tensor, pl: _Leaf) -> torch.Tensor:
        """the batch axes' mean of ``g``, whole (a leaf split over batch
        axes: summed over them already, this rank's shard of it)"""
        if dgrp is None:
            return g
        return coll.all_reduce(g, pl.rest if pl.held else dgrp) / dp

    def average(g: torch.Tensor, pl: _Leaf) -> torch.Tensor:
        """:func:`mean`, this rank's ZeRO-1 shard of it"""
        if dgrp is None or pl.held or pl.zdim is None:
            return mean(g, pl)
        return coll.reduce_scatter(g, pl.zdim, dgrp) / dp

    def sum_sq(g: torch.Tensor, pl: _Leaf) -> torch.Tensor:
        """``g``'s share of the squared global norm"""
        s = torch.sum(torch.square(g.float()))
        return s if pl.copies == 1 else s / pl.copies

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with sharding_ctx(rules, mesh):
            grads, metrics = _grads(cfg, rt, state["params"], batch)
        extra = {}
        if opt_cfg.grad_compression == "int8":
            # the averaged gradient, quantized at each whole tensor's scale:
            # the absmax over every axis that holds a shard of the leaf
            avg = tree_map(mean, grads, plan)
            absmax = tree_map(lambda g, e, pl: coll.all_reduce(
                torch.max(torch.abs(g.float() + e)), pl.group, op="max"),
                avg, state["grad_error"], plan)
            avg, extra["grad_error"] = compress_grads(
                avg, state["grad_error"], absmax)
            shards = tree_map(own, avg, plan)
        else:
            shards = tree_map(average, grads, plan)
        del grads
        sumsq = sum(tree_leaves(tree_map(sum_sq, shards, plan)))
        gnorm = torch.sqrt(coll.all_reduce(sumsq, everyone))
        p_shards = tree_map(own, state["params"], plan)
        new_p, new_opt, om = apply_updates(p_shards, shards, state["opt"],
                                           opt_cfg, grad_norm=gnorm)
        new_params = tree_map(
            lambda p, pl: p if pl.zdim is None
            else coll.all_gather(p, pl.zdim, dgrp), new_p, plan)
        return ({"params": new_params, "opt": new_opt, **extra},
                {**metrics, **om})

    return train_step


def _ctx(rt: Runtime, rules: Optional[ShardingRules]):
    return sharding_ctx(_rules_for(rt, rules), rt.mesh)


def make_prefill_step(cfg: ModelConfig, rt: Runtime, max_len: int,
                      rules: Optional[ShardingRules] = None) -> Callable:
    """``prefill_step(params, batch) -> (logits, decode_state)``; under
    ``rt.mesh`` on this rank's shards (``rules``: the mesh's
    :func:`default_rules` by default)."""
    def prefill_step(params: Dict, batch: Dict):
        with _ctx(rt, rules):
            return decode_mod.prefill(cfg, rt, params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, rt: Runtime,
                     rules: Optional[ShardingRules] = None) -> Callable:
    """``serve_step(params, token, pos, state) -> (logits, state)``; under
    ``rt.mesh`` on this rank's shards."""
    def serve_step(params: Dict, token: torch.Tensor, pos: torch.Tensor,
                   state: Dict):
        with _ctx(rt, rules):
            return decode_mod.decode_step(cfg, rt, params, token, pos, state)

    return serve_step


# ---------------------------------------------------------------------------
# Abstract specs (meta tensors with their specs; no allocation)
# ---------------------------------------------------------------------------
def _sds(shape, dtype: torch.dtype, mesh, spec: P) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` carrying ``.spec`` and
    ``.sharding``."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.spec = P(*spec)
    t.sharding = None if mesh is None else NamedSharding(mesh, t.spec)
    return t


def rules_for_shape(shape: ShapeConfig, multi_pod: bool,
                    mesh) -> ShardingRules:
    """Batch sharding degrades gracefully when global_batch doesn't divide
    the data axes (e.g. long_500k with batch 1 -> replicated batch)."""
    rules = default_rules(multi_pod)
    if mesh is not None:
        dp = math.prod(mesh.shape[a] for a in
                       (("pod", "data") if multi_pod else ("data",)))
        if shape.global_batch % dp:
            d = dict(rules.rules)
            d["batch"] = None
            rules = ShardingRules(rules=d)
    return rules


def _meta_params(cfg: ModelConfig, rt: Runtime):
    return model_mod.init_params(cfg, dataclasses.replace(rt, mesh=None),
                                 device="meta")


def abstract_params(cfg: ModelConfig, rt: Runtime, mesh,
                    rules: ShardingRules):
    """(meta tensor tree with specs, spec tree)."""
    specs = model_mod.param_specs(cfg, rt, rules=rules)
    structs = tree_map(lambda s, sp: _sds(s.shape, s.dtype, mesh, sp),
                       _meta_params(cfg, rt), specs)
    return structs, specs


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: ShardingRules, kind: str) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    b3 = rules.mesh_axes(["batch", None, None])
    tok_len = S + 1 if kind == "train" else S
    out = {"tokens": _sds((B, tok_len), torch.int32, mesh,
                          rules.mesh_axes(["batch", None]))}
    if cfg.frontend_seq:
        out["frontend"] = _sds((B, cfg.frontend_seq, cfg.d_model),
                               torch.bfloat16 if cfg.dtype == "bfloat16"
                               else torch.float32, mesh, b3)
    return out


def abstract_state(cfg: ModelConfig, rt: Runtime, mesh,
                   rules: ShardingRules, zero1: bool = True,
                   moment_dtype: str = "float32"):
    """Training state (params + AdamW moments) as abstract tensors."""
    p_structs, p_specs = abstract_params(cfg, rt, mesh, rules)
    m_specs = p_specs
    if zero1 and mesh is not None:
        batch_axes = (("pod", "data") if "pod" in mesh.axis_names
                      else ("data",))
        m_specs = zero1_specs(p_specs, p_structs, mesh, batch_axes)
    mdt = moment_torch_dtype(moment_dtype)
    mom = tree_map(lambda s, sp: _sds(s.shape, mdt, mesh, sp), p_structs,
                   m_specs)
    opt = {"m": mom, "v": mom, "step": _sds((), torch.int32, mesh, P())}
    return {"params": p_structs, "opt": opt}


def abstract_decode_state(cfg: ModelConfig, rt: Runtime, batch: int,
                          max_len: int, mesh, rules: ShardingRules):
    shapes = decode_mod.abstract_decode_state(cfg, rt, batch, max_len)
    specs = decode_mod.decode_state_specs(cfg, rt, batch, max_len,
                                          rules=rules)
    return tree_map(lambda s, sp: _sds(s.shape, s.dtype, mesh, sp), shapes,
                    specs)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rt: Runtime,
                mesh=None, rules: Optional[ShardingRules] = None,
                zero1: bool = True,
                moment_dtype: str = "float32") -> Tuple[Tuple, Dict]:
    """Abstract arguments for the step implied by ``shape.kind``:

    * train   -> (state, batch)
    * prefill -> (params, batch)
    * decode  -> (params, token, pos, decode_state)
    """
    rules = rules or default_rules()
    if shape.kind == "train":
        state = abstract_state(cfg, rt, mesh, rules, zero1=zero1,
                               moment_dtype=moment_dtype)
        return (state, batch_specs(cfg, shape, mesh, rules, "train")), {}
    if shape.kind == "prefill":
        params, _ = abstract_params(cfg, rt, mesh, rules)
        return (params, batch_specs(cfg, shape, mesh, rules, "prefill")), {}
    if shape.kind == "decode":
        params, _ = abstract_params(cfg, rt, mesh, rules)
        B, S = shape.global_batch, shape.seq_len
        token = _sds((B, 1), torch.int32, mesh,
                     rules.mesh_axes(["batch", None]))
        pos = _sds((), torch.int32, mesh, P())
        state = abstract_decode_state(cfg, rt, B, S, mesh, rules)
        return (params, token, pos, state), {}
    raise ValueError(shape.kind)
