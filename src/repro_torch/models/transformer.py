"""Trunk assembly for every architecture family: dense and MoE (GQA or
MLA attention), SSM (Mamba2's SSD blocks), hybrid (RecurrentGemma's pattern
of RG-LRU and local-attention blocks), VLM (Llama 3.2 Vision's groups of
self-attention layers, each followed by a gated cross-attention block over
the image's patch embeddings) and enc-dec (SeamlessM4T's non-causal
encoder over the frontend's frames, and a decoder whose layers also attend
to the encoder's output).

The reference scans over layer parameters stacked on a leading axis (the
hybrid over stacked pattern groups, then the remainder layers; the VLM over
groups, each an inner scan over its self layers); here the layers are a
Python list of per-layer parameter dicts in layer order and the trunk is a
loop over them — a hybrid layer ``i`` is of kind ``block_pattern[i %
len(block_pattern)]``, and a VLM's self layer ``g * cross_attn_every + j``
is layer ``j`` of group ``g``, whose cross block is ``cross[g]``.

``Runtime.remat`` recomputes activations in the backward where the
reference's ``jax.checkpoint`` does, a layer body at a time (a hybrid
pattern group, a VLM group): ``"full"`` saves a body's inputs only,
``"dots"`` also saves the outputs of its matrix products without batch
dims (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
weight products; attention's and the experts' batched products are
recomputed).

Under the rule ``seq -> model`` (sequence parallelism, the reference's
``--seq-shard``) the trunks here, the training path's and the encoder,
read :func:`~repro_torch.models.common.seq_split` and keep this rank's rows
of the residual stream between the blocks, which they call with ``seq``;
:func:`residual` checks the rows where the reference constrains them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamMaker, current_mesh,
                                       default_rules, gated_mlp,
                                       gated_mlp_params, rms_norm, seq_split,
                                       shard, sharding_ctx)
from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs orthogonal to the architecture config.

    ``attn_impl`` picks the route of the attention the flash kernel
    computes (prefill, and cross-attention at decode): ``"kernel"`` sends
    the kernel's case on the card to the hand-written kernel, ``"plain"``
    keeps it on the plain chunked loops. While autograd records, attention
    takes the differentiable route whatever ``attn_impl`` says
    (:func:`repro_torch.models.attention.chunked_attention`).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) and ``batch_axes``
    place the model on several ranks: ``tp`` is the mesh's ``model`` size,
    the parameters are this rank's shards (``model.param_specs``), and the
    batch is split over ``batch_axes``. The ``moe_*`` knobs belong to the
    expert-parallel path (``moe_impl="ep"``). ``decode_cache_shard="seq"``
    puts the decode cache's sequence dim on ``model`` where its kv heads do
    not split there (and MLA's latent cache always, at ``tp > 1``): each
    rank holds ``max_len / tp`` positions, and the decode attention combines
    the ranks' partial softmax sums (flash-decoding,
    :func:`repro_torch.models.attention.decode_self_attention`)."""
    tp: int = 1
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    moe_impl: str = "local"       # dense | local | ep
    remat: str = "none"           # none | full | dots
    mtp_coef: float = 0.1
    decode_impl: str = "chunked"  # chunked | dense (single einsum)
    decode_cache_shard: str = "none"  # none | seq (cache seq dim -> model)
    moe_dispatch_dtype: str = "bfloat16"  # bfloat16 | f8 (fp8 dispatch)
    moe_capacity_factor: float = 1.25
    moe_ep2d_decode: bool = False  # 2D expert sharding for decode
    attn_impl: str = "kernel"     # kernel | plain


def runtime_ctx(rt: Runtime):
    """The sharding context the model's entry points run in: with
    ``rt.mesh`` and none installed, ``rt.mesh`` under the default rules of
    its axes; else the installed one (or none). ``rt.tp`` must be the
    mesh's ``model`` size, which the parameters' shapes were built for."""
    mesh = current_mesh() or rt.mesh
    if mesh is not None and mesh.shape.get("model", 1) != rt.tp:
        raise ValueError(f"Runtime(tp={rt.tp}) on a mesh of "
                         f"model={mesh.shape.get('model', 1)}")
    if rt.mesh is None or current_mesh() is not None:
        return contextlib.nullcontext()
    return sharding_ctx(default_rules("pod" in rt.mesh.axis_names), rt.mesh)


#: the families the port serves: dense and MoE (GQA or MLA attention), SSM,
#: hybrid RG-LRU, VLM and enc-dec
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """``ValueError`` for a family outside :data:`FAMILIES`, as the
    reference raises for one."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{FAMILIES}")


#: the products whose outputs ``remat="dots"`` keeps: 2-D matrix products,
#: which is what a weight product ``x @ w`` becomes (batched ones are bmm)
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, rt: Runtime) -> Callable:
    """``fn`` recomputed in the backward as ``rt.remat`` says: ``"none"``
    returns it as it is."""
    if rt.remat == "none":
        return fn
    if rt.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if rt.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                     f"{rt.remat!r}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def decoder_layer_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime,
                         cross: bool = False) -> Dict:
    """One decoder layer; ``cross`` adds the enc-dec decoder's
    cross-attention (``ln_x``, ``xattn``)."""
    check_family(cfg)
    p = {"ln1": mk("ln1", (cfg.d_model,), (None,), init="ones"),
         "ln2": mk("ln2", (cfg.d_model,), (None,), init="ones")}
    if cfg.use_mla:
        p["attn"] = attn.mla_params(mk, "attn", cfg, rt.tp)
    else:
        p["attn"] = attn.attention_params(mk, "attn", cfg, rt.tp)
    if cfg.family == "moe":
        p["mlp"] = moe_mod.moe_params(mk, "moe", cfg, rt.tp)
    else:
        p["mlp"] = gated_mlp_params(mk, "mlp", cfg.d_model, cfg.d_ff)
    if cross:
        p["ln_x"] = mk("ln_x", (cfg.d_model,), (None,), init="ones")
        p["xattn"] = attn.attention_params(mk, "xattn", cfg, rt.tp,
                                           cross=True)
    return p


def _norm(x, w, cfg: ModelConfig, seq=None):
    """``rms_norm(x, w)``. Under a sequence split (``seq``) the replicated
    gain ``w`` meets this rank's rows only, so its gradient is partial and
    it enters through ``copy_to`` (the ranks' gradients summed); without
    one its gradient is whole on every rank already, and ``copy_to`` on
    ``None`` is the identity. The VLM's tanh gates and MTP's weights take
    the same ``copy_to``."""
    return rms_norm(x, coll.copy_to(w, seq), cfg.norm_eps)


def _mixer(p, cfg: ModelConfig, rt: Runtime, x, positions, window=0,
           seq=None):
    h = _norm(x, p["ln1"], cfg, seq)
    if cfg.use_mla:
        return attn.mla_attention(p["attn"], cfg, h, positions,
                                  impl=rt.attn_impl, seq=seq)
    return attn.self_attention(p["attn"], cfg, h, positions, window=window,
                               impl=rt.attn_impl, seq=seq)


def _ffn(p, cfg: ModelConfig, rt: Runtime, x, decode: bool = False,
         seq=None) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """The layer's FFN on ``rms_norm(x)``: (output, aux loss). The MoE aux
    loss is a 0-d tensor; a dense FFN's is 0.0. ``seq``: ``x`` is this
    rank's rows of a sequence split (the training trunks under the rule
    ``seq``)."""
    h = _norm(x, p["ln2"], cfg, seq)
    if cfg.family == "moe":
        return moe_mod.moe_block(
            p["mlp"], cfg, h, impl=rt.moe_impl,
            mesh=current_mesh() or rt.mesh, batch_axes=rt.batch_axes,
            decode=decode, dispatch_dtype=rt.moe_dispatch_dtype,
            capacity_factor=rt.moe_capacity_factor, ep2d=rt.moe_ep2d_decode,
            seq=seq)
    return gated_mlp(p["mlp"], h, cfg.act, seq=seq), 0.0


def decoder_layer(p, cfg: ModelConfig, rt: Runtime, x, positions,
                  window: int = 0, memory=None, seq=None
                  ) -> Tuple[torch.Tensor, float]:
    """``seq``: ``x`` is this rank's rows of a sequence split, and so is
    the output; ``positions`` and ``memory`` are whole."""
    x = x + _mixer(p, cfg, rt, x, positions, window, seq)
    if memory is not None and "xattn" in p:
        h = _norm(x, p["ln_x"], cfg, seq)
        x = x + attn.cross_attention(p["xattn"], cfg, h, memory,
                                     impl=rt.attn_impl, seq=seq)
    y, aux = _ffn(p, cfg, rt, x, seq=seq)
    return x + y, aux


def residual(h: torch.Tensor, S: int) -> torch.Tensor:
    """``h`` as it is, its rank-local shape checked against the residual
    stream's spec ``("batch", "seq", None)`` over ``S`` positions: where
    the reference constrains the stream (its scan bodies' ``shard``)."""
    return shard(h, "batch", "seq", None, full=(None, S, h.shape[-1]))


# ---------------------------------------------------------------------------
# Homogeneous trunks (dense / moe decoder, ssm)
# ---------------------------------------------------------------------------
def _ssm_layer_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime) -> Dict:
    return {"ln1": mk("ln1", (cfg.d_model,), (None,), init="ones"),
            "ssm": ssm_mod.ssm_params(mk, "ssm", cfg, rt.tp)}


def trunk_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime,
                 n_layers: int, kind: str) -> List[Dict]:
    """``n_layers`` per-layer dicts of ``kind``: ``"decoder"`` (dense / MoE)
    or ``"ssm"``."""
    if kind == "ssm":
        return [_ssm_layer_params(mk, cfg, rt) for _ in range(n_layers)]
    return [decoder_layer_params(mk, cfg, rt) for _ in range(n_layers)]


def trunk_forward(params: List[Dict], cfg: ModelConfig, rt: Runtime, x,
                  positions, kind: str) -> Tuple[torch.Tensor, float]:
    """The dense / MoE decoder or SSM layers over ``x``. Under the rule
    ``seq`` (sequence parallelism) ``x`` and the output are this rank's
    rows of the ``positions.shape[-1]`` positions, and every layer's
    blocks gather and reduce-scatter them (:func:`seq_split`)."""
    S = positions.shape[-1]
    seq = seq_split(S)

    def body(x, p_layer):
        x = residual(x, S)
        if kind == "ssm":
            z = _norm(x, p_layer["ln1"], cfg, seq)
            return x + ssm_mod.ssd_forward(p_layer["ssm"], cfg, z,
                                           seq=seq), 0.0
        return decoder_layer(p_layer, cfg, rt, x, positions, seq=seq)

    body = _maybe_remat(body, rt)
    aux = 0.0
    for p_layer in params:
        x, a = body(x, p_layer)
        x = residual(x, S)
        aux += a
    return x, aux


# ---------------------------------------------------------------------------
# Encoder (enc-dec): non-causal self-attention over the frontend's frames
# ---------------------------------------------------------------------------
def encoder_layer_params(mk: ParamMaker, cfg: ModelConfig,
                         rt: Runtime) -> Dict:
    return decoder_layer_params(mk, cfg, rt)


def encoder_forward(params: List[Dict], cfg: ModelConfig, rt: Runtime,
                    x) -> torch.Tensor:
    """The encoder over ``x [B, F, d]``: each layer roped at ``arange(F)``,
    non-causal (on the card the flash kernel's case; under a head split,
    this rank's heads), then its FFN. Under the rule ``seq`` (training
    and prefill alike, as in the reference) the frames are split over
    its ranks between the blocks, each attention gathers them whole for
    this rank's heads, and the output is gathered whole once at the end
    (``gather_from``: the cross-attentions that read it take it through
    ``copy_to``, so its gradient is whole on every rank already)."""
    F = x.shape[1]
    positions = torch.arange(F, dtype=torch.int32, device=x.device)[None]
    seq = seq_split(F)

    def body(x, p_layer):
        x = residual(x, F)
        z = _norm(x, p_layer["ln1"], cfg, seq)
        x = x + attn.self_attention(p_layer["attn"], cfg, z, positions,
                                    impl=rt.attn_impl, causal=False, seq=seq)
        y, _ = _ffn(p_layer, cfg, rt, x, seq=seq)
        return residual(x + y, F)

    body = _maybe_remat(body, rt)
    x = coll.split_to(x, 1, seq)
    for p_layer in params:
        x = body(x, p_layer)
    return coll.gather_from(x, 1, seq)


# ---------------------------------------------------------------------------
# Hybrid trunk (recurrentgemma): the (rglru, rglru, attn) pattern
# ---------------------------------------------------------------------------
def hybrid_group_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(whole pattern groups, remainder layers) of the reference's stacked
    layout; the port's flat layer list is groups first, then the rest."""
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    return n_groups, cfg.n_layers - n_groups * len(pat)


def hybrid_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's kind, in layer order: ``block_pattern`` repeated."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _rg_block_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime,
                     kind: str) -> Dict:
    p = {"ln1": mk("ln1", (cfg.d_model,), (None,), init="ones"),
         "ln2": mk("ln2", (cfg.d_model,), (None,), init="ones"),
         "mlp": gated_mlp_params(mk, "mlp", cfg.d_model, cfg.d_ff)}
    if kind == "attn":
        p["attn"] = attn.attention_params(mk, "attn", cfg, rt.tp)
    else:
        p["rglru"] = rglru_mod.rglru_params(mk, "rglru", cfg, rt.tp)
    return p


def hybrid_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime
                  ) -> List[Dict]:
    return [_rg_block_params(mk, cfg, rt, kind) for kind in hybrid_kinds(cfg)]


def _rg_block(p, cfg: ModelConfig, rt: Runtime, x, positions, kind: str,
              seq=None):
    h = _norm(x, p["ln1"], cfg, seq)
    if kind == "attn":
        x = x + attn.self_attention(p["attn"], cfg, h, positions,
                                    window=cfg.local_window,
                                    impl=rt.attn_impl, seq=seq)
    else:
        x = x + rglru_mod.rglru_forward(p["rglru"], cfg, h, seq=seq)
    h = _norm(x, p["ln2"], cfg, seq)
    return x + gated_mlp(p["mlp"], h, cfg.act, seq=seq)


def hybrid_forward(params: List[Dict], cfg: ModelConfig, rt: Runtime, x,
                   positions) -> torch.Tensor:
    """The pattern groups (each one body for ``rt.remat``, as the
    reference's scan over groups), then the remainder layers. Under the
    rule ``seq`` ``x`` and the output are this rank's rows, as in
    :func:`trunk_forward`."""
    kinds = hybrid_kinds(cfg)
    n_groups, _ = hybrid_group_counts(cfg)
    n_pat = len(cfg.block_pattern)
    S = positions.shape[-1]
    seq = seq_split(S)

    def group(x, ps, ks):
        x = residual(x, S)
        for p, kind in zip(ps, ks):
            x = _rg_block(p, cfg, rt, x, positions, kind, seq)
        return residual(x, S)

    body = _maybe_remat(group, rt)
    for g in range(n_groups):
        x = body(x, params[g * n_pat:(g + 1) * n_pat],
                 kinds[g * n_pat:(g + 1) * n_pat])
    return group(x, params[n_groups * n_pat:], kinds[n_groups * n_pat:])


# ---------------------------------------------------------------------------
# VLM trunk: groups of (cross_attn_every self layers + 1 gated cross block)
# ---------------------------------------------------------------------------
def vlm_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime) -> Dict:
    """``{"self": [n_layers decoder layers], "cross": [n_layers //
    cross_attn_every cross blocks]}``; a cross block is ``ln_x``, ``ln_m``,
    ``xattn``, the tanh gates ``gate_a`` / ``gate_m`` (zeros at init, as in
    the reference: a fresh model ignores its image) and its own gated MLP
    ``mlp``."""
    n_groups = cfg.n_layers // cfg.cross_attn_every
    d = cfg.d_model
    cross = [{"ln_x": mk("ln_x", (d,), (None,), init="ones"),
              "ln_m": mk("ln_m", (d,), (None,), init="ones"),
              "xattn": attn.attention_params(mk, "xattn", cfg, rt.tp,
                                             cross=True),
              "gate_a": mk("gate_a", (1,), (None,), init="zeros"),
              "gate_m": mk("gate_m", (1,), (None,), init="zeros"),
              "mlp": gated_mlp_params(mk, "xmlp", d, cfg.d_ff)}
             for _ in range(n_groups)]
    return {"self": trunk_params(mk, cfg, rt,
                                 n_groups * cfg.cross_attn_every, "decoder"),
            "cross": cross}


def vlm_cross_tail(p: Dict, cfg: ModelConfig, x, ca,
                   seq=None) -> torch.Tensor:
    """The rest of a VLM cross block after its cross-attention output
    ``ca``: ``x + tanh(gate_a) ca``, then ``+ tanh(gate_m)`` times the
    block's gated MLP of ``rms_norm(., ln_m)``. ``seq``: ``x`` and ``ca``
    are this rank's rows of a sequence split (the gates scale those rows
    only: :func:`_norm`)."""
    x = x + torch.tanh(coll.copy_to(p["gate_a"], seq)) * ca
    z = _norm(x, p["ln_m"], cfg, seq)
    return x + torch.tanh(coll.copy_to(p["gate_m"], seq)) * gated_mlp(
        p["mlp"], z, cfg.act, seq=seq)


def vlm_forward(params: Dict, cfg: ModelConfig, rt: Runtime, x, positions,
                memory) -> torch.Tensor:
    """Under the rule ``seq`` ``x`` and the output are this rank's rows,
    as in :func:`trunk_forward`; the memory (the frontend) is whole."""
    k = cfg.cross_attn_every
    S = positions.shape[-1]
    seq = seq_split(S)

    def group(x, p_self, p_cross):
        x = residual(x, S)
        for p_layer in p_self:
            x, _ = decoder_layer(p_layer, cfg, rt, residual(x, S), positions,
                                 seq=seq)
            x = residual(x, S)
        z = _norm(x, p_cross["ln_x"], cfg, seq)
        ca = attn.cross_attention(p_cross["xattn"], cfg, z, memory,
                                  impl=rt.attn_impl, seq=seq)
        return vlm_cross_tail(p_cross, cfg, x, ca, seq)

    group = _maybe_remat(group, rt)
    for g, p_cross in enumerate(params["cross"]):
        x = group(x, params["self"][g * k:(g + 1) * k], p_cross)
    return x
