"""Serving substrate for every family: decode-state construction,
prefill, single-token decode.

The state mirrors the reference's layout where the reference stacks over
layers: ``{"layers": {"k": [L, B, M, Hkv, hd], "v": [L, B, M, Hkv, hd]}}``,
or for MLA the latent cache ``{"layers": {"c_kv": [L, B, M,
kv_lora_rank], "k_rope": [L, B, M, qk_rope_dim]}}``, or for the SSM family
``{"layers": {"h": [L, B, H, head_dim, d_state] (f32), "conv": [L, B, K -
1, conv_dim]}}``. The hybrid family's state is a list of per-layer dicts in
layer order, as its parameters are (the reference stacks it over pattern
groups and keeps the remainder layers apart): an RG-LRU layer's ``{"h":
[B, lru_width] (f32), "conv": [B, 3, lru_width]}`` and a local-attention
layer's ring ``{"k", "v": [B, min(local_window, M), Hkv, hd]}``, slot ``p %
window`` holding position ``p``. The VLM and enc-dec families hold
``{"self": {"k", "v": [L, B, M, Hkv, hd]}, "cross": {"k", "v": [C, B, F,
Hkv, hd]}}``: the decoder's self-attention cache, and the K and V of the
memory (``F`` frontend positions) that each cross-attention reads at every
step, written once by prefill and never recomputed. ``C`` is the number of
cross blocks (``n_layers / cross_attn_every`` for the VLM, ``n_layers`` for
the enc-dec); the reference stacks a VLM's self cache over its groups,
``[G, cross_attn_every, B, M, ...]``, which is the port's ``[L, ...]`` in
layer order. Caches are in bf16 for bf16 configs (f32
otherwise); the recurrent ``h`` is always f32. :func:`decode_step` writes
each layer's new row or state into those tensors in place and returns the
same dict; the reference returns a new pytree (its jitted callers donate
the old one).

With ``Runtime.decode_cache_shard="seq"`` the self cache's sequence dim
(``M``) takes the logical axis ``kv_seq`` (``model``) where its kv heads do
not split over ``model``, and MLA's latent cache always does at ``tp >
1`` (the reference's ``_seq_ax``): rank ``r`` holds positions ``[r M / tp,
(r + 1) M / tp)``. The prefill writes the prompt's rows that fall there,
and decode attends as :mod:`repro_torch.models.attention` says. The cross
caches and the hybrid's rings stay as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import as_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (axis_group, axis_size,
                                       current_mesh, current_rules,
                                       default_rules, gated_mlp, rms_norm)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import NamedSharding
from repro_torch.models.transformer import Runtime

#: families whose decode state is a position-indexed cache, so padding past a
#: sequence's true length is recoverable (masked at read time). The
#: recurrent families (ssm / hybrid) fold every prefill token into their
#: state and cannot un-see pads.
CAUSAL_CACHE_FAMILIES = ("dense", "moe", "vlm", "encdec")


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class CacheMaker:
    """``mk(shape, axes, dtype)``: one leaf of the decode state at its
    global ``shape`` with logical ``axes``. ``mode`` ``"array"``: zeros of
    this rank's shard (the shard the installed rules and mesh give the
    leaf; all of it without a mesh) on ``device``; ``"spec"``: the leaf's
    PartitionSpec under ``rules``; ``"meta"``: a ``meta`` tensor of the
    global shape."""

    def __init__(self, mode: str, device=None, rules=None):
        self.mode, self.device = mode, device
        self.rules = rules or default_rules()

    def __call__(self, shape, axes, dtype):
        if self.mode == "spec":
            return self.rules.mesh_axes(axes)
        if self.mode == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        mesh, rules = current_mesh(), current_rules()
        if mesh is not None and rules is not None:
            shape = NamedSharding(mesh, rules.mesh_axes(axes)).local_shape(
                shape)
        return torch.zeros(shape, dtype=dtype, device=self.device)


def _kv_axes(cfg: ModelConfig, rt: Runtime):
    nkv = cfg.padded_kv_heads(rt.tp)
    kv_ax = "kv_heads" if (rt.tp > 1 and nkv % rt.tp == 0) else None
    return nkv, kv_ax


#: the values of ``Runtime.decode_cache_shard``
DECODE_CACHE_SHARDS = ("none", "seq")


def _seq_ax(rt: Runtime, kv_ax):
    """The logical axis of the self cache's sequence dim: ``kv_seq`` under
    ``decode_cache_shard="seq"`` where the kv heads (``kv_ax``) do not
    split and ``tp > 1``, else none (the reference's ``_seq_ax``)."""
    if rt.decode_cache_shard not in DECODE_CACHE_SHARDS:
        raise ValueError(f"decode_cache_shard must be one of "
                         f"{DECODE_CACHE_SHARDS}, got "
                         f"{rt.decode_cache_shard!r}")
    if rt.decode_cache_shard == "seq" and kv_ax is None and rt.tp > 1:
        return "kv_seq"
    return None


def seq_group(cfg: ModelConfig, rt: Runtime):
    """The process group the self (or latent) cache's sequence dim is split
    over under the installed mesh and rules; ``None`` where it is whole
    (no split asked for, the kv heads split, a recurrent family, no mesh,
    or one rank)."""
    if cfg.family in ("ssm", "hybrid"):
        return None
    kv_ax = None if cfg.use_mla else _kv_axes(cfg, rt)[1]
    return axis_group("kv_seq") if _seq_ax(rt, kv_ax) else None


def _build_state(mk: CacheMaker, cfg: ModelConfig, rt: Runtime, B: int,
                 M: int) -> Dict:
    """The decode state of ``B`` sequences of up to ``M`` tokens, each
    leaf made by ``mk`` (module docstring for the layout)."""
    L, dt = cfg.n_layers, _cache_dtype(cfg)
    hd = cfg.resolved_head_dim
    nkv, kv_ax = _kv_axes(cfg, rt)
    sq = _seq_ax(rt, None if cfg.use_mla else kv_ax)
    if cfg.family == "hybrid":
        win = min(cfg.local_window, M)
        w = cfg.lru_width or cfg.d_model
        K = rglru_mod.CONV_K
        kv = ((B, win, nkv, hd), ("batch", None, kv_ax, None), dt)
        return {"layers": [
            {"k": mk(*kv), "v": mk(*kv)} if kind == "attn" else
            {"h": mk((B, w), ("batch", "lru"), torch.float32),
             "conv": mk((B, K - 1, w), ("batch", None, "lru"), dt)}
            for kind in tfm.hybrid_kinds(cfg)]}
    if cfg.family == "ssm":
        d_in, H, shd, ds = ssm_mod.ssm_dims(cfg)
        C = d_in + 2 * cfg.ssm_n_groups * ds
        return {"layers": {
            "h": mk((L, B, H, shd, ds), (None, "batch", "heads", None, None),
                    torch.float32),
            "conv": mk((L, B, cfg.ssm_conv_kernel - 1, C),
                       (None, "batch", None, "lru"), dt)}}
    if cfg.family in ("vlm", "encdec"):
        n_cross = (L // cfg.cross_attn_every if cfg.family == "vlm" else L)
        parts = {"self": ((L, B, M, nkv, hd),
                          (None, "batch", sq, kv_ax, None)),
                 "cross": ((n_cross, B, cfg.frontend_seq, nkv, hd),
                           (None, "batch", None, kv_ax, None))}
        return {part: {name: mk(shape, axes, dt) for name in ("k", "v")}
                for part, (shape, axes) in parts.items()}
    if cfg.use_mla:
        leaves = {"c_kv": (L, B, M, cfg.kv_lora_rank),
                  "k_rope": (L, B, M, cfg.qk_rope_dim)}
        return {"layers": {name: mk(shape, (None, "batch", sq, None), dt)
                           for name, shape in leaves.items()}}
    kv = ((L, B, M, nkv, hd), (None, "batch", sq, kv_ax, None), dt)
    return {"layers": {"k": mk(*kv), "v": mk(*kv)}}


def init_decode_state(cfg: ModelConfig, rt: Runtime, batch: int,
                      max_len: int, device=None) -> Dict:
    """Zeroed decode state for ``batch`` sequences of up to ``max_len``
    tokens on ``device`` (default: the card). Under a sharding context
    ``batch`` is the global batch and each leaf is this rank's shard."""
    tfm.check_family(cfg)
    return _build_state(CacheMaker("array", as_device(device)), cfg, rt,
                        batch, max_len)


def decode_state_specs(cfg: ModelConfig, rt: Runtime, batch: int,
                       max_len: int, rules=None) -> Dict:
    """The PartitionSpec of every leaf of :func:`init_decode_state`'s
    state, in the same structure."""
    tfm.check_family(cfg)
    return _build_state(CacheMaker("spec", rules=rules), cfg, rt, batch,
                        max_len)


def abstract_decode_state(cfg: ModelConfig, rt: Runtime, batch: int,
                          max_len: int) -> Dict:
    """:func:`init_decode_state`'s state as ``meta`` tensors of the global
    shapes."""
    tfm.check_family(cfg)
    return _build_state(CacheMaker("meta"), cfg, rt, batch, max_len)


def _pad_to(x: torch.Tensor, M: int, axis: int) -> torch.Tensor:
    """``x`` zero-padded to length ``M`` along ``axis``."""
    S = x.shape[axis]
    if S == M:
        return x
    shape = list(x.shape)
    shape[axis] = M - S
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _ring_from_kv(k: torch.Tensor, win: int) -> torch.Tensor:
    """Arrange the last ``win`` entries of k [B,S,...] into ring-buffer order
    (slot = pos % win)."""
    S = k.shape[1]
    if S <= win:
        return _pad_to(k, win, 1)
    base = S - win
    pos = [base + ((slot - base) % win) for slot in range(win)]
    return k[:, torch.tensor(pos, device=k.device)]


def _hybrid_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The second half of a hybrid block: ``x`` plus its gated MLP."""
    return x + gated_mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                         cfg.act)


def _write_prompt(cache: torch.Tensor, rows: torch.Tensor, sgrp) -> None:
    """The prompt's ``rows [B, S, ...]`` (positions ``0 .. S-1``) into
    ``cache [B, M, ...]``; split over the sequence on ``sgrp``, the rows of
    this rank's positions ``[r Ms, (r + 1) Ms)`` at their local offsets."""
    if sgrp is None:
        cache[:, :rows.shape[1]] = rows
        return
    Ms = cache.shape[1]
    lo = coll.rank(sgrp) * Ms
    hi = min(rows.shape[1], lo + Ms)
    if hi > lo:
        cache[:, :hi - lo] = rows[:, lo:hi]


def _self_prefill(p_layer: Dict, cfg: ModelConfig, rt: Runtime,
                  x: torch.Tensor, pos: torch.Tensor, caches, i: int,
                  sgrp=None) -> torch.Tensor:
    """``x`` plus layer ``i``'s self-attention (GQA or MLA) over the
    prompt, its K and V (or latent) rows written into row ``i`` of each of
    ``caches`` (this rank's positions of them where ``sgrp`` splits the
    sequence)."""
    z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        y, rows = attn.mla_attention(p_layer["attn"], cfg, z, pos,
                                     return_cache=True, impl=rt.attn_impl)
    else:
        y, rows = attn.self_attention(p_layer["attn"], cfg, z, pos,
                                      return_cache=True, impl=rt.attn_impl)
    for cache, r in zip(caches, rows):
        _write_prompt(cache[i], r, sgrp)
    return x + y


def _cross_prefill(p_attn: Dict, ln: torch.Tensor, cfg: ModelConfig,
                   rt: Runtime, x: torch.Tensor, memory: torch.Tensor,
                   cache: Dict, i: int) -> torch.Tensor:
    """The cross-attention output of ``rms_norm(x, ln)`` over ``memory``,
    the memory's K and V written into row ``i`` of ``cache``."""
    z = rms_norm(x, ln, cfg.norm_eps)
    ca, (k, v) = attn.cross_attention(p_attn, cfg, z, memory,
                                      return_cache=True, impl=rt.attn_impl)
    cache["k"][i] = k
    cache["v"][i] = v
    return ca


def prefill(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict,
            max_len: int, lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt through the trunk, building the decode state.
    Returns (last-token logits [B,1,V], state).

    ``lengths`` ([B] int) gives each sequence's true prompt length within
    the right-padded ``tokens``: logits are then read at position
    ``lengths[b]-1`` per sequence instead of the batch max (causal attention
    keeps positions < length clean; the pad rows the cache still holds are
    masked later by per-sequence decode positions). Only meaningful for
    :data:`CAUSAL_CACHE_FAMILIES`: the recurrent families raise
    ``ValueError``. Under a mesh the batch, the state and the parameters
    are this rank's shards, and the logits are whole over the vocab."""
    with tfm.runtime_ctx(rt):
        return _prefill(cfg, rt, p, batch, max_len, lengths)


def _prefill(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict,
             max_len: int, lengths: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict]:
    tfm.check_family(cfg)
    if lengths is not None and cfg.family not in CAUSAL_CACHE_FAMILIES:
        raise ValueError(
            f"per-sequence prefill lengths need a position-indexed "
            f"cache; the recurrent state of family {cfg.family!r} "
            f"absorbs pad tokens")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = model_mod.embed(p, cfg, tokens)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    state = init_decode_state(cfg, rt, B * axis_size("batch"), max_len,
                              device=x.device)
    sgrp = seq_group(cfg, rt)

    if cfg.family == "vlm":
        memory, k_in = batch["frontend"], cfg.cross_attn_every
        selfc = list(state["self"].values())
        for g, p_cross in enumerate(p["layers"]["cross"]):
            for i in range(g * k_in, (g + 1) * k_in):
                p_layer = p["layers"]["self"][i]
                x = _self_prefill(p_layer, cfg, rt, x, pos, selfc, i, sgrp)
                x = x + tfm._ffn(p_layer, cfg, rt, x)[0]
            ca = _cross_prefill(p_cross["xattn"], p_cross["ln_x"], cfg, rt,
                                x, memory, state["cross"], g)
            x = tfm.vlm_cross_tail(p_cross, cfg, x, ca)
    elif cfg.family == "encdec":
        memory = tfm.encoder_forward(p["encoder"], cfg, rt, batch["frontend"])
        selfc = list(state["self"].values())
        for i, p_layer in enumerate(p["layers"]):
            x = _self_prefill(p_layer, cfg, rt, x, pos, selfc, i, sgrp)
            x = x + _cross_prefill(p_layer["xattn"], p_layer["ln_x"], cfg,
                                   rt, x, memory, state["cross"], i)
            x = x + tfm._ffn(p_layer, cfg, rt, x)[0]
    elif cfg.family == "ssm":
        layers = state["layers"]
        for i, p_layer in enumerate(p["layers"]):
            z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            y, (h, conv) = ssm_mod.ssd_forward(p_layer["ssm"], cfg, z,
                                               return_state=True)
            layers["h"][i] = h
            layers["conv"][i] = conv
            x = x + y
    elif cfg.family == "hybrid":
        for p_layer, cache, kind in zip(p["layers"], state["layers"],
                                        tfm.hybrid_kinds(cfg)):
            z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            if kind == "attn":
                y, (k, v) = attn.self_attention(
                    p_layer["attn"], cfg, z, pos, window=cfg.local_window,
                    return_cache=True, impl=rt.attn_impl)
                win = cache["k"].shape[1]
                cache["k"].copy_(_ring_from_kv(k, win))
                cache["v"].copy_(_ring_from_kv(v, win))
            else:
                y, (h, tail) = rglru_mod.rglru_forward(
                    p_layer["rglru"], cfg, z, return_state=True)
                cache["h"].copy_(h)
                cache["conv"].copy_(tail)
            x = _hybrid_mlp(p_layer, cfg, x + y)
    else:
        caches = list(state["layers"].values())  # (k, v) or (c_kv, k_rope)
        for i, p_layer in enumerate(p["layers"]):
            x = _self_prefill(p_layer, cfg, rt, x, pos, caches, i, sgrp)
            x = x + tfm._ffn(p_layer, cfg, rt, x)[0]

    if lengths is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(lengths, device=x.device).long() - 1
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
    return model_mod.logits_fn(p, cfg, x_last), state


def _self_decode(p_layer: Dict, cfg: ModelConfig, rt: Runtime,
                 x: torch.Tensor, cache: Dict, pos: torch.Tensor,
                 sgrp=None) -> torch.Tensor:
    """``x`` plus one token's self-attention (GQA or MLA) of a layer, its
    new row written into ``cache`` in place (split over the sequence on
    ``sgrp``)."""
    z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        y, _ = attn.mla_decode(p_layer["attn"], cfg, z, cache, pos,
                               seq_group=sgrp)
    else:
        y, _ = attn.decode_self_attention(p_layer["attn"], cfg, z, cache, pos,
                                          impl=rt.decode_impl,
                                          seq_group=sgrp)
    return x + y


def _cross_decode(p_attn: Dict, ln: torch.Tensor, cfg: ModelConfig,
                  rt: Runtime, x: torch.Tensor, cache: Dict,
                  i: int) -> torch.Tensor:
    """One token's cross-attention output over row ``i`` of the memory's
    cached K and V."""
    z = rms_norm(x, ln, cfg.norm_eps)
    return attn.decode_cross_attention(
        p_attn, cfg, z, {"k": cache["k"][i], "v": cache["v"][i]},
        impl=rt.attn_impl)


def decode_step(cfg: ModelConfig, rt: Runtime, p: Dict, token: torch.Tensor,
                pos: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """token: [B, 1] int; pos: next position to write — a 0-d tensor for
    lock-step batches, or per-sequence [B] for slot-pool decode
    (:data:`CAUSAL_CACHE_FAMILIES` only: the recurrent families have no
    position to index). Returns (logits [B,1,V], state), the state updated
    in place."""
    with tfm.runtime_ctx(rt):
        return _decode_step(cfg, rt, p, token, pos, state)


def _decode_step(cfg: ModelConfig, rt: Runtime, p: Dict, token: torch.Tensor,
                 pos: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    tfm.check_family(cfg)
    x = model_mod.embed(p, cfg, token)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    sgrp = seq_group(cfg, rt)
    if cfg.family in ("vlm", "encdec"):
        selfc, crossc = state["self"], state["cross"]
        if cfg.family == "vlm":
            k_in = cfg.cross_attn_every
            for g, p_cross in enumerate(p["layers"]["cross"]):
                for i in range(g * k_in, (g + 1) * k_in):
                    p_layer = p["layers"]["self"][i]
                    x = _self_decode(p_layer, cfg, rt, x,
                                     {n: t[i] for n, t in selfc.items()}, pos,
                                     sgrp)
                    x = x + tfm._ffn(p_layer, cfg, rt, x, decode=True)[0]
                ca = _cross_decode(p_cross["xattn"], p_cross["ln_x"], cfg,
                                   rt, x, crossc, g)
                x = tfm.vlm_cross_tail(p_cross, cfg, x, ca)
        else:
            for i, p_layer in enumerate(p["layers"]):
                x = _self_decode(p_layer, cfg, rt, x,
                                 {n: t[i] for n, t in selfc.items()}, pos,
                                 sgrp)
                x = x + _cross_decode(p_layer["xattn"], p_layer["ln_x"], cfg,
                                      rt, x, crossc, i)
                x = x + tfm._ffn(p_layer, cfg, rt, x, decode=True)[0]
        return model_mod.logits_fn(p, cfg, x), state
    layers = state["layers"]
    if cfg.family == "hybrid":
        for p_layer, cache, kind in zip(p["layers"], layers,
                                        tfm.hybrid_kinds(cfg)):
            z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            if kind == "attn":
                y, _ = attn.decode_self_attention(p_layer["attn"], cfg, z,
                                                  cache, pos,
                                                  impl=rt.decode_impl)
            else:
                y, _ = rglru_mod.rglru_decode_step(p_layer["rglru"], cfg, z,
                                                   cache)
            x = _hybrid_mlp(p_layer, cfg, x + y)
        return model_mod.logits_fn(p, cfg, x), state
    for i, p_layer in enumerate(p["layers"]):
        cache = {name: t[i] for name, t in layers.items()}
        if cfg.family == "ssm":
            z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            x = x + ssm_mod.ssd_decode_step(p_layer["ssm"], cfg, z, cache)[0]
            continue
        x = _self_decode(p_layer, cfg, rt, x, cache, pos, sgrp)
        x = x + tfm._ffn(p_layer, cfg, rt, x, decode=True)[0]
    return model_mod.logits_fn(p, cfg, x), state
