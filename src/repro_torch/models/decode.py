"""Serving substrate for the dense and MoE families: decode-state
construction, prefill, single-token decode.

The state mirrors the reference's layout, stacked over layers:
``{"layers": {"k": [L, B, M, Hkv, hd], "v": [L, B, M, Hkv, hd]}}``, or for
MLA the latent cache ``{"layers": {"c_kv": [L, B, M, kv_lora_rank],
"k_rope": [L, B, M, qk_rope_dim]}}``, in bf16 for bf16 configs (f32
otherwise). :func:`decode_step` writes each layer's new
row into those tensors in place and returns the same dict; the reference
returns a new pytree (its jitted callers donate the old one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import as_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import Runtime

#: families whose decode state is a position-indexed cache, so padding past a
#: sequence's true length is recoverable (masked at read time)
CAUSAL_CACHE_FAMILIES = ("dense", "moe", "vlm", "encdec")


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_decode_state(cfg: ModelConfig, rt: Runtime, batch: int,
                      max_len: int, device=None) -> Dict:
    """Zeroed KV cache for ``batch`` sequences of up to ``max_len`` tokens
    on ``device`` (default: the card)."""
    tfm.check_family(cfg)
    L, dev, dt = cfg.n_layers, as_device(device), _cache_dtype(cfg)
    if cfg.use_mla:
        shapes = {"c_kv": (L, batch, max_len, cfg.kv_lora_rank),
                  "k_rope": (L, batch, max_len, cfg.qk_rope_dim)}
    else:
        kv = (L, batch, max_len, cfg.padded_kv_heads(rt.tp),
              cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    return {"layers": {name: torch.zeros(shape, dtype=dt, device=dev)
                       for name, shape in shapes.items()}}


def prefill(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict,
            max_len: int, lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt through the trunk, building the decode state.
    Returns (last-token logits [B,1,V], state).

    ``lengths`` ([B] int) gives each sequence's true prompt length within
    the right-padded ``tokens``: logits are then read at position
    ``lengths[b]-1`` per sequence instead of the batch max (causal attention
    keeps positions < length clean; the pad rows the cache still holds are
    masked later by per-sequence decode positions)."""
    tfm.check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = model_mod.embed(p, cfg, tokens)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    state = init_decode_state(cfg, rt, B, max_len, device=x.device)
    caches = list(state["layers"].values())   # (k, v) or (c_kv, k_rope)
    for i, p_layer in enumerate(p["layers"]):
        z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            y, rows = attn.mla_attention(p_layer["attn"], cfg, z, pos,
                                         return_cache=True,
                                         impl=rt.attn_impl)
        else:
            y, rows = attn.self_attention(p_layer["attn"], cfg, z, pos,
                                          return_cache=True,
                                          impl=rt.attn_impl)
        for cache, r in zip(caches, rows):
            cache[i, :, :S] = r
        x = x + y
        y2, _ = tfm._ffn(p_layer, cfg, rt, x)
        x = x + y2

    if lengths is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(lengths, device=x.device).long() - 1
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
    return model_mod.logits_fn(p, cfg, x_last), state


def decode_step(cfg: ModelConfig, rt: Runtime, p: Dict, token: torch.Tensor,
                pos: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """token: [B, 1] int; pos: next position to write — a 0-d tensor for
    lock-step batches, or per-sequence [B] for slot-pool decode. Returns
    (logits [B,1,V], state), the state updated in place."""
    tfm.check_family(cfg)
    x = model_mod.embed(p, cfg, token)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    layers = state["layers"]
    for i, p_layer in enumerate(p["layers"]):
        z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
        cache = {name: t[i] for name, t in layers.items()}
        if cfg.use_mla:
            y, _ = attn.mla_decode(p_layer["attn"], cfg, z, cache, pos)
        else:
            y, _ = attn.decode_self_attention(p_layer["attn"], cfg, z, cache,
                                              pos, impl=rt.decode_impl)
        x = x + y
        y2, _ = tfm._ffn(p_layer, cfg, rt, x, decode=True)
        x = x + y2
    return model_mod.logits_fn(p, cfg, x), state
