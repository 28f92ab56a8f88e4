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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamMaker, apply_rope, gated_mlp,
                                       gated_mlp_params, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs orthogonal to the architecture config.

    ``attn_impl`` picks the route of the attention the flash kernel
    computes (prefill, and cross-attention at decode): ``"kernel"`` sends
    the kernel's case on the card to the hand-written kernel, ``"plain"``
    keeps it on the plain chunked loops."""
    tp: int = 1
    moe_impl: str = "local"       # dense | local
    decode_impl: str = "chunked"  # chunked | dense (single einsum)
    attn_impl: str = "kernel"     # kernel | plain


#: the families the port serves: dense and MoE (GQA or MLA attention), SSM,
#: hybrid RG-LRU, VLM and enc-dec
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """``ValueError`` for a family outside :data:`FAMILIES`, as the
    reference raises for one."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def decoder_layer_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime,
                         cross: bool = False) -> Dict:
    """One decoder layer; ``cross`` adds the enc-dec decoder's
    cross-attention (``ln_x``, ``xattn``)."""
    check_family(cfg)
    p = {"ln1": mk("ln1", (cfg.d_model,), init="ones"),
         "ln2": mk("ln2", (cfg.d_model,), init="ones")}
    if cfg.use_mla:
        p["attn"] = attn.mla_params(mk, "attn", cfg, rt.tp)
    else:
        p["attn"] = attn.attention_params(mk, "attn", cfg, rt.tp)
    if cfg.family == "moe":
        p["mlp"] = moe_mod.moe_params(mk, "moe", cfg, rt.tp)
    else:
        p["mlp"] = gated_mlp_params(mk, "mlp", cfg.d_model, cfg.d_ff)
    if cross:
        p["ln_x"] = mk("ln_x", (cfg.d_model,), init="ones")
        p["xattn"] = attn.attention_params(mk, "xattn", cfg, rt.tp,
                                           cross=True)
    return p


def _mixer(p, cfg: ModelConfig, rt: Runtime, x, positions, window=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        return attn.mla_attention(p["attn"], cfg, h, positions,
                                  impl=rt.attn_impl)
    return attn.self_attention(p["attn"], cfg, h, positions, window=window,
                               impl=rt.attn_impl)


def _ffn(p, cfg: ModelConfig, rt: Runtime, x, decode: bool = False
         ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """The layer's FFN on ``rms_norm(x)``: (output, aux loss). The MoE aux
    loss is a 0-d tensor; a dense FFN's is 0.0."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_block(p["mlp"], cfg, h, impl=rt.moe_impl,
                                 decode=decode)
    return gated_mlp(p["mlp"], h, cfg.act), 0.0


def decoder_layer(p, cfg: ModelConfig, rt: Runtime, x, positions,
                  window: int = 0, memory=None) -> Tuple[torch.Tensor, float]:
    x = x + _mixer(p, cfg, rt, x, positions, window)
    if memory is not None and "xattn" in p:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], cfg, h, memory,
                                     impl=rt.attn_impl)
    y, aux = _ffn(p, cfg, rt, x)
    return x + y, aux


# ---------------------------------------------------------------------------
# Homogeneous trunks (dense / moe decoder, ssm)
# ---------------------------------------------------------------------------
def _ssm_layer_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime) -> Dict:
    return {"ln1": mk("ln1", (cfg.d_model,), init="ones"),
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
    aux = 0.0
    for p_layer in params:
        if kind == "ssm":
            z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
            x = x + ssm_mod.ssd_forward(p_layer["ssm"], cfg, z)
        else:
            x, a = decoder_layer(p_layer, cfg, rt, x, positions)
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
    non-causal (on the card the flash kernel's case), then its FFN."""
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    for p_layer in params:
        z = rms_norm(x, p_layer["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(p_layer["attn"], z)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn.chunked_attention(q, k, v, causal=False, impl=rt.attn_impl)
        x = x + attn._out_proj(o, p_layer["attn"]["wo"])
        y, _ = _ffn(p_layer, cfg, rt, x)
        x = x + y
    return x


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
    p = {"ln1": mk("ln1", (cfg.d_model,), init="ones"),
         "ln2": mk("ln2", (cfg.d_model,), init="ones"),
         "mlp": gated_mlp_params(mk, "mlp", cfg.d_model, cfg.d_ff)}
    if kind == "attn":
        p["attn"] = attn.attention_params(mk, "attn", cfg, rt.tp)
    else:
        p["rglru"] = rglru_mod.rglru_params(mk, "rglru", cfg, rt.tp)
    return p


def hybrid_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime
                  ) -> List[Dict]:
    return [_rg_block_params(mk, cfg, rt, kind) for kind in hybrid_kinds(cfg)]


def _rg_block(p, cfg: ModelConfig, rt: Runtime, x, positions, kind: str):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        x = x + attn.self_attention(p["attn"], cfg, h, positions,
                                    window=cfg.local_window,
                                    impl=rt.attn_impl)
    else:
        x = x + rglru_mod.rglru_forward(p["rglru"], cfg, h)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h, cfg.act)


def hybrid_forward(params: List[Dict], cfg: ModelConfig, rt: Runtime, x,
                   positions) -> torch.Tensor:
    for p, kind in zip(params, hybrid_kinds(cfg)):
        x = _rg_block(p, cfg, rt, x, positions, kind)
    return x


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
    cross = [{"ln_x": mk("ln_x", (d,), init="ones"),
              "ln_m": mk("ln_m", (d,), init="ones"),
              "xattn": attn.attention_params(mk, "xattn", cfg, rt.tp,
                                             cross=True),
              "gate_a": mk("gate_a", (1,), init="zeros"),
              "gate_m": mk("gate_m", (1,), init="zeros"),
              "mlp": gated_mlp_params(mk, "xmlp", d, cfg.d_ff)}
             for _ in range(n_groups)]
    return {"self": trunk_params(mk, cfg, rt,
                                 n_groups * cfg.cross_attn_every, "decoder"),
            "cross": cross}


def vlm_cross_tail(p: Dict, cfg: ModelConfig, x, ca) -> torch.Tensor:
    """The rest of a VLM cross block after its cross-attention output
    ``ca``: ``x + tanh(gate_a) ca``, then ``+ tanh(gate_m)`` times the
    block's gated MLP of ``rms_norm(., ln_m)``."""
    x = x + torch.tanh(p["gate_a"]) * ca
    z = rms_norm(x, p["ln_m"], cfg.norm_eps)
    return x + torch.tanh(p["gate_m"]) * gated_mlp(p["mlp"], z, cfg.act)


def vlm_forward(params: Dict, cfg: ModelConfig, rt: Runtime, x, positions,
                memory) -> torch.Tensor:
    k = cfg.cross_attn_every
    for g, p_cross in enumerate(params["cross"]):
        for p_layer in params["self"][g * k:(g + 1) * k]:
            x, _ = decoder_layer(p_layer, cfg, rt, x, positions)
        z = rms_norm(x, p_cross["ln_x"], cfg.norm_eps)
        ca = attn.cross_attention(p_cross["xattn"], cfg, z, memory,
                                  impl=rt.attn_impl)
        x = vlm_cross_tail(p_cross, cfg, x, ca)
    return x
