"""Trunk assembly for the dense and MoE families (GQA or MLA attention),
the SSM family (Mamba2's SSD blocks) and the hybrid family (RecurrentGemma's
pattern of RG-LRU and local-attention blocks).

The reference scans over layer parameters stacked on a leading axis (the
hybrid over stacked pattern groups, then the remainder layers); here the
layers are a Python list of per-layer parameter dicts in layer order and
the trunk is a loop over them — a hybrid layer ``i`` is of kind
``block_pattern[i % len(block_pattern)]``. The VLM and enc-dec families are
ROADMAP queue A item 4's remaining work and raise ``NotImplementedError``.
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
from repro_torch.models.common import (ParamMaker, gated_mlp,
                                       gated_mlp_params, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs orthogonal to the architecture config.

    ``attn_impl`` picks the prefill attention route: ``"kernel"`` sends the
    flash kernel's case on the card to the hand-written kernel,
    ``"plain"`` keeps it on the plain chunked loops."""
    tp: int = 1
    moe_impl: str = "local"       # dense | local
    decode_impl: str = "chunked"  # chunked | dense (single einsum)
    attn_impl: str = "kernel"     # kernel | plain


#: the families the port serves: dense and MoE (GQA or MLA attention), SSM
#: and hybrid RG-LRU
FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """The port serves :data:`FAMILIES`; VLM and enc-dec are still to
    port."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP queue A "
            f"item 4: the VLM and enc-dec families, with cross-attention); "
            f"the port serves the families {FAMILIES}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def decoder_layer_params(mk: ParamMaker, cfg: ModelConfig,
                         rt: Runtime) -> Dict:
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
                  window: int = 0) -> Tuple[torch.Tensor, float]:
    x = x + _mixer(p, cfg, rt, x, positions, window)
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
