"""Trunk assembly for the dense and MoE families, with GQA or MLA
attention.

The reference scans over layer parameters stacked on a leading axis; here
the layers are a Python list of per-layer parameter dicts and the trunk is a
loop over them. The other families (SSM, hybrid RG-LRU, VLM, enc-dec) are
ROADMAP queue A item 4's remaining work and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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


#: the families the port serves, with GQA or MLA attention
FAMILIES = ("dense", "moe")


def check_family(cfg: ModelConfig) -> None:
    """The port serves the dense and MoE families; the others are still to
    port."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP queue A "
            f"item 4: SSM, hybrid, VLM and enc-dec families); the port "
            f"serves the families {FAMILIES}, with GQA or MLA attention")


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
# Homogeneous trunk
# ---------------------------------------------------------------------------
def trunk_params(mk: ParamMaker, cfg: ModelConfig, rt: Runtime,
                 n_layers: int) -> List[Dict]:
    return [decoder_layer_params(mk, cfg, rt) for _ in range(n_layers)]


def trunk_forward(params: List[Dict], cfg: ModelConfig, rt: Runtime, x,
                  positions) -> Tuple[torch.Tensor, float]:
    aux = 0.0
    for p_layer in params:
        x, a = decoder_layer(p_layer, cfg, rt, x, positions)
        aux += a
    return x, aux
