"""Trunk assembly for the dense family.

The reference scans over layer parameters stacked on a leading axis; here
the layers are a Python list of per-layer parameter dicts and the trunk is a
loop over them. The other families (MoE, MLA, SSM, hybrid RG-LRU, VLM,
enc-dec) are ROADMAP queue A item 1's remaining work and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamMaker, gated_mlp,
                                       gated_mlp_params, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Runtime knobs orthogonal to the architecture config.

    ``attn_impl`` picks the prefill attention route: ``"kernel"`` sends the
    flash kernel's case on the card to the hand-written kernel,
    ``"plain"`` keeps it on the plain chunked loops."""
    tp: int = 1
    decode_impl: str = "chunked"  # chunked | dense (single einsum)
    attn_impl: str = "kernel"     # kernel | plain


def check_family(cfg: ModelConfig) -> None:
    """The port serves the dense family; the others are still to port."""
    if cfg.family != "dense" or cfg.use_mla:
        what = "MLA attention" if cfg.use_mla else f"the {cfg.family!r} family"
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP queue A item 1: MoE, MLA, "
            f"SSM, hybrid, VLM and enc-dec families); the port serves dense "
            f"models")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def decoder_layer_params(mk: ParamMaker, cfg: ModelConfig,
                         rt: Runtime) -> Dict:
    check_family(cfg)
    return {"ln1": mk("ln1", (cfg.d_model,), init="ones"),
            "ln2": mk("ln2", (cfg.d_model,), init="ones"),
            "attn": attn.attention_params(mk, "attn", cfg, rt.tp),
            "mlp": gated_mlp_params(mk, "mlp", cfg.d_model, cfg.d_ff)}


def _mixer(p, cfg: ModelConfig, rt: Runtime, x, positions, window=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    return attn.self_attention(p["attn"], cfg, h, positions, window=window,
                               impl=rt.attn_impl)


def _ffn(p, cfg: ModelConfig, rt: Runtime,
         x) -> Tuple[torch.Tensor, float]:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
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
