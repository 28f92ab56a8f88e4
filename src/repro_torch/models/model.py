"""Top-level model API for the dense family.

    params        = init_params(cfg, rt, generator, device=...)
    logits        = forward_logits(cfg, rt, params, batch)
    state         = init_decode_state(cfg, rt, B, max_len)   # models.decode
    logits, state = prefill(cfg, rt, params, batch, max_len)
    logits, state = decode_step(cfg, rt, params, token, pos, state)

Parameters are plain dicts of tensors: ``emb [V, d]``, ``ln_f [d]``,
``unemb [d, V]`` (``V`` the padded vocab) and ``layers``, a list of per-layer
dicts (``ln1``, ``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``, biases},
``mlp`` {``wi``, ``wg``, ``wo``}) in the reference's layouts. Logits span the
padded vocab, as in the reference; callers slice ``[..., :vocab_size]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import as_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamMaker, rms_norm
from repro_torch.models.transformer import Runtime


def _build(mk: ParamMaker, cfg: ModelConfig, rt: Runtime) -> Dict:
    tfm.check_family(cfg)
    V = cfg.padded_vocab(rt.tp)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "emb": mk("emb", (V, d), scale=0.02),
        "ln_f": mk("ln_f", (d,), init="ones"),
    }
    if not cfg.tie_embeddings:
        p["unemb"] = mk("unemb", (d, V), scale=d ** -0.5)
    p["layers"] = tfm.trunk_params(mk, cfg, rt, cfg.n_layers)
    return p


def init_params(cfg: ModelConfig, rt: Runtime,
                generator: Optional[torch.Generator] = None,
                device=None, seed: int = 0) -> Dict:
    """Random parameters in ``cfg.dtype`` on ``device`` (default: the
    card), drawn from ``generator`` (default: a generator on ``device``
    seeded with ``seed``). The reference also returns a PartitionSpec tree;
    one card has no mesh, so the port returns the parameters alone."""
    dev = as_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return _build(ParamMaker(generator, cfg.dtype, dev), cfg, rt)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(p: Dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["emb"][tokens.long()]


def _unemb_w(p: Dict, cfg: ModelConfig) -> torch.Tensor:
    return p["emb"].T if cfg.tie_embeddings else p["unemb"]


def logits_fn(p: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, p["ln_f"], cfg.norm_eps)
    return h @ _unemb_w(p, cfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None]


def trunk_hidden(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict,
                 inputs: Optional[torch.Tensor] = None):
    """Returns (hidden, aux_loss, inputs). ``inputs`` defaults to the
    teacher-forcing slice tokens[:, :-1]."""
    tfm.check_family(cfg)
    tokens = batch["tokens"]
    if inputs is None:
        inputs = tokens[:, :-1]
    x = embed(p, cfg, inputs)
    pos = _positions(x.shape[1], x.device)
    x, aux = tfm.trunk_forward(p["layers"], cfg, rt, x, pos)
    return x, aux, inputs


def forward_logits(cfg: ModelConfig, rt: Runtime, p: Dict,
                   batch: Dict) -> torch.Tensor:
    """Full-sequence logits (small configs / tests only)."""
    h, _, _ = trunk_hidden(cfg, rt, p, batch)
    return logits_fn(p, cfg, h)
