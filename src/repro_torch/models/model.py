"""Top-level model API, uniform across the families: dense, MoE, SSM,
hybrid, VLM and enc-dec.

    params        = init_params(cfg, rt, generator, device=...)
    logits        = forward_logits(cfg, rt, params, batch)
    state         = init_decode_state(cfg, rt, B, max_len)   # models.decode
    logits, state = prefill(cfg, rt, params, batch, max_len)
    logits, state = decode_step(cfg, rt, params, token, pos, state)

Parameters are plain dicts of tensors: ``emb [V, d]``, ``ln_f [d]``,
``unemb [d, V]`` (``V`` the padded vocab) and ``layers``, a list of per-layer
dicts (``ln1``, ``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``, biases} or
the MLA leaves {``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``,
``wk_b``, ``wv_b``, ``wo``}, ``mlp`` {``wi``, ``wg``, ``wo``} or the MoE
leaves {``router``, ``experts`` {``wi``, ``wg``, ``wo``}, ``shared``}) in the
reference's layouts, and for a config with ``mtp_depth`` the multi-token
prediction head ``mtp`` {``ln_h``, ``ln_e``, ``w_proj``, ``block``}, which
only training reads (ROADMAP queue A item 6). An SSM layer is {``ln1``,
``ssm`` {``w_in``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
``norm_g``, ``w_out``}}; a hybrid layer {``ln1``, ``ln2``, ``mlp``} with
``attn`` or ``rglru`` {``w_x``, ``w_gate``, ``conv_w``, ``conv_b``, ``w_a``,
``b_a``, ``w_i``, ``b_i``, ``lam``, ``w_out``} by its place in
``block_pattern``. A VLM's ``layers`` is ``{"self": [n_layers decoder
layers], "cross": [one cross block a group of cross_attn_every: ln_x,
ln_m, xattn {wq, wk, wv, wo}, gate_a, gate_m, mlp]}``; an enc-dec's
``encoder`` is a list of ``n_encoder_layers`` layers and its ``layers``
decoder layers that also hold ``ln_x`` and ``xattn``. Those two families
read ``batch["frontend"] [B, F, d]``, the precomputed patch or frame
embeddings. Logits span the padded vocab, as in the reference; callers
slice ``[..., :vocab_size]``.
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
    if cfg.family == "ssm":
        p["layers"] = tfm.trunk_params(mk, cfg, rt, cfg.n_layers, "ssm")
    elif cfg.family == "hybrid":
        p["layers"] = tfm.hybrid_params(mk, cfg, rt)
    elif cfg.family == "vlm":
        p["layers"] = tfm.vlm_params(mk, cfg, rt)
    elif cfg.family == "encdec":
        p["encoder"] = [tfm.encoder_layer_params(mk, cfg, rt)
                        for _ in range(cfg.n_encoder_layers)]
        p["layers"] = [tfm.decoder_layer_params(mk, cfg, rt, cross=True)
                       for _ in range(cfg.n_layers)]
    else:
        p["layers"] = tfm.trunk_params(mk, cfg, rt, cfg.n_layers, "decoder")
    if cfg.mtp_depth:
        p["mtp"] = {
            "ln_h": mk("mtp.ln_h", (d,), init="ones"),
            "ln_e": mk("mtp.ln_e", (d,), init="ones"),
            "w_proj": mk("mtp.w_proj", (2 * d, d)),
            "block": tfm.decoder_layer_params(mk, cfg, rt),
        }
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
    x = p["emb"][tokens.long()]
    if cfg.family == "hybrid":
        # gemma-style embedding scale, rounded to the embedding dtype first
        # as the reference does (sqrt(2560) = 50.596 is 50.5 in bf16)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


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
    aux = 0.0
    if cfg.family == "hybrid":
        x = tfm.hybrid_forward(p["layers"], cfg, rt, x, pos)
    elif cfg.family == "vlm":
        x = tfm.vlm_forward(p["layers"], cfg, rt, x, pos, batch["frontend"])
    elif cfg.family == "encdec":
        memory = tfm.encoder_forward(p["encoder"], cfg, rt, batch["frontend"])
        x, aux = _encdec_decoder(p, cfg, rt, x, pos, memory)
    else:
        x, aux = tfm.trunk_forward(p["layers"], cfg, rt, x, pos,
                                   "ssm" if cfg.family == "ssm" else "decoder")
    return x, aux, inputs


def _encdec_decoder(p: Dict, cfg: ModelConfig, rt: Runtime, x, pos, memory):
    """The enc-dec decoder over ``x``, each layer also attending to
    ``memory``: (hidden, aux loss)."""
    aux = 0.0
    for p_layer in p["layers"]:
        x, a = tfm.decoder_layer(p_layer, cfg, rt, x, pos, memory=memory)
        aux += a
    return x, aux


def forward_logits(cfg: ModelConfig, rt: Runtime, p: Dict,
                   batch: Dict) -> torch.Tensor:
    """Full-sequence logits (small configs / tests only)."""
    h, _, _ = trunk_hidden(cfg, rt, p, batch)
    return logits_fn(p, cfg, h)
