"""Top-level model API, uniform across the families: dense, MoE, SSM,
hybrid, VLM and enc-dec.

    params        = init_params(cfg, rt, generator, device=...)
    loss, metrics = loss_fn(cfg, rt, params, batch)          # training
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
only training reads (:func:`loss_fn`). An SSM layer is {``ln1``,
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

Under a mesh (``Runtime.mesh``, or :func:`~repro_torch.models.common.
sharding_ctx`) each rank holds the shards :func:`param_specs` gives it and
the entry points run on them: the embedding and the unembedding split the
padded vocab over ``model`` (a token outside this rank's rows embeds to
zero and the ranks' rows are summed; the loss reduces the max, the sum of
exponentials and the target logit over ``model``; serving's logits are
gathered whole), the layers split their heads, ffn columns and experts
(:mod:`~repro_torch.models.attention`, :mod:`~repro_torch.models.moe`),
and the loss's numerator and label count are summed over the batch's ranks,
so every rank holds the loss of the whole batch. Under the rule ``seq ->
model`` (sequence parallelism) the training path keeps each rank's rows of
the sequence from the embedding (its vocab sum reduce-scattered) to the
final norm, and gathers them whole for the vocab-split loss; the norms'
gains and MTP's weights, applied to a rank's rows only, enter through
``copy_to`` over the sequence's group (their gradients summed there).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import as_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ParamMaker, ShardingRules, axis_group,
                                       default_rules, enter, leave, rms_norm,
                                       seq_split, shard)
from repro_torch.models.transformer import Runtime, runtime_ctx
from repro_torch.parallel import collectives as coll

CE_CHUNK = 512


def _build(mk: ParamMaker, cfg: ModelConfig, rt: Runtime) -> Dict:
    tfm.check_family(cfg)
    V = cfg.padded_vocab(rt.tp)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "emb": mk("emb", (V, d), ("vocab", "dmodel"), scale=0.02),
        "ln_f": mk("ln_f", (d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        p["unemb"] = mk("unemb", (d, V), ("dmodel", "vocab"),
                        scale=d ** -0.5)
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
            "ln_h": mk("mtp.ln_h", (d,), (None,), init="ones"),
            "ln_e": mk("mtp.ln_e", (d,), (None,), init="ones"),
            "w_proj": mk("mtp.w_proj", (2 * d, d), (None, "dmodel")),
            "block": tfm.decoder_layer_params(mk, cfg, rt),
        }
    return p


def init_params(cfg: ModelConfig, rt: Runtime,
                generator: Optional[torch.Generator] = None,
                device=None, seed: int = 0,
                rules: Optional[ShardingRules] = None) -> Dict:
    """Random parameters in ``cfg.dtype`` on ``device`` (default: the
    mesh's device under ``rt.mesh``, else the card), drawn from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``). Under ``rt.mesh`` each leaf is drawn whole and this rank
    keeps its shard under ``rules`` (default: :func:`default_rules` of the
    mesh), so every mesh cuts the same parameters from one seed. The
    reference also returns the PartitionSpec tree; here that is
    :func:`param_specs`. On the ``meta`` device nothing is drawn."""
    mesh = rt.mesh
    dev = as_device(device if device is not None or mesh is None
                    else mesh.device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    if mesh is not None and rules is None:
        rules = default_rules("pod" in mesh.axis_names)
    return _build(ParamMaker(generator, cfg.dtype, dev, rules=rules,
                             mesh=mesh), cfg, rt)


def param_specs(cfg: ModelConfig, rt: Runtime,
                rules: Optional[ShardingRules] = None) -> Dict:
    """The PartitionSpec of every leaf of :func:`init_params`' tree, in the
    same structure, under ``rules`` (default: :func:`default_rules`)."""
    return _build(ParamMaker(None, cfg.dtype, spec_mode=True,
                             rules=rules or default_rules()), cfg, rt)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(p: Dict, cfg: ModelConfig, tokens: torch.Tensor,
          seq=None) -> torch.Tensor:
    """The tokens' rows of ``emb``; under a vocab split over ``model``,
    each rank looks up the tokens of its own rows and the ranks' rows are
    summed. ``seq`` (the training trunks under the rule ``seq``): the sum
    is a reduce-scatter, and the result this rank's positions."""
    grp = axis_group("vocab")
    if grp is None:
        x = p["emb"][tokens.long()]
    else:
        rows = p["emb"].shape[0]
        t = tokens.long() - coll.rank(grp) * rows
        mine = (t >= 0) & (t < rows)
        x = p["emb"][torch.where(mine, t, 0)].masked_fill(
            ~mine[..., None], 0)
    x = leave(x, grp, seq)
    if cfg.family == "hybrid":
        # gemma-style embedding scale, rounded to the embedding dtype first
        # as the reference does (sqrt(2560) = 50.596 is 50.5 in bf16)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return shard(x, "batch", None if seq is None else "seq", None,
                 full=(None, tokens.shape[1], cfg.d_model))


def _unemb_w(p: Dict, cfg: ModelConfig) -> torch.Tensor:
    return p["emb"].T if cfg.tie_embeddings else p["unemb"]


def _final_norm(p: Dict, cfg: ModelConfig, h: torch.Tensor, grp, seq=None):
    """``rms_norm(h, ln_f)`` as the vocab-split head reads it
    (:func:`~repro_torch.models.common.enter`): under a sequence split
    normed on this rank's rows, then gathered whole."""
    return enter(rms_norm(h, coll.copy_to(p["ln_f"], seq), cfg.norm_eps),
                 grp, seq)


def logits_fn(p: Dict, cfg: ModelConfig, h: torch.Tensor,
              seq=None) -> torch.Tensor:
    """Logits over the padded vocab (gathered whole under a vocab split;
    ``seq``: ``h`` is this rank's rows, the logits every row's)."""
    grp = axis_group("vocab")
    h = _final_norm(p, cfg, h, grp, seq)
    return coll.gather_from(h @ _unemb_w(p, cfg), -1, grp)


def _ce_chunk(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor,
              grp=None):
    """(sum of the NLL over the valid labels, their count) of one chunk;
    the gold logit gathered, which is the reference's one-hot contraction
    exactly. Under a vocab split (``grp``, ``w`` this rank's columns) the
    max, the sum of exponentials and the gold logit are reduced over the
    ranks."""
    logits = (hc @ w).float()
    lab = torch.clamp(lc, min=0).long()
    if grp is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    else:
        cols = logits.shape[-1]
        m = coll.all_reduce(logits.detach().amax(dim=-1), grp, op="max")
        se = coll.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                              grp)
        lse = m + torch.log(se)
        t = lab - coll.rank(grp) * cols
        mine = (t >= 0) & (t < cols)
        gold = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])
        gold = coll.reduce_from(gold[..., 0].masked_fill(~mine, 0.0), grp)
    mask = (lc >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def lm_loss(p: Dict, cfg: ModelConfig, h: torch.Tensor,
            labels: torch.Tensor, seq=None) -> torch.Tensor:
    """Chunked cross-entropy over the padded vocab: chunks of
    :data:`CE_CHUNK` tokens (halved until they divide S), each chunk's
    logits recomputed in the backward (``torch.utils.checkpoint``), so
    ``[B, S, V]`` is never materialised whole. Under a mesh the sums run
    over the vocab's ranks (:func:`_ce_chunk`) and the batch's, so the
    mean is the whole batch's. ``seq``: ``h`` is this rank's rows of a
    sequence split, normed there and gathered whole (``gather_to``) before
    the vocab-split CE, so ``labels`` (every position's) line up."""
    grp = axis_group("vocab")
    h = _final_norm(p, cfg, h, grp, seq)
    S = h.shape[1]
    w = _unemb_w(p, cfg)
    c = CE_CHUNK
    while S % c:
        c //= 2
    tot = cnt = 0.0
    for i in range(0, S, c):
        t, n = ckpt.checkpoint(_ce_chunk, h[:, i:i + c], labels[:, i:i + c],
                               w, grp, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    bgrp = axis_group("batch")
    if bgrp is not None:
        tot, cnt = coll.reduce_both(tot, bgrp), coll.all_reduce(cnt, bgrp)
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None]


def trunk_hidden(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict,
                 inputs: Optional[torch.Tensor] = None):
    """Returns (hidden, aux_loss, inputs). ``inputs`` defaults to the
    teacher-forcing slice tokens[:, :-1]. Under the rule ``seq`` (sequence
    parallelism, the reference's ``--seq-shard``) the hidden state is this
    rank's rows of the sequence (:func:`~repro_torch.models.common.
    seq_split`): the embedding's vocab sum is reduce-scattered onto them,
    and every trunk keeps them so."""
    tfm.check_family(cfg)
    tokens = batch["tokens"]
    if inputs is None:
        inputs = tokens[:, :-1]
    S = inputs.shape[1]
    x = embed(p, cfg, inputs, seq=seq_split(S))
    pos = _positions(S, x.device)
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
    ``memory``: (hidden, aux loss). Under the rule ``seq`` ``x`` and the
    hidden state are this rank's rows (``memory`` is whole)."""
    S = pos.shape[-1]
    seq = seq_split(S)

    def body(x, p_layer):
        x, a = tfm.decoder_layer(p_layer, cfg, rt, tfm.residual(x, S), pos,
                                 memory=memory, seq=seq)
        return tfm.residual(x, S), a

    body = tfm._maybe_remat(body, rt)
    aux = 0.0
    for p_layer in p["layers"]:
        x, a = body(x, p_layer)
        aux += a
    return x, aux


def loss_fn(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """``(total, metrics)``: total = CE + ``router_aux_coef`` * aux, plus
    ``rt.mtp_coef`` times the multi-token-prediction loss for a config with
    ``mtp_depth``; metrics ``ce``, ``aux``, ``mtp`` (where there is one) and
    ``loss``, each a 0-d tensor. ``batch["tokens"]`` is ``[B, S + 1]``
    (under a mesh: this rank's rows)."""
    with runtime_ctx(rt):
        return _loss_fn(cfg, rt, p, batch)


def _loss_fn(cfg: ModelConfig, rt: Runtime, p: Dict, batch: Dict
             ) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    h, aux, inputs = trunk_hidden(cfg, rt, p, batch)
    S = inputs.shape[1]
    seq = seq_split(S)
    loss = lm_loss(p, cfg, h, labels, seq)
    if not isinstance(aux, torch.Tensor):
        aux = loss.new_tensor(aux)
    metrics = {"ce": loss, "aux": aux}
    total = loss + cfg.router_aux_coef * aux
    if cfg.mtp_depth and "mtp" in p:
        mtp = p["mtp"]
        # predict t+2: combine h_t with emb(x_{t+1}); keep the length S and
        # mask the trailing position in the loss (under the rule seq, on
        # this rank's rows, as the trunk left them)
        h_in = rms_norm(h, coll.copy_to(mtp["ln_h"], seq), cfg.norm_eps)
        e_next = F.pad(inputs[:, 1:], (0, 1))
        e_in = rms_norm(embed(p, cfg, e_next, seq),
                        coll.copy_to(mtp["ln_e"], seq), cfg.norm_eps)
        z = (torch.cat([h_in, e_in], dim=-1)
             @ coll.copy_to(mtp["w_proj"], seq))
        z, _ = tfm.decoder_layer(mtp["block"], cfg, rt, z,
                                 _positions(S, z.device), seq=seq)
        mtp_labels = F.pad(labels[:, 1:], (0, 1), value=-1)
        mtp_loss = lm_loss(p, cfg, z, mtp_labels, seq)
        metrics["mtp"] = mtp_loss
        total = total + rt.mtp_coef * mtp_loss
    metrics["loss"] = total
    return total, metrics


def forward_logits(cfg: ModelConfig, rt: Runtime, p: Dict,
                   batch: Dict) -> torch.Tensor:
    """Full-sequence logits (small configs / tests only)."""
    with runtime_ctx(rt):
        h, _, inputs = trunk_hidden(cfg, rt, p, batch)
        return logits_fn(p, cfg, h, seq_split(inputs.shape[1]))
