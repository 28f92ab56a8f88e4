"""Analytic roofline terms of a model step from its configuration.

``memory_floor_s`` and ``model_flops`` are the reference's formulas,
copied: they read only the config and the chip spec. The reference's
extraction of flops, bytes and collective traffic from compiled XLA
artifacts has no counterpart yet (ROADMAP queue A item 7).
"""
from __future__ import annotations

from repro_torch.core.hardware import ChipSpec, H100_SXM


def memory_floor_s(cfg, shape, chips: int,
                   chip: ChipSpec = H100_SXM) -> float:
    """Idealized-fusion lower bound on the memory term: weight passes +
    residual-stream activation traffic + optimizer/cache state."""
    n_total = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_encoder_layers
    param_dev = n_total * 2 / chips                      # bf16, fully sharded
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / chips * \
            (16 if chips >= 256 else 1)                  # batch over data only
        act = 32 * L * tokens_dev * d * 2                # fwd+remat+bwd, bf16
        opt = n_total * 8 / chips * 3                    # m,v f32 r/w + grad
        return (3 * param_dev + opt + act) / chip.hbm_bw
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / chips * \
            (16 if chips >= 256 else 1)
        act = 10 * L * tokens_dev * d * 2
        return (param_dev + act) / chip.hbm_bw
    # decode: weights once + KV/state cache once
    active_dev = n_active * 2 / chips
    cache = 0.0
    if cfg.use_mla:
        cache = (shape.global_batch * shape.seq_len
                 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * cfg.n_layers * 2)
    elif cfg.family in ("dense", "moe", "vlm", "encdec"):
        hd = cfg.resolved_head_dim
        cache = (shape.global_batch * shape.seq_len * cfg.n_kv_heads * hd
                 * 2 * cfg.n_layers * 2)
    elif cfg.family == "hybrid":
        cache = (shape.global_batch * min(cfg.local_window, shape.seq_len)
                 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
                 * cfg.n_layers // 3 * 2)
    elif cfg.family == "ssm":
        d_in = cfg.ssm_expand * d
        cache = shape.global_batch * d_in * cfg.ssm_state * 4 * cfg.n_layers
    return (active_dev + cache / chips) / chip.hbm_bw


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode counts one
    token per sequence."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: forward-only, 1 token
