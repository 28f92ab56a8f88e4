"""Model/architecture configuration schema.

One ``ModelConfig`` covers every assigned architecture family:
dense / MoE / MLA / SSM (Mamba2) / hybrid (RG-LRU) / enc-dec / VLM.
Configs are frozen dataclasses so they hash and can key compile caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # --- trunk --------------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"            # silu | gelu  (gated MLP in both cases)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    router_aux_coef: float = 0.001
    # --- MLA (deepseek-v3) ----------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0           # multi-token-prediction extra depth
    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_n_groups: int = 1
    # --- hybrid (recurrentgemma) ----------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    local_window: int = 0
    lru_width: int = 0
    # --- enc-dec ----------------------------------------------------------------
    n_encoder_layers: int = 0
    # --- multimodal stub frontend ----------------------------------------------
    cross_attn_every: int = 0    # insert cross-attn layer every k trunk layers
    frontend_seq: int = 0        # precomputed patch/frame embedding length
    # --- numerics / padding ------------------------------------------------------
    dtype: str = "bfloat16"
    pad_vocab_multiple: int = 256

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def padded_vocab(self, tp: int = 16) -> int:
        v = _round_up(self.vocab_size, self.pad_vocab_multiple)
        return _round_up(v, tp)

    def padded_heads(self, tp: int = 16) -> int:
        """Q heads padded up so they shard over the model axis (exactness via
        zeroed W_O rows)."""
        if self.n_heads == 0 or self.n_heads % tp == 0:
            return self.n_heads
        if tp % self.n_heads == 0:
            return self.n_heads  # replicated instead (small models)
        return _round_up(self.n_heads, tp)

    def padded_kv_heads(self, tp: int = 16) -> int:
        nh, nkv = self.padded_heads(tp), self.n_kv_heads
        if nkv == 0:
            return 0
        if nkv % tp == 0:
            return nkv
        if self.n_heads % tp != 0 and self.n_heads != nh:
            # q heads were padded: keep the group ratio integral
            ratio = max(1, self.n_heads // nkv)
            if nh % ratio == 0 and (nh // ratio) % tp == 0:
                return nh // ratio
        return nkv  # replicated at runtime

    # --- parameter counting (roofline MODEL_FLOPS = 6*N*D) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count from the config (embedding included).

        ``active_only`` counts only top-k routed experts (for MoE
        MODEL_FLOPS = 6 * N_active * D per assignment).
        """
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.use_mla:
                q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_dim)
                kv += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                return q + kv + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated (wi, wg, wo)

        if self.family == "ssm":
            d_in = self.ssm_expand * d
            per = (d * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_state
                        + d_in // self.ssm_head_dim)
                   + d_in * d + self.ssm_conv_kernel * (
                       d_in + 2 * self.ssm_n_groups * self.ssm_state))
            return emb + L * per

        if self.family == "hybrid":
            pat = self.block_pattern or ("attn",)
            n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "attn")
            n_rec = L - n_attn
            lru = self.lru_width or d
            rec = (2 * d * lru + 2 * lru * lru // 1 + lru * d)  # gates + proj
            per_mlp = mlp_params(self.d_ff)
            return emb + n_attn * (attn_params() + per_mlp) + n_rec * (rec + per_mlp)

        if self.family in ("moe",):
            routed = self.n_experts * mlp_params(self.d_ff)
            shared = self.n_shared_experts * mlp_params(self.d_ff)
            router = d * self.n_experts
            per = attn_params() + routed + shared + router
            total = emb + L * per
            if active_only:
                act_moe = (self.experts_per_token * mlp_params(self.d_ff)
                           + shared + router)
                total = emb + L * (attn_params() + act_moe)
            return total

        # dense / encdec / vlm trunks
        per = attn_params() + mlp_params(self.d_ff)
        total = emb + L * per
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += L * attn_params()  # decoder cross-attention
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            total += n_cross * (attn_params() + mlp_params(self.d_ff))
        return total

    # --- smoke-test scaling ----------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern
        # hybrid: one full pattern group + 2 remainder layers, so both the
        # grouped-scan and the unrolled-remainder paths are exercised
        n_layers = (len(pat) + 2) if pat else 2
        if self.family == "encdec":
            n_layers = 2
        updates = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16 if self.n_heads else 0,
            pad_vocab_multiple=16,
        )
        if self.n_experts:
            updates.update(n_experts=4,
                           experts_per_token=min(2, self.experts_per_token),
                           n_shared_experts=min(1, self.n_shared_experts))
        if self.use_mla:
            updates.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16, head_dim=0)
        if self.mtp_depth:
            updates.update(mtp_depth=1)
        if self.family == "ssm":
            updates.update(ssm_state=16, ssm_head_dim=16, n_heads=0,
                           n_kv_heads=0, d_ff=0, head_dim=0)
        if self.family == "hybrid":
            updates.update(lru_width=64, local_window=32,
                           n_kv_heads=1, head_dim=16)
        if self.family == "encdec":
            updates.update(n_encoder_layers=2)
        if self.cross_attn_every:
            updates.update(cross_attn_every=1)  # 2 groups of (1 self + cross)
        if self.frontend_seq:
            updates.update(frontend_seq=8)
        return dataclasses.replace(self, **updates)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch, plus which step it
    lowers: train_step / prefill serve_step / single-token decode step)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 128),
                           min(self.global_batch, 4), self.kind)


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# Families with sub-quadratic sequence mixing (eligible for long_500k).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue  # pure full-attention: quadratic at 500k tokens
        out.append(s)
    return tuple(out)
