"""DBRX 132B — 16-expert top-4 fine-grained MoE, GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,              # per-expert FFN width
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    rope_theta=5e5,
)
