"""DeepSeek-V3 671B — MLA attention, 1 shared + 256 routed experts (top-8),
multi-token prediction. [arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # nominal (MLA replaces the classic KV path)
    d_ff=2048,               # per-expert FFN width
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    mtp_depth=1,
    rope_theta=1e4,
)
