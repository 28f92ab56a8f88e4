"""RecurrentGemma 2B — hybrid RG-LRU + local attention, pattern 2 recurrent :
1 attention, MQA kv=1, window 2048. [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    lru_width=2560,
    act="gelu",
    tie_embeddings=True,
    rope_theta=1e4,
)
