"""Llama 3.2 Vision 11B — dense text trunk with cross-attention image layers
every 5th layer; vision frontend is a precomputed-patch-embedding stub per the
assignment. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    frontend_seq=1600,       # precomputed image patch embeddings
    rope_theta=5e5,
)
