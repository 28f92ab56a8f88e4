"""SeamlessM4T-large v2 — encoder-decoder multimodal backbone; audio frontend
is a precomputed-frame-embedding stub per the assignment.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,             # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend_seq=4096,       # encoder audio-frame embeddings (stub)
    act="gelu",
    rope_theta=1e4,
)
