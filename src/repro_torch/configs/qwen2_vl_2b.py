"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE + dynamic resolution (vision frontend is a stub:
precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
