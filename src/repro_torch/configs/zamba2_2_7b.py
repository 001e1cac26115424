"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32, MHA) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 stack + shared attention blocks.
[arXiv:2411.15242; hf]

Simplification noted in DESIGN.md: one shared attention+MLP block applied
every ``attn_every`` layers (the reference alternates two shared blocks with
per-application LoRA deltas).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_kernel=4,
    attn_every=6,
    activation="gelu",
    gated_mlp=True,
    rope_theta=1e4,
    tie_embeddings=True,
)
