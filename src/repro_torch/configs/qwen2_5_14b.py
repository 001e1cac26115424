"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family; hf]

Note: 40 heads do not divide the 16-way model axis; QKV projections shard
on the flat feature dim (5120 % 16 == 0) and XLA re-shards attention
internals (see DESIGN.md sharding notes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e6,
    tie_embeddings=False,
)
