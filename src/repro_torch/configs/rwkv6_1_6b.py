"""rwkv6-1.6b "Finch" [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; data-dependent decay.  [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # 2048 / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    activation="relu2",
    gated_mlp=False,
    tie_embeddings=True,
)
