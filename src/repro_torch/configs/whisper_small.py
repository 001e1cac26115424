"""whisper-small [audio] — 12L(dec)+12L(enc) d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865; enc-dec with conv frontend STUB (precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_seq=1500,
    learned_pos=True,
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)
