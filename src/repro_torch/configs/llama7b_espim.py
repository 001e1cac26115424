"""LLaMA-7B — the paper's own benchmark model (Table III): 32L d_model=4096
32H (MHA) d_ff=11008 vocab=32000.  The PIM benchmarks prune its projection
matrices to 50-90% sparsity; the serving example runs it through
ESPIMLinear.  ``espim_quant="int8"`` is the serving deployment default:
narrow fixed-point value planes are the paper's own DRAM format, and the
int8 codes keep tiny-LM logits at cosine > 0.999 vs fp (tests/test_quant).
[arXiv:2302.13971]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama7b-espim",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e4,
    tie_embeddings=False,
    espim_sparsity=0.9,
    espim_quant="int8",
)
