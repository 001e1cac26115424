"""Config dataclasses: model architecture + input-shape cells.

Every assigned architecture is a ``ModelConfig``; the four assigned input
shapes are ``ShapeConfig``s.  ``smoke(cfg)`` derives the reduced same-family
config used by per-arch CPU smoke tests; the full configs are exercised via
the dry-run only (ShapeDtypeStruct, no allocation).

The fields, ``SHAPES`` and ``smoke`` are the JAX package's exactly (a test
holds the two registries equal field by field); only ``dtype`` / ``cdtype``
return ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "smoke", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name as the configs spell it ("bfloat16", "float32", "int8")
    -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    activation: str = "silu"
    gated_mlp: bool = True
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096  # tokens per dispatch group
    # SSM / hybrid (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    attn_every: int = 0         # zamba2: shared attention block period
    # RWKV6
    rwkv_head_dim: int = 64
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500     # stub conv-frontend output frames
    learned_pos: bool = False
    # VLM
    mrope: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8": per-token-per-head scales
    remat: str = "full"         # none | full | dots
    q_chunk: int = 512
    kv_chunk: int = 1024
    # ESPIM sparsity (serving)
    espim_sparsity: float = 0.0  # 0 = dense serving
    espim_quant: str = "none"    # value-plane encoding: none | int8 | int4

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embedding tables shard
        cleanly (e.g. granite's 49155).  Models size tables with this;
        labels always index the logical vocab."""
        return -(-self.vocab_size // 256) * 256

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab — structure (GQA ratios, MoE top-k, hybrid
    period, enc-dec split) preserved."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        q_chunk=64,
        kv_chunk=64,
        moe_group_size=64,
        remat="none",
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4  # MHA archs stay MHA
    if cfg.family == "moe":
        kw["n_experts"] = 4
        kw["experts_per_token"] = min(cfg.experts_per_token, 2)
        # no capacity drops at smoke scale: keeps decode/forward parity exact
        kw["capacity_factor"] = 4.0
    if cfg.family in ("hybrid", "ssm"):
        kw["ssm_state"] = min(cfg.ssm_state, 16) or 16
        kw["ssm_head_dim"] = 16
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["n_layers"] = 6  # three groups -> shared block fires 3x
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 32
    return cfg.replace(**kw)
