"""Architecture registry: ``--arch <id>`` resolution for every launcher,
test and benchmark."""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    granite_3_2b,
    llama7b_espim,
    nemotron_4_15b,
    phi3_5_moe,
    qwen1_5_110b,
    qwen2_5_14b,
    qwen2_vl_2b,
    rwkv6_1_6b,
    whisper_small,
    zamba2_2_7b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, smoke

__all__ = ["REGISTRY", "ASSIGNED", "get_config", "get_shape", "list_archs",
           "cells"]

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen1_5_110b.CONFIG,
        nemotron_4_15b.CONFIG,
        granite_3_2b.CONFIG,
        qwen2_5_14b.CONFIG,
        dbrx_132b.CONFIG,
        phi3_5_moe.CONFIG,
        qwen2_vl_2b.CONFIG,
        zamba2_2_7b.CONFIG,
        whisper_small.CONFIG,
        rwkv6_1_6b.CONFIG,
        llama7b_espim.CONFIG,
    ]
}

# The ten assigned architectures (the paper's llama7b is extra).
ASSIGNED = [
    "qwen1.5-110b", "nemotron-4-15b", "granite-3-2b", "qwen2.5-14b",
    "dbrx-132b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b", "zamba2-2.7b",
    "whisper-small", "rwkv6-1.6b",
]


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    try:
        cfg = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}") from None
    return smoke(cfg) if reduced else cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def list_archs() -> list[str]:
    return list(ASSIGNED)


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Spec-mandated skips; None means the cell runs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md section 4)")
    return None


def cells(include_skipped: bool = False):
    """All 40 (arch x shape) cells; skipped cells annotated."""
    out = []
    for arch in ASSIGNED:
        cfg = REGISTRY[arch]
        for shape in SHAPES.values():
            reason = skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((arch, shape.name, reason))
    return out
