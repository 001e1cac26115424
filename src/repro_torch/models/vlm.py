"""Qwen2-VL-2b — the VLM backbone with M-RoPE (mirrors
``src/repro/models/vlm.py``).

The vision frontend is a stub, as in the reference: a batch may carry
precomputed patch embeddings (B, S, D) and a ``vis_mask`` marking the
visual positions, which the backbone splices over the token embeddings.
M-RoPE drives the rotary sections (temporal, height, width) from a
(3, B, S) position tensor; for text all three components coincide.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "default_positions3"]

init_params = T.init_params
init_cache = T.init_cache


def default_positions3(b: int, s: int, start: int = 0,
                       device=None) -> torch.Tensor:
    """Text positions start..start+S-1 in all three sections: (3, B, S)."""
    pos = torch.arange(start, start + s, dtype=torch.int32, device=device)
    return pos.expand(3, b, s)


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    tokens = batch["tokens"]
    if "positions3" not in batch:
        b, s = tokens.shape
        batch = dict(batch, positions3=default_positions3(
            b, s, device=params["embed"].device))
    return T.forward(cfg, params, batch)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """Decode with the positions derived from ``cache["len"]`` unless the
    batch carries ``positions3`` (3, B, 1)."""
    if "positions3" not in batch:
        b = batch["tokens"].shape[0]
        pos = cache["len"].to(torch.int32)[None, :, None]      # (1, B, 1)
        batch = dict(batch, positions3=pos.expand(3, b, 1))
    return T.decode_step(cfg, params, cache, batch)
