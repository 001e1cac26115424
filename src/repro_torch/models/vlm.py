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
from repro_torch.sharding import partition as P

__all__ = ["init_params", "forward", "init_cache", "decode_step",
           "default_positions3", "forward_sharded", "decode_step_sharded",
           "tp_widths"]

init_params = T.init_params
init_cache = T.init_cache
tp_widths = T.tp_widths


def default_positions3(b: int, s: int, start: int = 0,
                       device=None) -> torch.Tensor:
    """Text positions start..start+S-1 in all three sections: (3, B, S)."""
    pos = torch.arange(start, start + s, dtype=torch.int32, device=device)
    return pos.expand(3, b, s)


def _with_positions3(params: dict, batch: dict) -> dict:
    if "positions3" in batch:
        return batch
    b, s = batch["tokens"].shape
    return dict(batch, positions3=default_positions3(
        b, s, device=params["embed"].device))


def forward(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    return T.forward(cfg, params, _with_positions3(params, batch))


def forward_sharded(cfg: ModelConfig, params: dict, batch: dict,
                    layout) -> torch.Tensor:
    """``forward`` on this rank's shards (``transformer.forward_sharded``:
    M-RoPE from the local batch's ``positions3``, the vision embeddings
    spliced after the vocab-parallel lookup)."""
    return T.forward_sharded(cfg, params, _with_positions3(params, batch),
                             layout)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                donate: bool = False):
    """Decode with the positions derived from ``cache["len"]`` unless the
    batch carries ``positions3`` (3, B, 1) (``donate`` as
    ``transformer.decode_step``)."""
    if "positions3" not in batch:
        b = batch["tokens"].shape[0]
        pos = cache["len"].to(torch.int32)[None, :, None]      # (1, B, 1)
        batch = dict(batch, positions3=pos.expand(3, b, 1))
    return T.decode_step(cfg, params, cache, batch, donate)


def decode_step_sharded(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, playout, clayout, donate: bool = True):
    """``decode_step`` as tensor-parallel products on this rank's shards
    (``transformer.decode_step_sharded``: attention on the local batch),
    the M-RoPE positions derived from the local sequences' ``len`` unless
    the batch carries ``positions3``."""
    if "positions3" not in batch:
        b = batch["tokens"].shape[0]
        lens = P.local_slice(cache["len"], (clayout.specs["k"][1],),
                             playout.mesh)
        pos = lens.to(torch.int32)[None, :, None]
        batch = dict(batch, positions3=pos.expand(3, b, 1))
    return T.decode_step_sharded(cfg, params, cache, batch, playout,
                                 clayout, donate)
