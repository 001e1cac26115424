"""Int8 gradient compression with error feedback for the data-parallel
reduction (mirrors ``src/repro/optim/compression.py``).

Each tensor travels as q = round(g / scale) in int8 plus one float32
scale (max|g| / 127); the quantization residual stays local and is added
back the next step, so the accumulated error stays bounded.  Rounding is
half to even (``torch.round``), as ``jnp.round``'s.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map

__all__ = ["init_error_state", "compress_tree", "decompress_tree",
           "ef_compress_grads"]


def _quantize(g: torch.Tensor):
    gf = g.float()
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict) -> dict:
    """Each leaf -> (int8 codes, float32 scale)."""
    return tree_map(_quantize, grads)


def decompress_tree(comp: dict) -> dict:
    return tree_map(lambda qs: _dequantize(*qs), comp)


def init_error_state(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_grads(grads: dict, error_state: dict):
    """The error-feedback int8 round trip -> (dequantized grads, new error
    state): what the all-reduce would deliver, and the residual kept."""
    def one(g, e):
        corrected = g.float() + e
        deq = _dequantize(*_quantize(corrected))
        return deq, corrected - deq

    pairs = tree_map(one, grads, error_state)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))
