"""Int8 gradient compression with error feedback for the data-parallel
reduction (mirrors ``src/repro/optim/compression.py``).

Each tensor travels as q = round(g / scale) in int8 plus one float32
scale (max|g| / 127); the quantization residual stays local and is added
back the next step, so the accumulated error stays bounded.  Rounding is
half to even (``torch.round``), as ``jnp.round``'s.  On a mesh the grads
are each rank's shards, and a leaf's scale takes the max over the mesh
axes that split it, so the codes are the unsharded leaf's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.sharding import partition
from repro_torch.tree import flatten, map_with_path, tree_map

__all__ = ["init_error_state", "compress_tree", "decompress_tree",
           "ef_compress_grads"]


def _quantize(g: torch.Tensor, amax=None):
    """(int8 codes, float32 scale); ``amax`` reduces the local max|g|
    over the ranks that hold the leaf's other shards."""
    gf = g.float()
    peak = torch.max(torch.abs(gf))
    if amax is not None:
        peak = amax(peak)
    scale = torch.clamp_min(peak, 1e-12) / 127.0
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


def ef_compress_grads(grads: dict, error_state: dict, layout=None):
    """The error-feedback int8 round trip -> (dequantized grads, new error
    state): what the all-reduce would deliver, and the residual kept.
    With a ``layout`` (``partition.Layout`` of the params' specs) both
    trees are local shards."""
    specs = {} if layout is None else dict(flatten(layout.specs))

    def one(path, g, e):
        amax = None
        if layout is not None:
            amax = functools.partial(
                partition.all_reduce, mesh=layout.mesh, op="max",
                axes=partition.sharded_axes(specs[path], layout.mesh))
        corrected = g.float() + e
        deq = _dequantize(*_quantize(corrected, amax))
        return deq, corrected - deq

    flat_e = dict(flatten(error_state))
    pairs = map_with_path(lambda p, g: one(p, g, flat_e[p]), grads)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))
