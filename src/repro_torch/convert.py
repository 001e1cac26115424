"""Carry the JAX package's params into the port, and cast a params tree.

The reference's params tree, given as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side), becomes the port's
dict of tensors with the same layout.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays, which torch cannot take directly;
they go through float32, which holds every bfloat16 value exactly.

A cast to another float dtype keeps the leaves the models hold in
float32 at any model dtype (``FP32_LEAVES``: the MoE router, RWKV6's
``w0`` and ``u``, Mamba2's ``a_log``, ``d_skip`` and ``dt_bias``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device

__all__ = ["FP32_LEAVES", "params_from_numpy", "cast_params"]

FP32_LEAVES = frozenset({"router", "w0", "u", "a_log", "d_skip", "dt_bias"})


def _want(name: str, have: torch.dtype, dtype: torch.dtype | None):
    """The dtype a float leaf ``name`` of dtype ``have`` is cast to."""
    if dtype is None or (name in FP32_LEAVES and have == torch.float32):
        return have
    return dtype


def _leaf(name: str, a, device: torch.device, dtype: torch.dtype | None):
    arr = np.asarray(a)
    if arr.dtype.kind in "biu":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    want = _want(name, torch_dtype(str(arr.dtype)), dtype)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return t.to(device=device, dtype=want)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (``cuda`` unless named).  Float leaves keep their own dtype
    unless ``dtype`` is given (``FP32_LEAVES`` stay float32); integer
    leaves keep theirs."""
    dev = resolve_device(device)

    def go(name, x):
        if isinstance(x, dict):
            return {k: go(k, v) for k, v in x.items()}
        return _leaf(name, x, dev, dtype)

    return go("", tree)


def cast_params(tree: dict, dtype: torch.dtype | None = None,
                device=None) -> dict:
    """A params tree of tensors cast to ``dtype`` (``FP32_LEAVES`` kept
    float32; integer leaves kept) and / or moved to ``device``."""
    def go(name, x):
        if isinstance(x, dict):
            return {k: go(k, v) for k, v in x.items()}
        want = _want(name, x.dtype, dtype) if x.is_floating_point() \
            else x.dtype
        return x.to(device=device or x.device, dtype=want)

    return go("", tree)
