"""Carry the JAX package's params into the port.

The reference's params tree, given as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side), becomes the port's
dict of tensors with the same layout.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays, which torch cannot take directly;
they go through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


def _leaf(a, device: torch.device, dtype: torch.dtype | None):
    arr = np.asarray(a)
    name = str(arr.dtype)
    if arr.dtype.kind in "biu":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    want = dtype or torch_dtype(name)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return t.to(device=device, dtype=want)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (``cuda`` unless named).  Float leaves keep their own dtype
    unless ``dtype`` is given; integer leaves keep theirs."""
    dev = resolve_device(device)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        return _leaf(x, dev, dtype)

    return go(tree)
