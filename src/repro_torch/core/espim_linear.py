"""ESPIMLinear — the paper's flexible dense/sparse datapath (Section III-I)
as a PyTorch projection layer — and ``ESPIMGroupLinear`` (several
same-input projections packed as ONE fused group, the PackGroup
contract).  The port of ``src/repro/core/espim_linear.py``.

Flexible configuration: a projection holds either a dense weight (Newton's
16-MAC path) or an ESPIM ELL pack (11-MAC + FIFOs + switch path).  The
choice is made offline from the measured weight sparsity, as the paper
power-gates one datapath or the other; the output contract is identical
either way.  The layers are ``nn.Module``s whose planes are buffers, so
``.to(device)`` moves them; ``weights`` hands the ops an ``EspimWeights``
or ``QuantEspimWeights`` view of them.

A 1-D ``x`` takes the unbatched op (the unbatched kernel on fp packs),
where the reference passes it as one column through the batched op: the
same sums in another order.

The distributed matvec (``make_sharded_weights``, ``espim_matvec_sharded``)
makes each rank of a mesh axis one bank holding a contiguous range of
packed rows; x is replicated (the broadcast).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sparse_format import (chunk_pack, pack_ell,
                                           pack_ell_chunked, shard_ell)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

__all__ = ["ESPIMLinear", "ESPIMGroupLinear", "make_sharded_weights",
           "espim_matvec_sharded"]


def _host(a) -> np.ndarray:
    """A weight or bias as a host numpy array (torch tensors in float32)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a)


def _pack_weights(w: np.ndarray, row_tile: int, chunk_cols: int, dtype,
                  quant, dev: torch.device):
    pack = pack_ell_chunked(w, row_tile=row_tile, chunk_cols=chunk_cols)
    if quant in ("none",):
        quant = None
    return ops.pack_to_device(pack, dtype=dtype, quant=quant, device=dev)


class _Packed(nn.Module):
    """Registers a device pack's tensors as buffers and rebuilds the
    weights dataclass from them on demand."""

    def _register_pack(self, weights) -> None:
        self._pack_cls = type(weights)
        self._planes, self._meta = [], {}
        for f in dataclasses.fields(weights):
            v = getattr(weights, f.name)
            if isinstance(v, torch.Tensor):
                self.register_buffer(f.name, v)
                self._planes.append(f.name)
            else:
                self._meta[f.name] = v

    def _pack_view(self):
        return self._pack_cls(**{n: getattr(self, n) for n in self._planes},
                              **self._meta)


class ESPIMLinear(_Packed):
    """Projection y = W @ x (+ b), W of shape (n_out, n_in).

    ``sparse`` selects the datapath.  ``from_dense`` measures sparsity
    and picks it (optionally pruning first), mirroring Section III-I.
    """

    def __init__(self, n_out: int, n_in: int, sparse: bool, weights,
                 bias: torch.Tensor | None = None, density: float = 1.0):
        super().__init__()
        self.n_out, self.n_in = n_out, n_in
        self.sparse, self.density = sparse, density
        if sparse:
            self._register_pack(weights)
        else:
            self.register_buffer("weight", weights)
        self.register_buffer("bias", bias)

    @property
    def weights(self):
        """``EspimWeights`` / ``QuantEspimWeights`` if sparse, else the
        dense (n_out, n_in) weight."""
        return self._pack_view() if self.sparse else self.weight

    @classmethod
    def from_dense(cls, w, bias=None, *, prune_sparsity: float | None = None,
                   sparse_threshold: float = 0.5, row_tile: int = 128,
                   chunk_cols: int = ops.DEFAULT_CHUNK_COLS,
                   dtype=torch.float32, quant=None, device=None
                   ) -> "ESPIMLinear":
        """``w`` (n_out, n_in) as numpy or a tensor, packed on the host and
        placed on ``device`` (default cuda).  ``quant`` ("int8" | "int4" |
        a ``QuantSpec``) quantizes the pack's value plane on the sparse
        path; the dense path ignores it."""
        dev = resolve_device(device)
        w = _host(w)
        if prune_sparsity is not None:
            w = magnitude_prune(w, prune_sparsity)
        density = float((w != 0).mean())
        sparse = density < sparse_threshold
        if sparse:
            weights = _pack_weights(w, row_tile, chunk_cols, dtype, quant,
                                    dev)
        else:
            weights = torch.tensor(w, dtype=dtype, device=dev)
        b = (None if bias is None else
             torch.tensor(_host(bias), dtype=torch.float32, device=dev))
        return cls(w.shape[0], w.shape[1], sparse, weights, b, density)

    def forward(self, x: torch.Tensor, impl: str | None = None
                ) -> torch.Tensor:
        """x: (n_in,) or (..., n_in) -> (n_out,) or (..., n_out), float32."""
        if self.sparse and x.dim() == 1:
            y = ops.espim_matvec(self.weights, x, impl=impl)
        elif self.sparse:
            xb = x.reshape(-1, self.n_in)
            y = ops.espim_matvec(self.weights, xb.T, impl=impl).T
        else:
            y = x.reshape(-1, self.n_in).float() @ self.weight.float().T
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(x.shape[:-1] + (self.n_out,))


class ESPIMGroupLinear(_Packed):
    """Several projections sharing one input, packed as ONE fused group.

    The member matrices are row-concatenated (their combined per-row nnz
    drives one shared balance permutation) and a single SpMV launch
    computes every member; ``espim_matvec``'s unscatter restores logical
    row order, so ``forward`` returns a dict of per-projection outputs
    identical to running each member alone — at one launch instead of
    len(names).
    """

    def __init__(self, names: tuple, sizes: tuple, n_in: int, weights,
                 density: float = 1.0):
        super().__init__()
        self.names, self.sizes = tuple(names), tuple(sizes)
        self.n_in, self.density = n_in, density
        self._register_pack(weights)

    @property
    def weights(self):
        return self._pack_view()

    @classmethod
    def from_dense(cls, named_ws: dict, *,
                   prune_sparsity: float | None = None, row_tile: int = 128,
                   chunk_cols: int = ops.DEFAULT_CHUNK_COLS,
                   dtype=torch.float32, quant=None, device=None
                   ) -> "ESPIMGroupLinear":
        """``named_ws``: {name: (n_out, n_in)} sharing ``n_in`` (e.g.
        ``{"wq": ..., "wk": ..., "wv": ...}``).  Prunes each member,
        row-concatenates, and packs once."""
        dev = resolve_device(device)
        names = tuple(named_ws)
        mats = []
        for n in names:
            w = _host(named_ws[n])
            if prune_sparsity is not None:
                w = magnitude_prune(w, prune_sparsity)
            mats.append(w)
        n_in = mats[0].shape[1]
        if any(m.shape[1] != n_in for m in mats):
            raise ValueError("group members must share the input dim")
        cat = np.concatenate(mats, axis=0)
        weights = _pack_weights(cat, row_tile, chunk_cols, dtype, quant, dev)
        return cls(names, tuple(m.shape[0] for m in mats), n_in, weights,
                   float((cat != 0).mean()))

    def forward(self, x: torch.Tensor, impl: str | None = None) -> dict:
        """x: (n_in,) or (..., n_in) -> {name: (n_out_name,) or
        (..., n_out_name)} — one fused launch for the whole group."""
        if x.dim() == 1:
            y = ops.espim_matvec(self.weights, x, impl=impl)[:, None]
        else:
            y = ops.espim_matvec(self.weights, x.reshape(-1, self.n_in).T,
                                 impl=impl)
        out, r0 = {}, 0
        for name, n_out in zip(self.names, self.sizes):
            out[name] = y[r0:r0 + n_out].T.reshape(x.shape[:-1] + (n_out,))
            r0 += n_out
        return out


# --------------------------------------------------------------------------
# Distributed sparse MV (devices as banks)
# --------------------------------------------------------------------------
def make_sharded_weights(w, n_shards: int, *,
                         prune_sparsity: float | None = None,
                         row_tile: int = 128,
                         chunk_cols: int = ops.DEFAULT_CHUNK_COLS) -> dict:
    """Offline: prune, pack, re-layout for ``n_shards`` banks
    (``shard_ell``: packed rows padded to a multiple of n_shards x
    row_tile), then chunk the columns so that a bank runs the unbatched
    kernel.  Host numpy: ``values`` / ``cols`` (S, per, K, Lc), ``perm``
    (S, per), ``n_rows``, ``n_cols``, ``chunk_cols``."""
    w = _host(w)
    if prune_sparsity is not None:
        w = magnitude_prune(w, prune_sparsity)
    sh = shard_ell(pack_ell(w, row_tile=row_tile), n_shards)
    cp = chunk_pack(sh["pack"], chunk_cols)
    per = sh["perm"].shape[1]
    k, lc = cp.values.shape[1:]
    return {"values": cp.values.reshape(n_shards, per, k, lc),
            "cols": cp.cols.reshape(n_shards, per, k, lc),
            "perm": sh["perm"], "n_rows": sh["n_rows"],
            "n_cols": sh["n_cols"], "chunk_cols": cp.chunk_cols}


def espim_matvec_sharded(sharded: dict, x: torch.Tensor, mesh,
                         axis: str = "model", *,
                         impl: str | None = None) -> torch.Tensor:
    """y (n_rows,) = W @ x with W's packed rows sharded over ``axis`` of
    ``mesh`` (a ``DeviceMesh``).  This rank is bank ``coordinate[axis]``:
    its packed rows go to ``x``'s device and through ``ops.espim_spmv``
    (kernel 5 on the card); the banks' outputs are all-gathered along
    ``axis`` (nothing to gather at size 1) and unscattered to row
    order."""
    import torch.distributed as dist

    dim = mesh.mesh_dim_names.index(axis)
    bank = mesh.get_coordinate()[dim]
    dev = x.device
    yp = ops.espim_spmv(torch.as_tensor(sharded["values"][bank], device=dev),
                        torch.as_tensor(sharded["cols"][bank], device=dev),
                        x, chunk_cols=sharded["chunk_cols"], impl=impl)
    n_banks = mesh.size(dim)
    if n_banks > 1:
        parts = [torch.empty_like(yp) for _ in range(n_banks)]
        dist.all_gather(parts, yp, group=mesh.get_group(axis))
        yp = torch.cat(parts)
    perm = torch.as_tensor(sharded["perm"].reshape(-1), device=dev)
    return kref.scatter_rows_ref(yp, perm, sharded["n_rows"])
