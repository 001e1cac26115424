"""The kernels package's public ops: the reference's signatures and
errors (``src/repro/kernels/ops.py``), dispatching between the
hand-written CUDA kernels and their plain PyTorch versions.

Dispatch, per call, on ``impl``:

* ``None`` — the kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"cuda"`` — the kernel; a CPU tensor raises;
* ``"ref"`` — the plain version on any device (the parity reference).

A CUDA tensor never silently takes the plain version: a build or launch
failure raises.  Only the column-chunked ``(R_pad, K, Lc)`` layout is
served.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import espim_spmv as _k
from repro_torch.kernels import ref as _ref

__all__ = ["espim_spmv_batched", "espim_spmv_batched_quant",
           "DEFAULT_CHUNK_COLS", "IMPLS"]

DEFAULT_CHUNK_COLS = 512
IMPLS = (None, "cuda", "ref")

_RESIDUAL_TODO = ("epilogue='residual' is not ported yet (ROADMAP Queue 2 "
                  "item 6, espim_spmv_batched_res_pallas)")


def _use_kernel(impl: str | None, *tensors) -> bool:
    """True when this call launches the CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (None | 'cuda' | 'ref')")
    if impl == "ref":
        return False
    on_cuda = any(t is not None and t.is_cuda for t in tensors)
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; use impl='ref' "
                         "(or None) for tensors on the CPU")
    return on_cuda


def _check_chunk_cols(cols, x, chunk_cols) -> int:
    if chunk_cols is None:
        raise ValueError(
            "chunk_cols is required for the chunked (R_pad, K, Lc) layout; "
            f"got cols of shape {tuple(cols.shape)}")
    cc = int(chunk_cols)
    n_chunks = cols.shape[1]
    if n_chunks > 1 and n_chunks * cc - x.shape[0] >= cc:
        # the last chunk would sit entirely past x: chunk_cols cannot be
        # the width this pack was built with (silent-corruption guard)
        raise ValueError(
            f"chunk_cols={cc} inconsistent with pack: {n_chunks} chunks x "
            f"{cc} cols span past x of length {x.shape[0]}")
    return cc


def _need_chunked(t: torch.Tensor, what: str) -> None:
    if t.dim() != 3:
        raise ValueError(
            f"{what} needs the column-chunked (R_pad, K, Lc) layout; got "
            f"shape {tuple(t.shape)} (plain ELL is not served by the port)")


def espim_spmv_batched(values, cols, x, *, chunk_cols: int | None = None,
                       impl: str | None = None, epilogue: str | None = None,
                       act: str = "silu", residual=None) -> torch.Tensor:
    """Batched chunked-ELL sparse MV: x (M, B) -> (R_pad, B) float32.

    ``epilogue="glu"``: values/cols hold a half-major (2*Rg, K, Lc)
    gate+up group sharing one balance perm; returns act(gate) * up
    (Rg, B) in packed order.
    """
    if epilogue not in (None, "glu", "residual"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "residual":
        raise NotImplementedError(_RESIDUAL_TODO)
    _need_chunked(values, "espim_spmv_batched")
    cc = _check_chunk_cols(cols, x, chunk_cols)
    kernel = _use_kernel(impl, values, cols, x)
    if epilogue == "glu":
        if kernel:
            return _k.espim_spmv_batched_glu_cuda(values, cols, x,
                                                  chunk_cols=cc, act=act)
        return _ref.espim_spmv_batched_chunked_glu_ref(values, cols, x, cc,
                                                       act)
    if kernel:
        return _k.espim_spmv_batched_cuda(values, cols, x, chunk_cols=cc)
    return _ref.espim_spmv_batched_chunked_ref(values, cols, x, cc)


def espim_spmv_batched_quant(values, cols, scales, x, *,
                             chunk_cols: int | None = None,
                             group_rows: int = 1, impl: str | None = None,
                             epilogue: str | None = None, act: str = "silu",
                             srow=None, residual=None) -> torch.Tensor:
    """Quantized batched chunked-ELL sparse MV: int8 codes (or
    nibble-packed uint8 — inferred from the width mismatch vs ``cols``)
    plus one float32 scale per ``group_rows`` packed rows; x (M, B) ->
    (R_pad, B) float32.

    ``scales=None`` returns the unscaled code-domain accumulator (the
    serving path folds its per-row scales into one multiply per bucket).
    ``epilogue="glu"`` accumulates the half-major (2*Rg, K, Lc) code
    plane, multiplies both halves by the per-row scales ``srow`` (2*Rg,),
    then forms act(gate) * up — the unfused path's exact op order.
    """
    if epilogue == "glu":
        if srow is None:
            raise ValueError("epilogue='glu' needs srow (pre-expanded "
                             "per-row scales, half-major)")
        if cols.dim() != 3:
            raise ValueError(
                "epilogue='glu' needs the column-chunked layout; got "
                f"cols of shape {tuple(cols.shape)}")
        cc = _check_chunk_cols(cols, x, chunk_cols)
        if _use_kernel(impl, values, cols, srow, x):
            return _k.espim_spmv_batched_quant_glu_cuda(
                values, cols, srow, x, chunk_cols=cc, act=act)
        return _ref.espim_spmv_batched_chunked_quant_glu_ref(
            values, cols, srow, x, cc, act)
    if epilogue == "residual":
        raise NotImplementedError(_RESIDUAL_TODO)
    if epilogue is not None:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    _need_chunked(cols, "espim_spmv_batched_quant")
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if _use_kernel(impl, values, cols, scales, x):
        return _k.espim_spmv_batched_quant_cuda(
            values, cols, scales, x, chunk_cols=cc, group_rows=group_rows)
    return _ref.espim_spmv_batched_chunked_quant_ref(
        values, cols, scales, x, cc, group_rows)
