"""The kernels package's public ops: the reference's signatures and
errors (``src/repro/kernels/ops.py``), dispatching between the
hand-written CUDA kernels and their plain PyTorch versions, and the
packed-weights API (``EspimWeights``, ``QuantEspimWeights``,
``pack_to_device``, ``espim_matvec``).

Dispatch, per call, on ``impl``:

* ``None`` — the kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"cuda"`` — the kernel; a CPU tensor raises;
* ``"ref"`` — the plain version on any device (the parity reference).

A CUDA tensor never silently takes the plain version: a build or launch
failure raises.  Both the column-chunked ``(R_pad, K, Lc)`` layout and
the plain ``(R_pad, L)`` ELL layout are accepted, the array rank selects
the family; only the chunked family has kernels, so a plain pack needs
``impl="ref"``, as the reference's plain packs need its ref lowering.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sparse_format import ELLChunkedPack, ELLPack, chunk_pack
from repro_torch.device import resolve_device
from repro_torch.kernels import dense_mv as _dk
from repro_torch.kernels import espim_spmv as _k
from repro_torch.kernels import ref as _ref
from repro_torch.telemetry.trace import get_tracer

__all__ = ["espim_spmv", "espim_spmv_batched", "espim_spmv_batched_quant",
           "dense_mv", "espim_matvec", "EspimWeights", "QuantEspimWeights",
           "pack_to_device", "DEFAULT_CHUNK_COLS", "IMPLS"]

DEFAULT_CHUNK_COLS = 512
IMPLS = (None, "cuda", "ref")

_PLAIN_REF_ONLY = ("the kernels consume the column-chunked layout; re-pack "
                   "with pack_ell_chunked (plain ELL is ref-only: "
                   "impl='ref')")


def _check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (None | 'cuda' | 'ref')")


def _use_kernel(impl: str | None, *tensors) -> bool:
    """True when this call launches the CUDA kernel."""
    _check_impl(impl)
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


def _dispatch_spmv(values, cols, x, chunk_cols, impl, plain_ref,
                   chunked_ref, kernel) -> torch.Tensor:
    """Layout/impl dispatch shared by the (un)batched ops: plain
    (R_pad, L) packs take the plain version (``impl="ref"`` only);
    chunked (R_pad, K, Lc) packs take the kernel or the chunked plain
    version."""
    _check_impl(impl)
    if values.dim() == 2:
        if impl != "ref":
            raise ValueError(_PLAIN_REF_ONLY)
        return plain_ref(values, cols, x)
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if _use_kernel(impl, values, cols, x):
        return kernel(values, cols, x, chunk_cols=cc)
    return chunked_ref(values, cols, x, cc)


def espim_spmv(values, cols, x, *, chunk_cols: int | None = None,
               impl: str | None = None) -> torch.Tensor:
    """ELL sparse MV, x (M,) -> (R_pad,) float32.

    Chunked layout: values (float32 or bfloat16) / cols (R_pad, K, Lc) +
    ``chunk_cols``.  Plain layout: values/cols (R_pad, L), plain version
    only.
    """
    return _dispatch_spmv(values, cols, x, chunk_cols, impl,
                          _ref.espim_spmv_ref, _ref.espim_spmv_chunked_ref,
                          _k.espim_spmv_cuda)


def espim_spmv_batched(values, cols, x, *, chunk_cols: int | None = None,
                       impl: str | None = None, epilogue: str | None = None,
                       act: str = "silu", residual=None) -> torch.Tensor:
    """Batched ELL sparse MV: x (M, B) -> (R_pad, B) float32 (see
    ``espim_spmv``).

    ``epilogue`` fuses a decode epilogue into the launch:

    * ``"glu"`` — values/cols hold a half-major (2*Rg, K, Lc) gate+up
      group sharing one balance perm; returns act(gate) * up (Rg, B) in
      packed order.
    * ``"residual"`` — adds ``residual`` (R_pad, B) float32, already in
      packed row order, to the reduced sum in the same launch.
    """
    if epilogue is None:
        return _dispatch_spmv(values, cols, x, chunk_cols, impl,
                              _ref.espim_spmv_batched_ref,
                              _ref.espim_spmv_batched_chunked_ref,
                              _k.espim_spmv_batched_cuda)
    _check_impl(impl)
    if values.dim() != 3:
        raise ValueError(
            f"epilogue={epilogue!r} needs the column-chunked layout; got "
            f"values of shape {tuple(values.shape)}")
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if epilogue == "glu":
        if _use_kernel(impl, values, cols, x):
            return _k.espim_spmv_batched_glu_cuda(values, cols, x,
                                                  chunk_cols=cc, act=act)
        return _ref.espim_spmv_batched_chunked_glu_ref(values, cols, x, cc,
                                                       act)
    if epilogue == "residual":
        if residual is None:
            raise ValueError("epilogue='residual' needs the residual "
                             "operand (packed row order)")
        if _use_kernel(impl, values, cols, x, residual):
            return _k.espim_spmv_batched_res_cuda(values, cols, x, residual,
                                                  chunk_cols=cc)
        return _ref.espim_spmv_batched_chunked_ref(values, cols, x,
                                                   cc) + residual
    raise ValueError(f"unknown epilogue {epilogue!r}")


def espim_spmv_batched_quant(values, cols, scales, x, *,
                             chunk_cols: int | None = None,
                             group_rows: int = 1, impl: str | None = None,
                             epilogue: str | None = None, act: str = "silu",
                             srow=None, residual=None) -> torch.Tensor:
    """Quantized batched ELL sparse MV: int8 codes (or nibble-packed
    uint8 — inferred from the width mismatch vs ``cols``) plus one float32
    scale per ``group_rows`` packed rows; x (M, B) -> (R_pad, B) float32.

    ``scales=None`` returns the unscaled code-domain accumulator (the
    serving path folds its per-row scales into one multiply per bucket).
    ``epilogue="glu"`` accumulates the half-major (2*Rg, K, Lc) code
    plane, multiplies both halves by the per-row scales ``srow`` (2*Rg,),
    then forms act(gate) * up — the unfused path's exact op order.
    ``epilogue="residual"`` adds the packed-order residual to the scaled
    output (op-level for the quant family, as in the reference: the
    kernel, then ``srow`` when ``scales`` is None, then the add).  The
    plain (R_pad, L) layout takes the plain version as a one-chunk plane.
    """
    _check_impl(impl)
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
        if residual is None:
            raise ValueError("epilogue='residual' needs the residual "
                             "operand (packed row order)")
        y = espim_spmv_batched_quant(
            values, cols, scales, x, chunk_cols=chunk_cols,
            group_rows=group_rows, impl=impl)
        if scales is None and srow is not None:
            y = y * srow[:, None]
        return y + residual
    if epilogue is not None:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if cols.dim() == 2:
        if impl != "ref":
            raise ValueError(_PLAIN_REF_ONLY)
        return _ref.espim_spmv_batched_chunked_quant_ref(
            values[:, None, :], cols[:, None, :], scales, x, x.shape[0],
            group_rows)
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if _use_kernel(impl, values, cols, scales, x):
        return _k.espim_spmv_batched_quant_cuda(
            values, cols, scales, x, chunk_cols=cc, group_rows=group_rows)
    return _ref.espim_spmv_batched_chunked_quant_ref(
        values, cols, scales, x, cc, group_rows)


def dense_mv(w, x, *, impl: str | None = None) -> torch.Tensor:
    """Dense MV (the Newton-analogue path): w (R, C) @ x (C,) -> (R,)
    float32."""
    if _use_kernel(impl, w, x):
        return _dk.dense_mv_cuda(w, x)
    return _ref.dense_mv_ref(w, x)


# --------------------------------------------------------------------------
# Packed-weights API
# --------------------------------------------------------------------------
@dataclasses.dataclass
class EspimWeights:
    """Device-resident column-chunked ESPIM pack of one weight matrix
    (W @ x semantics, W of shape (n_out, n_in))."""

    values: torch.Tensor      # (R_pad, K, Lc) float32 or bfloat16
    cols: torch.Tensor        # (R_pad, K, Lc) int32, chunk-local
    perm: torch.Tensor        # (R_pad,) int32, -1 = pad row
    n_rows: int
    n_cols: int
    chunk_cols: int


@dataclasses.dataclass
class QuantEspimWeights:
    """Device-resident column-chunked pack with a quantized value plane
    (``repro_torch.quant``): int8 codes or nibble-packed uint8 plus
    per-row-group scales; indices and perm as in ``EspimWeights``."""

    values: torch.Tensor      # (R_pad, K, Lc) int8 | (R_pad, K, Lc/2) uint8
    cols: torch.Tensor        # (R_pad, K, Lc) int32, chunk-local
    perm: torch.Tensor        # (R_pad,) int32, -1 = pad row
    scales: torch.Tensor      # (R_pad // group_rows,) float32
    n_rows: int
    n_cols: int
    chunk_cols: int
    group_rows: int
    bits: int


def pack_to_device(pack: ELLPack | ELLChunkedPack, dtype=torch.float32,
                   chunk_cols: int = DEFAULT_CHUNK_COLS, quant=None,
                   verify: bool = True, autotune: bool = False,
                   tune: dict | None = None, device=None
                   ) -> EspimWeights | QuantEspimWeights:
    """Move an offline pack onto the tensors the kernels consume, on
    ``device`` (default cuda; raises without one unless asked for the
    CPU).

    A plain ELLPack is run through the SDDS chunk pass first (with
    ``chunk_cols``); an ELLChunkedPack is uploaded as-is.  ``quant``
    ("int8" | "int4" | a ``repro_torch.quant.QuantSpec``) quantizes the
    value plane on the way up (or reuses an already-attached
    ``pack.qplane`` made by the same spec) and returns
    ``QuantEspimWeights``.  ``verify=True`` runs
    ``core.integrity.verify_pack`` on the host pack first: corruption
    between build and upload raises ``PackIntegrityError`` here.
    ``autotune=True`` is not ported (``tune`` goes with it).
    """
    if autotune:
        raise NotImplementedError(
            "pack_to_device(autotune=True) is not ported yet: the Hopper "
            "schedule space and plan cache are ROADMAP Queue 1, "
            "'Autotune'")
    dev = resolve_device(device)
    tr = get_tracer()
    with tr.span("pack.to_device", cat="pack",
                 args={"quant": getattr(quant, "bits", quant) or "none",
                       "verify": verify, "autotune": autotune}):
        if verify:
            from repro_torch.core.integrity import verify_pack
            with tr.span("pack.verify", cat="pack"):
                verify_pack(pack)
        if isinstance(pack, ELLPack):
            pack = chunk_pack(pack, chunk_cols)
        # torch.tensor copies: the device planes never alias the host pack
        cols = torch.tensor(pack.cols, dtype=torch.int32, device=dev)
        perm = torch.tensor(np.asarray(pack.perm), dtype=torch.int32,
                            device=dev)
        if quant is None:
            return EspimWeights(
                values=torch.tensor(pack.values, dtype=dtype, device=dev),
                cols=cols, perm=perm, n_rows=pack.n_rows,
                n_cols=pack.n_cols, chunk_cols=pack.chunk_cols)
        from repro_torch.quant import QuantSpec, default_spec, quantize_pack
        spec = quant if isinstance(quant, QuantSpec) else default_spec(quant)
        plane = pack.qplane
        # reuse the attached plane only when this exact spec produced it
        if plane is None or plane.spec != spec:
            plane = quantize_pack(pack, spec)
        return QuantEspimWeights(
            values=torch.tensor(plane.device_codes(), device=dev),
            cols=cols, perm=perm,
            scales=torch.tensor(plane.scales, device=dev),
            n_rows=pack.n_rows, n_cols=pack.n_cols,
            chunk_cols=pack.chunk_cols, group_rows=plane.group_rows,
            bits=plane.bits)


def espim_matvec(w: EspimWeights | QuantEspimWeights, x: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """y (n_rows,) or (n_rows, B) = W @ x with packed-row unscatter.  A
    1-D x on an fp pack takes the unbatched op; a quantized pack takes
    the batched quant op at B = 1."""
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be 1-D or 2-D, got {tuple(x.shape)}")
    if isinstance(w, QuantEspimWeights):
        xb = x[:, None] if x.dim() == 1 else x
        yp = espim_spmv_batched_quant(w.values, w.cols, w.scales, xb,
                                      chunk_cols=w.chunk_cols,
                                      group_rows=w.group_rows, impl=impl)
        yp = yp[:, 0] if x.dim() == 1 else yp
    elif x.dim() == 1:
        yp = espim_spmv(w.values, w.cols, x, chunk_cols=w.chunk_cols,
                        impl=impl)
    else:
        yp = espim_spmv_batched(w.values, w.cols, x,
                                chunk_cols=w.chunk_cols, impl=impl)
    return _ref.scatter_rows_ref(yp, w.perm, w.n_rows)
