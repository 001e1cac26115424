"""Launch wrappers of the hand-written Hopper SpMV kernels
(``csrc/espim_spmv.cu``), one per Pallas kernel of the JAX package's
``src/repro/kernels/espim_spmv.py``:

* ``espim_spmv_cuda`` replaces ``espim_spmv_pallas`` (unbatched);
* ``espim_spmv_batched_cuda`` replaces ``espim_spmv_batched_pallas``;
* ``espim_spmv_batched_res_cuda`` replaces
  ``espim_spmv_batched_res_pallas``;
* ``espim_spmv_batched_quant_cuda`` replaces
  ``espim_spmv_batched_quant_pallas``;
* ``espim_spmv_batched_glu_cuda`` replaces
  ``espim_spmv_batched_glu_pallas``;
* ``espim_spmv_batched_quant_glu_cuda`` replaces
  ``espim_spmv_batched_quant_glu_pallas``.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the output, launch on the current stream, raise if
the launch was refused, and add one to ``LAUNCHES[<kernel>]``.  Their
plain versions live in ``kernels/ref.py``; ``kernels/ops.py`` picks
between the two by the tensors' device.  All six are bound by the bytes
of the value and index planes (see the source's header note).  Kernels
1-4 (``espim_spmv_batched_cuda``, ``espim_spmv_batched_quant_cuda`` and
their GLU forms) and kernel 6 (the residual form) run the source's
streaming body, whose C launcher picks the batch tile from B and the
vector or scalar slot walk from Lc and the planes' alignment; any width,
alignment and B >= 1 is taken.  Kernels 1, 3 and 6 take float32 or
bfloat16 value planes (bf16 widened to f32 in the kernel) and x in f32
(a bf16 x is widened exactly by the wrapper).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library

__all__ = ["LAUNCHES", "reset_launches", "ACT_IDS", "espim_spmv_cuda",
           "espim_spmv_batched_cuda", "espim_spmv_batched_res_cuda",
           "espim_spmv_batched_quant_cuda", "espim_spmv_batched_glu_cuda",
           "espim_spmv_batched_quant_glu_cuda"]

# kernel launches since the last reset, one plain integer per kernel
LAUNCHES = {"espim_spmv": 0, "espim_spmv_batched": 0,
            "espim_spmv_batched_res": 0, "espim_spmv_batched_quant": 0,
            "espim_spmv_batched_glu": 0, "espim_spmv_batched_quant_glu": 0}

ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2, "relu2": 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _common(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
            chunk_cols: int, extra=(), batched: bool = True) -> tuple:
    """Validate the operands every kernel shares; returns the contiguous
    x — (M, B) fp32, or for the unbatched kernel (M,) fp32 or bf16 — and
    the stream handle.  x is copied only when it is not already in that
    form; the decode path hands every bucket of a group one ready x
    (``sparse_model._col_major``), so it copies nothing here."""
    dev = cols.device
    for name, t in (("values", values), ("cols", cols), ("x", x),
                    *extra):
        if t is None:
            continue
        _need(t.is_cuda and t.device == dev,
              f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if name != "x":
            _need(t.is_contiguous(), f"{name} must be contiguous")
    _need(cols.dtype == torch.int32 and cols.dim() == 3,
          f"cols must be int32 (R, K, Lc), got {cols.dtype}{tuple(cols.shape)}")
    want = 2 if batched else 1
    _need(x.dim() == want,
          f"x must be {'(M, B)' if batched else '(M,)'}, got {tuple(x.shape)}")
    _need(int(chunk_cols) > 0, f"chunk_cols must be positive, got {chunk_cols}")
    _need(max(cols.numel(), x.numel()) < 2 ** 31,
          "plane or x too large for 32-bit slot offsets")
    keep = not batched and x.dtype == torch.bfloat16
    xc = (x if keep else x.to(torch.float32)).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return xc, stream


def _codes_layout(codes: torch.Tensor, cols: torch.Tensor) -> tuple[int, int]:
    """(nibble, lv) of a quantized plane: int8 codes share cols' width;
    nibble-packed uint8 planes hold ceil(Lc / 2) bytes per chunk row."""
    r, k, lc = cols.shape
    if codes.dtype == torch.int8:
        _need(tuple(codes.shape) == (r, k, lc),
              f"int8 codes {tuple(codes.shape)} != cols {tuple(cols.shape)}")
        return 0, lc
    _need(codes.dtype == torch.uint8,
          f"codes must be int8 or nibble-packed uint8, got {codes.dtype}")
    lv = (lc + 1) // 2
    _need(tuple(codes.shape) == (r, k, lv),
          f"nibble-packed codes {tuple(codes.shape)} != (R, K, ceil(Lc/2)) "
          f"{(r, k, lv)}")
    return 1, lv


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _halves(cols: torch.Tensor) -> int:
    _need(cols.shape[0] % 2 == 0,
          f"GLU needs a half-major (2*Rg, ...) pack; got {cols.shape[0]} rows")
    return cols.shape[0] // 2


def espim_spmv_cuda(values: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor, *, chunk_cols: int) -> torch.Tensor:
    """y (R,) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M,); x in
    bf16 stays bf16, any other dtype goes in as f32."""
    xc, stream = _common(values, cols, x, chunk_cols, batched=False)
    _need(values.dtype in (torch.float32, torch.bfloat16)
          and values.shape == cols.shape,
          f"values must be float32 or bfloat16 {tuple(cols.shape)}, got "
          f"{values.dtype}{tuple(values.shape)}")
    r, k, lc = cols.shape
    out = torch.empty((r,), dtype=torch.float32, device=cols.device)
    if r == 0:
        return out
    rc = load_library().espim_spmv(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), xc.data_ptr(), int(xc.dtype == torch.bfloat16),
        out.data_ptr(), r, k, lc, int(chunk_cols), xc.shape[0], stream)
    _check_rc(rc, "espim_spmv")
    LAUNCHES["espim_spmv"] += 1
    return out


def _fp_values(values: torch.Tensor, cols: torch.Tensor) -> int:
    """1 for a bf16 value plane, 0 for float32 (the batched kernels widen
    bf16 values to f32 in the kernel, as the reference casts them)."""
    _need(values.dtype in (torch.float32, torch.bfloat16)
          and values.shape == cols.shape,
          f"values must be float32 or bfloat16 {tuple(cols.shape)}, got "
          f"{values.dtype}{tuple(values.shape)}")
    return int(values.dtype == torch.bfloat16)


def espim_spmv_batched_cuda(values: torch.Tensor, cols: torch.Tensor,
                            x: torch.Tensor, *, chunk_cols: int
                            ) -> torch.Tensor:
    """y (R, B) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M, B); a
    bf16 x is widened to f32."""
    xc, stream = _common(values, cols, x, chunk_cols)
    vbf16 = _fp_values(values, cols)
    r, k, lc = cols.shape
    m, b = xc.shape
    out = torch.empty((r, b), dtype=torch.float32, device=cols.device)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_fp(
        values.data_ptr(), vbf16, cols.data_ptr(), xc.data_ptr(),
        out.data_ptr(), r, k, lc, int(chunk_cols), m, b, stream)
    _check_rc(rc, "espim_spmv_batched")
    LAUNCHES["espim_spmv_batched"] += 1
    return out


def espim_spmv_batched_res_cuda(values: torch.Tensor, cols: torch.Tensor,
                                x: torch.Tensor, residual: torch.Tensor, *,
                                chunk_cols: int) -> torch.Tensor:
    """y (R, B) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M, B) +
    residual, the residual (R, B) f32 in packed row order, added in the
    same launch after each row's reduce."""
    xc, stream = _common(values, cols, x, chunk_cols,
                         extra=(("residual", residual),))
    vbf16 = _fp_values(values, cols)
    r, k, lc = cols.shape
    m, b = xc.shape
    _need(residual.dtype == torch.float32
          and tuple(residual.shape) == (r, b),
          f"residual must be float32 {(r, b)}, got "
          f"{residual.dtype}{tuple(residual.shape)}")
    out = torch.empty((r, b), dtype=torch.float32, device=cols.device)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_res_fp(
        values.data_ptr(), vbf16, cols.data_ptr(), xc.data_ptr(),
        residual.data_ptr(), out.data_ptr(), r, k, lc, int(chunk_cols), m, b,
        stream)
    _check_rc(rc, "espim_spmv_batched_res")
    LAUNCHES["espim_spmv_batched_res"] += 1
    return out


def espim_spmv_batched_quant_cuda(codes: torch.Tensor, cols: torch.Tensor,
                                  scales: torch.Tensor | None,
                                  x: torch.Tensor, *, chunk_cols: int,
                                  group_rows: int = 1) -> torch.Tensor:
    """y (R, B) f32 from int8 / nibble-packed codes; times
    ``scales[r // group_rows]`` after the reduce, or unscaled (the
    code-domain accumulator) when ``scales`` is None."""
    xc, stream = _common(codes, cols, x, chunk_cols,
                         extra=(("scales", scales),))
    nibble, lv = _codes_layout(codes, cols)
    r, k, lc = cols.shape
    if scales is not None:
        _need(scales.dtype == torch.float32 and scales.dim() == 1,
              f"scales must be float32 1-D, got {scales.dtype}")
        _need(group_rows >= 1 and scales.numel() * group_rows >= r,
              f"{scales.numel()} scales x group_rows={group_rows} do not "
              f"cover {r} rows")
    m, b = xc.shape
    out = torch.empty((r, b), dtype=torch.float32, device=cols.device)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_quant(
        codes.data_ptr(), nibble, lv, cols.data_ptr(),
        None if scales is None else scales.data_ptr(), max(1, group_rows),
        xc.data_ptr(), out.data_ptr(), r, k, lc, int(chunk_cols), m, b,
        stream)
    _check_rc(rc, "espim_spmv_batched_quant")
    LAUNCHES["espim_spmv_batched_quant"] += 1
    return out


def _act_id(act: str) -> int:
    try:
        return ACT_IDS[act]
    except KeyError:
        raise ValueError(f"unknown epilogue activation {act!r}") from None


def espim_spmv_batched_glu_cuda(values: torch.Tensor, cols: torch.Tensor,
                                x: torch.Tensor, *, chunk_cols: int,
                                act: str = "silu") -> torch.Tensor:
    """act(gate) * up (Rg, B) f32 from a half-major f32 or bf16 gate+up
    pack."""
    xc, stream = _common(values, cols, x, chunk_cols)
    vbf16 = _fp_values(values, cols)
    rg = _halves(cols)
    _, k, lc = cols.shape
    m, b = xc.shape
    act_id = _act_id(act)
    out = torch.empty((rg, b), dtype=torch.float32, device=cols.device)
    if rg == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_glu_fp(
        values.data_ptr(), vbf16, cols.data_ptr(), xc.data_ptr(),
        out.data_ptr(), rg, k, lc, int(chunk_cols), m, b, act_id, stream)
    _check_rc(rc, "espim_spmv_batched_glu")
    LAUNCHES["espim_spmv_batched_glu"] += 1
    return out


def espim_spmv_batched_quant_glu_cuda(codes: torch.Tensor,
                                      cols: torch.Tensor, srow: torch.Tensor,
                                      x: torch.Tensor, *, chunk_cols: int,
                                      act: str = "silu") -> torch.Tensor:
    """act(srow·gate) * (srow·up) (Rg, B) f32 from a half-major int8 /
    nibble-packed gate+up pack and per-row scales ``srow`` (2*Rg,)."""
    xc, stream = _common(codes, cols, x, chunk_cols, extra=(("srow", srow),))
    nibble, lv = _codes_layout(codes, cols)
    rg = _halves(cols)
    _need(srow.dtype == torch.float32 and tuple(srow.shape) == (2 * rg,),
          f"srow must be float32 ({2 * rg},), got "
          f"{srow.dtype}{tuple(srow.shape)}")
    _, k, lc = cols.shape
    m, b = xc.shape
    act_id = _act_id(act)
    out = torch.empty((rg, b), dtype=torch.float32, device=cols.device)
    if rg == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_quant_glu(
        codes.data_ptr(), nibble, lv, cols.data_ptr(), srow.data_ptr(),
        xc.data_ptr(), out.data_ptr(), rg, k, lc, int(chunk_cols), m, b,
        act_id, stream)
    _check_rc(rc, "espim_spmv_batched_quant_glu")
    LAUNCHES["espim_spmv_batched_quant_glu"] += 1
    return out
