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
  ``espim_spmv_batched_quant_glu_pallas``;
* ``espim_spmv_group_cuda`` runs one packed group's buckets of kernels
  1-4 in one launch, with the decode step's per-row scale, concatenation
  and take in its epilogue; it counts as one launch of the kernel it
  computes (``LAUNCHES["espim_spmv_batched_quant"]`` for an int8 or int4
  group, ``..._quant_glu`` for their gate+up group, and so on).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, then call their ``torch.ops.repro_torch`` op
(``kernels/library.py``), whose CUDA implementation allocates the
output, launches on the current stream, raises if the launch was
refused, and adds one to ``LAUNCHES[<kernel>]``; on fake tensors (a dry
run) the op's Meta implementation gives the output's shape and dtype and
launches nothing.  Their
plain versions live in ``kernels/ref.py``; ``kernels/ops.py`` picks
between the two by the tensors' device.  All six are bound by the bytes
of the value and index planes (see the source's header note).  Kernel 5
(``espim_spmv_cuda``) runs the source's mv body, built for B = 1, on the
launch plan ``_mv_plan`` computes here on the host (blocks, rows a
block, warps a row, the ring's stages and bytes, whether x is staged in
shared memory).  Kernels
1-4 (``espim_spmv_batched_cuda``, ``espim_spmv_batched_quant_cuda`` and
their GLU forms) and kernel 6 (the residual form) run the source's
ring body (planes streamed through a shared-memory ring by bulk
copies), whose C launcher picks the batch tile from B; any width,
alignment and B >= 1 is taken.  Their wrappers take the schedule's
``wpr`` (warps a row, a pair for the GLU kernels; 0 = the launcher's
default: one, or four for a row of more than 1024 slots) and ``u`` (the
ring's stages, up to u + 2 as shared memory allows: 1, 2 or 4 for
kernels 1-2, 2 for kernels 3, 4 and 6); the defaults are 0 and 2, and
any other value raises
(``core/sdds.schedule_legal``).  Kernels 1, 3 and 6 take float32 or
bfloat16 value planes (bf16 widened to f32 in the kernel) and x in f32
(a bf16 x is widened exactly by the wrapper).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.sdds import WARPS_PER_ROW, schedule_us
from repro_torch.kernels.build import load_library
from repro_torch.kernels.library import define

__all__ = ["LAUNCHES", "reset_launches", "ACT_IDS", "espim_spmv_cuda",
           "espim_spmv_batched_cuda", "espim_spmv_batched_res_cuda",
           "espim_spmv_batched_quant_cuda", "espim_spmv_batched_glu_cuda",
           "espim_spmv_batched_quant_glu_cuda", "espim_spmv_group_cuda",
           "MAX_BUCKETS"]

# kernel launches since the last reset, one plain integer per kernel
LAUNCHES = {"espim_spmv": 0, "espim_spmv_batched": 0,
            "espim_spmv_batched_res": 0, "espim_spmv_batched_quant": 0,
            "espim_spmv_batched_glu": 0, "espim_spmv_batched_quant_glu": 0}

ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2, "relu2": 3}

# buckets one grouped launch takes (kMaxBuckets); a group of more makes
# one launch per this many
MAX_BUCKETS = 8

# the C source's plane codes (enum Plane)
_PLANES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2,
           torch.bfloat16: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _common(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
            chunk_cols: int, extra=(), batched: bool = True) -> torch.Tensor:
    """Validate the operands every kernel shares; returns the contiguous
    x — (M, B) fp32, or for the unbatched kernel (M,) fp32 or bf16.  x
    is copied only when it is not already in that form; the decode path
    hands every bucket of a group one ready x
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
    return (x if keep else x.to(torch.float32)).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def _schedule(wpr: int, u: int, epilogue: str | None = None) -> tuple:
    """The (wpr, u) the C launcher takes; raises on a value no kernel is
    built for (an illegal schedule never becomes the default)."""
    if wpr not in WARPS_PER_ROW:
        raise ValueError(f"warps a row must be one of {WARPS_PER_ROW}, "
                         f"got {wpr}")
    if u not in schedule_us(epilogue):
        raise ValueError(f"u={u} is not built for this kernel (u in "
                         f"{schedule_us(epilogue)})")
    return int(wpr), int(u)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _halves(cols: torch.Tensor) -> int:
    _need(cols.shape[0] % 2 == 0,
          f"GLU needs a half-major (2*Rg, ...) pack; got {cols.shape[0]} rows")
    return cols.shape[0] // 2


def _out(cols: torch.Tensor, rows: int, x: torch.Tensor | None = None):
    """The f32 output, (rows,) or (rows, B) for a batched x."""
    shape = (rows,) if x is None else (rows, x.shape[1])
    return torch.empty(shape, dtype=torch.float32, device=cols.device)


# -- kernel 5's launch plan (csrc/espim_spmv.cu: espim_spmv_mv_kernel) -----
SM_COUNT = 132                  # an H100 SXM's SMs: the plan's default
SMEM_BLOCK = 232448             # shared memory a block may take (H100)
MV_SMEM = SMEM_BLOCK - 2048     # the dynamic part a plan gives (kSmemLimit)
MV_BAR_BYTES = 256              # the ring's barriers (kMvBarBytes)
MV_CONSUMERS = 16               # consumer warps a block (kMvConsumers)
MV_MAX_STAGES = 6               # kMvMaxStages
MV_STAGE_BYTES = 48 * 1024      # most bytes a stage
# a stage's least bytes: a piece of 4 slots x 128 lanes (a 4-warp team) at
# 8 plane bytes a slot, and the two spans' alignment slack
MV_MIN_STAGE = 4224
MV_WIDE_ROW_SLOTS = 1024        # a row of more slots: a team of 4 warps


class MvPlan(NamedTuple):
    """Kernel 5's launch: ``blocks`` blocks of ``MV_CONSUMERS`` + 1 warps;
    block j walks rows [j * rows_a_block, ...) (whole rows: no row spans
    blocks); a row is walked by ``team`` warps; the ring holds ``stages``
    stages of ``stage_bytes``, each ``tile_rows`` whole rows (0: a row
    goes through in pieces of ``piece`` slots); ``xstage``: x is copied
    into shared memory; ``smem_bytes``: the block's dynamic shared
    memory."""
    blocks: int
    rows_a_block: int
    team: int
    stages: int
    stage_bytes: int
    tile_rows: int
    piece: int
    xstage: bool
    smem_bytes: int


def _x_region(m: int, x_bytes: int) -> int:
    """Shared bytes x takes when staged: a head offset below 16 and its
    bytes, in 128-byte units (``mv_x_region``)."""
    return (m * x_bytes + 15 + 127) // 128 * 128


def mv_team(slots: int) -> int:
    """Warps that walk a row of ``slots`` padded slots (K * Lc): one, or
    four for a row of more than ``MV_WIDE_ROW_SLOTS``.  It reads the row's
    slots alone, so a row's sum order, and its bits, never depend on R,
    the grid or the card."""
    return 1 if slots <= MV_WIDE_ROW_SLOTS else 4


def _mv_stage(stage: int, slots: int, value_bytes: int,
              team: int) -> tuple[int, int]:
    """(tile_rows, piece) of a stage of ``stage`` bytes: the whole rows of
    ``slots`` slots it holds beside the two spans' 64 bytes of alignment
    slack, or, where none fits, the slots of a piece (0 otherwise): a
    multiple of 4 slots x the team's lanes."""
    row_bytes = slots * (4 + value_bytes)
    tile_rows = (stage - 64) // row_bytes if row_bytes else 0
    unit = 4 * 32 * team
    piece = 0 if tile_rows else \
        (stage - 64) // (4 + value_bytes) // unit * unit
    return tile_rows, piece


@functools.lru_cache(maxsize=256)
def _mv_plan(rows: int, n_chunks: int, lc: int, m: int,
             value_bytes: int = 4, x_bytes: int = 4,
             sms: int = SM_COUNT) -> MvPlan:
    """The plan of one kernel-5 launch over an (R, K, Lc) pack and an x of
    ``m`` elements (``value_bytes`` / ``x_bytes``: 4 f32, 2 bf16) on a card
    of ``sms`` SMs.  Rows a block fill the card (one block an SM at most,
    fewer for few rows); x is staged when it fits beside two least
    stages; of 2 .. ``MV_MAX_STAGES`` stages (each at most
    ``MV_STAGE_BYTES``, as the room allows) the count that holds the most
    whole rows in flight, fewer stages on a tie (rows longer than any
    stage: the most bytes in flight, in pieces)."""
    slots = n_chunks * lc
    team = mv_team(slots)
    xreg = _x_region(m, x_bytes)
    xstage = xreg + MV_BAR_BYTES + 2 * MV_MIN_STAGE <= MV_SMEM
    room = MV_SMEM - MV_BAR_BYTES - (xreg if xstage else 0)
    best = None
    for n in range(2, MV_MAX_STAGES + 1):
        stage = min(MV_STAGE_BYTES, room // n) // 128 * 128
        if stage < MV_MIN_STAGE:
            break
        tile_rows, _ = _mv_stage(stage, slots, value_bytes, team)
        key = (n * tile_rows, 0 if tile_rows else n * stage)
        if best is None or key > best[0]:
            best = (key, n, stage)
    _, stages, stage = best
    tile_rows, piece = _mv_stage(stage, slots, value_bytes, team)
    rows_a_block = -(-rows // sms) if rows else 0
    blocks = -(-rows // rows_a_block) if rows else 0
    return MvPlan(blocks, rows_a_block, team, stages, stage, tile_rows, piece,
                  xstage,
                  MV_BAR_BYTES + stages * stage + (xreg if xstage else 0))


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


# -- the ops: the CUDA launch and the Meta shape of each kernel ------------
def _spmv_launch(values, cols, x, chunk_cols):
    r, k, lc = cols.shape
    out = _out(cols, r)
    if r == 0 or k * lc == 0 or x.shape[0] == 0:
        return out.zero_()          # no slot reaches x: every row sums to 0
    plan = _mv_plan(r, k, lc, x.shape[0], values.element_size(),
                    x.element_size(), _sm_count(cols.device))
    rc = load_library().espim_spmv(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
        out.data_ptr(), r, k, lc, chunk_cols, x.shape[0],
        *plan[:-1], _stream(cols))
    _check_rc(rc, "espim_spmv")
    return out


_spmv = define("espim_spmv(Tensor values, Tensor cols, Tensor x, "
               "int chunk_cols) -> Tensor", _spmv_launch,
               lambda values, cols, x, cc: _out(cols, cols.shape[0]),
               lambda values, cols, x, cc: 2 * cols.numel())


def _batched_launch(values, cols, x, chunk_cols, wpr, u):
    r, k, lc = cols.shape
    m, b = x.shape
    out = _out(cols, r, x)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_fp(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), x.data_ptr(), out.data_ptr(), r, k, lc, chunk_cols,
        m, b, wpr, u, _stream(cols))
    _check_rc(rc, "espim_spmv_batched")
    return out


def _slots_b(values, cols, x, *rest):
    return 2 * cols.numel() * x.shape[1]


_batched = define("espim_spmv_batched(Tensor values, Tensor cols, Tensor x, "
                  "int chunk_cols, int wpr, int u) -> Tensor",
                  _batched_launch,
                  lambda values, cols, x, *_: _out(cols, cols.shape[0], x),
                  _slots_b)


def _res_launch(values, cols, x, residual, chunk_cols, wpr, u):
    r, k, lc = cols.shape
    m, b = x.shape
    out = _out(cols, r, x)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_res_fp(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), x.data_ptr(), residual.data_ptr(), out.data_ptr(),
        r, k, lc, chunk_cols, m, b, wpr, u, _stream(cols))
    _check_rc(rc, "espim_spmv_batched_res")
    return out


_res = define("espim_spmv_batched_res(Tensor values, Tensor cols, Tensor x, "
              "Tensor residual, int chunk_cols, int wpr, int u) -> Tensor",
              _res_launch,
              lambda values, cols, x, *_: _out(cols, cols.shape[0], x),
              _slots_b)


def _quant_launch(codes, cols, scales, x, chunk_cols, group_rows, wpr, u):
    nibble, lv = _codes_layout(codes, cols)
    r, k, lc = cols.shape
    m, b = x.shape
    out = _out(cols, r, x)
    if r == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_quant(
        codes.data_ptr(), nibble, lv, cols.data_ptr(),
        None if scales is None else scales.data_ptr(), group_rows,
        x.data_ptr(), out.data_ptr(), r, k, lc, chunk_cols, m, b, wpr, u,
        _stream(cols))
    _check_rc(rc, "espim_spmv_batched_quant")
    return out


_quant = define("espim_spmv_batched_quant(Tensor codes, Tensor cols, "
                "Tensor? scales, Tensor x, int chunk_cols, int group_rows, "
                "int wpr, int u) -> Tensor", _quant_launch,
                lambda codes, cols, scales, x, *_:
                _out(cols, cols.shape[0], x),
                lambda codes, cols, scales, x, *_:
                2 * cols.numel() * x.shape[1])


def _glu_launch(values, cols, x, chunk_cols, act, wpr, u):
    rg, (_, k, lc) = cols.shape[0] // 2, cols.shape
    m, b = x.shape
    out = _out(cols, rg, x)
    if rg == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_glu_fp(
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        cols.data_ptr(), x.data_ptr(), out.data_ptr(), rg, k, lc, chunk_cols,
        m, b, act, wpr, u, _stream(cols))
    _check_rc(rc, "espim_spmv_batched_glu")
    return out


_glu = define("espim_spmv_batched_glu(Tensor values, Tensor cols, Tensor x, "
              "int chunk_cols, int act, int wpr, int u) -> Tensor",
              _glu_launch,
              lambda values, cols, x, *_: _out(cols, cols.shape[0] // 2, x),
              _slots_b)


def _quant_glu_launch(codes, cols, srow, x, chunk_cols, act, wpr, u):
    nibble, lv = _codes_layout(codes, cols)
    rg, (_, k, lc) = cols.shape[0] // 2, cols.shape
    m, b = x.shape
    out = _out(cols, rg, x)
    if rg == 0 or b == 0:
        return out
    rc = load_library().espim_spmv_batched_quant_glu(
        codes.data_ptr(), nibble, lv, cols.data_ptr(), srow.data_ptr(),
        x.data_ptr(), out.data_ptr(), rg, k, lc, chunk_cols, m, b, act, wpr,
        u, _stream(cols))
    _check_rc(rc, "espim_spmv_batched_quant_glu")
    return out


_quant_glu = define("espim_spmv_batched_quant_glu(Tensor codes, Tensor cols, "
                    "Tensor srow, Tensor x, int chunk_cols, int act, int wpr, "
                    "int u) -> Tensor", _quant_glu_launch,
                    lambda codes, cols, srow, x, *_:
                    _out(cols, cols.shape[0] // 2, x),
                    lambda codes, cols, srow, x, *_:
                    2 * cols.numel() * x.shape[1])


def _group_kernel(values, act: int) -> str:
    """The ``LAUNCHES`` key of a grouped launch: the per-bucket kernel it
    computes."""
    quant = values[0].dtype in (torch.int8, torch.uint8)
    return ("espim_spmv_batched_quant" if quant else
            "espim_spmv_batched") + ("_glu" if act >= 0 else "")


def _group_launch(x, values, cols, srow, perm, n_out, chunk_cols, act, wpr,
                  u):
    m, b = x.shape
    out = _out(cols[0], n_out, x)
    n = len(cols)
    if n_out == 0 or b == 0:
        return out
    glu = act >= 0
    shapes = []
    for v, c in zip(values, cols):
        r, k, lc = c.shape
        shapes += [r // 2 if glu else r, k, lc, v.shape[-1]]
    ptrs = ctypes.c_void_p * n
    vp = ptrs(*[v.data_ptr() for v in values])
    cp = ptrs(*[c.data_ptr() for c in cols])
    sp = ptrs(*[s.data_ptr() for s in srow]) if srow else None
    sh = (ctypes.c_int * (4 * n))(*shapes)
    rc = load_library().espim_spmv_group(
        _PLANES[values[0].dtype], int(glu), n, ctypes.addressof(vp),
        ctypes.addressof(cp), None if sp is None else ctypes.addressof(sp),
        ctypes.addressof(sh), x.data_ptr(),
        None if perm is None else perm.data_ptr(), out.data_ptr(),
        chunk_cols, m, b, max(act, 0), wpr, u, _stream(x))
    name = _group_kernel(values, act)
    if rc != 0:
        raise RuntimeError(f"{name} (grouped) launch failed: cudaError {rc}")
    LAUNCHES[name] += -(-n // MAX_BUCKETS)
    return out


def _group_flops(x, values, cols, *rest):
    return 2 * sum(c.numel() for c in cols) * x.shape[1]


_group = define("espim_spmv_group(Tensor x, Tensor[] values, Tensor[] cols, "
                "Tensor[] srow, Tensor? perm, int n_out, int chunk_cols, "
                "int act, int wpr, int u) -> Tensor", _group_launch,
                lambda x, values, cols, srow, perm, n_out, *_:
                _out(cols[0], n_out, x),
                _group_flops)


# -- the wrappers ----------------------------------------------------------
def espim_spmv_cuda(values: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor, *, chunk_cols: int) -> torch.Tensor:
    """y (R,) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M,); x in
    bf16 stays bf16, any other dtype goes in as f32."""
    xc = _common(values, cols, x, chunk_cols, batched=False)
    _need(values.dtype in (torch.float32, torch.bfloat16)
          and values.shape == cols.shape,
          f"values must be float32 or bfloat16 {tuple(cols.shape)}, got "
          f"{values.dtype}{tuple(values.shape)}")
    return _spmv(values, cols, xc, int(chunk_cols))


def _fp_values(values: torch.Tensor, cols: torch.Tensor) -> None:
    """The batched kernels take a float32 or bfloat16 value plane (bf16
    widened to f32 in the kernel, as the reference casts it)."""
    _need(values.dtype in (torch.float32, torch.bfloat16)
          and values.shape == cols.shape,
          f"values must be float32 or bfloat16 {tuple(cols.shape)}, got "
          f"{values.dtype}{tuple(values.shape)}")


def espim_spmv_batched_cuda(values: torch.Tensor, cols: torch.Tensor,
                            x: torch.Tensor, *, chunk_cols: int,
                            wpr: int = 0, u: int = 2) -> torch.Tensor:
    """y (R, B) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M, B); a
    bf16 x is widened to f32."""
    sched = _schedule(wpr, u)
    xc = _common(values, cols, x, chunk_cols)
    _fp_values(values, cols)
    return _batched(values, cols, xc, int(chunk_cols), *sched)


def espim_spmv_batched_res_cuda(values: torch.Tensor, cols: torch.Tensor,
                                x: torch.Tensor, residual: torch.Tensor, *,
                                chunk_cols: int, wpr: int = 0, u: int = 2
                                ) -> torch.Tensor:
    """y (R, B) f32 = chunked-ELL(values f32 | bf16, cols) @ x (M, B) +
    residual, the residual (R, B) f32 in packed row order, added in the
    same launch after each row's reduce."""
    sched = _schedule(wpr, u, "residual")
    xc = _common(values, cols, x, chunk_cols,
                 extra=(("residual", residual),))
    _fp_values(values, cols)
    r, b = cols.shape[0], xc.shape[1]
    _need(residual.dtype == torch.float32
          and tuple(residual.shape) == (r, b),
          f"residual must be float32 {(r, b)}, got "
          f"{residual.dtype}{tuple(residual.shape)}")
    return _res(values, cols, xc, residual, int(chunk_cols), *sched)


def espim_spmv_batched_quant_cuda(codes: torch.Tensor, cols: torch.Tensor,
                                  scales: torch.Tensor | None,
                                  x: torch.Tensor, *, chunk_cols: int,
                                  group_rows: int = 1, wpr: int = 0,
                                  u: int = 2) -> torch.Tensor:
    """y (R, B) f32 from int8 / nibble-packed codes; times
    ``scales[r // group_rows]`` after the reduce, or unscaled (the
    code-domain accumulator) when ``scales`` is None."""
    sched = _schedule(wpr, u)
    xc = _common(codes, cols, x, chunk_cols, extra=(("scales", scales),))
    _codes_layout(codes, cols)
    r = cols.shape[0]
    if scales is not None:
        _need(scales.dtype == torch.float32 and scales.dim() == 1,
              f"scales must be float32 1-D, got {scales.dtype}")
        _need(group_rows >= 1 and scales.numel() * group_rows >= r,
              f"{scales.numel()} scales x group_rows={group_rows} do not "
              f"cover {r} rows")
    return _quant(codes, cols, scales, xc, int(chunk_cols),
                  max(1, group_rows), *sched)


def _act_id(act: str) -> int:
    try:
        return ACT_IDS[act]
    except KeyError:
        raise ValueError(f"unknown epilogue activation {act!r}") from None


def espim_spmv_batched_glu_cuda(values: torch.Tensor, cols: torch.Tensor,
                                x: torch.Tensor, *, chunk_cols: int,
                                act: str = "silu", wpr: int = 0, u: int = 2
                                ) -> torch.Tensor:
    """act(gate) * up (Rg, B) f32 from a half-major f32 or bf16 gate+up
    pack; ``wpr`` counts warps a pair."""
    sched = _schedule(wpr, u, "glu")
    xc = _common(values, cols, x, chunk_cols)
    _fp_values(values, cols)
    _halves(cols)
    return _glu(values, cols, xc, int(chunk_cols), _act_id(act), *sched)


def espim_spmv_batched_quant_glu_cuda(codes: torch.Tensor,
                                      cols: torch.Tensor, srow: torch.Tensor,
                                      x: torch.Tensor, *, chunk_cols: int,
                                      act: str = "silu", wpr: int = 0,
                                      u: int = 2) -> torch.Tensor:
    """act(srow·gate) * (srow·up) (Rg, B) f32 from a half-major int8 /
    nibble-packed gate+up pack and per-row scales ``srow`` (2*Rg,);
    ``wpr`` counts warps a pair."""
    sched = _schedule(wpr, u, "glu")
    xc = _common(codes, cols, x, chunk_cols, extra=(("srow", srow),))
    _codes_layout(codes, cols)
    rg = _halves(cols)
    _need(srow.dtype == torch.float32 and tuple(srow.shape) == (2 * rg,),
          f"srow must be float32 ({2 * rg},), got "
          f"{srow.dtype}{tuple(srow.shape)}")
    return _quant_glu(codes, cols, srow, xc, int(chunk_cols), _act_id(act),
                      *sched)


def espim_spmv_group_cuda(values: list, cols: list, x: torch.Tensor, *,
                          chunk_cols: int, srow: list | None = None,
                          perm: torch.Tensor | None = None,
                          n_out: int | None = None, act: str | None = None,
                          wpr: int = 0, u: int = 2) -> torch.Tensor:
    """One packed group's buckets in one launch -> (n_out, B) f32.

    ``values`` / ``cols``: each bucket's (R_i, K, Lc_i) planes, all f32,
    all bf16, all int8 or all nibble-packed uint8 (int4); ``srow``: each
    bucket's per-row scales (R_i,) f32, multiplied once after the sum, or
    None; ``act``: the buckets are half-major gate+up planes and the
    output is act(gate * sg) * (up * su) (R_i / 2 rows each); ``perm``:
    (sum of output rows,) int32 packed row -> output row, -1 for a pad
    row (a ``take`` group; pad rows are not stored), ``n_out`` the output
    rows (default: the buckets' output rows, concatenated in order)."""
    glu = act is not None
    sched = _schedule(wpr, u, "glu" if glu else None)
    _need(len(values) == len(cols) and len(cols) > 0,
          f"{len(values)} value planes for {len(cols)} index planes")
    extra = [(f"values[{i}]", v) for i, v in enumerate(values)]
    extra += [(f"cols[{i}]", c) for i, c in enumerate(cols)]
    extra += [(f"srow[{i}]", s) for i, s in enumerate(srow or ())]
    extra += [("perm", perm)]
    xc = _common(values[0], cols[0], x, chunk_cols, extra=extra)
    dt = values[0].dtype
    _need(dt in _PLANES, f"values must be f32, bf16, int8 or uint8, got {dt}")
    rows = 0
    for i, (v, c) in enumerate(zip(values, cols)):
        _need(v.dtype == dt, f"values[{i}] is {v.dtype}, values[0] {dt}")
        _need(c.dtype == torch.int32 and c.dim() == 3,
              f"cols[{i}] must be int32 (R, K, Lc), got "
              f"{c.dtype}{tuple(c.shape)}")
        _need(c.numel() < 2 ** 31, "plane too large for 32-bit slot offsets")
        if dt in (torch.int8, torch.uint8):
            _codes_layout(v, c)
        else:
            _fp_values(v, c)
        r = _halves(c) if glu else c.shape[0]
        if srow is not None:
            s = srow[i]
            _need(s.dtype == torch.float32
                  and tuple(s.shape) == (c.shape[0],),
                  f"srow[{i}] must be float32 ({c.shape[0]},), got "
                  f"{s.dtype}{tuple(s.shape)}")
        rows += r
    _need(srow is None or len(srow) == len(cols),
          f"{len(srow or ())} srow planes for {len(cols)} buckets")
    if perm is not None:
        _need(perm.dtype == torch.int32 and tuple(perm.shape) == (rows,),
              f"perm must be int32 ({rows},), got "
              f"{perm.dtype}{tuple(perm.shape)}")
        _need(n_out is not None, "a take group needs n_out")
    n_out = rows if n_out is None else int(n_out)
    return _group(xc, list(values), list(cols), list(srow or ()), perm,
                  n_out, int(chunk_cols), -1 if act is None else _act_id(act),
                  *sched)
