"""ESPIM packed sparse formats — the TPU adaptation of Section III-B/C.

The paper packs k=11 consecutive sparse rows per DRAM row (fine-grained
interleaving) so one 16-element vector-slice broadcast is reused by all k
rows, and lets SDDS pad the compressed matrix with invalid cells where the
schedule stalls.  On TPU the equivalent packing is a *row-tile ELL* layout:

  values[R_pad, L], cols[R_pad, L]   (L = padded nnz per row)

where a row-tile of 128 rows (lane width) shares the VMEM residency of the
dense activation vector ``x`` — the broadcast analogue — and the ELL padding
slots are the static stalls.  SparTen balancing (``row_tile_balance``)
permutes rows so every tile's max nnz, and therefore L, is near the mean:
this is the load-balance contribution doing exactly its original job of
minimizing dead slots.

The *column-chunked* refinement (``pack_ell_chunked``, DESIGN.md section 3)
applies the paper's broadcast-slice discipline to ``x`` itself: each row's
cells are grouped by ``chunk_cols``-wide column chunk (the SDDS pass
``repro_torch.core.sdds.chunk_cells``), stored chunk-major with *chunk-local*
column ids, so a (row-tile x col-chunk) kernel block only ever reads one
``x`` slab — bounding VMEM residency at ``chunk_cols`` elements instead of
the whole activation vector.

The serving stack consumes the *width-bucketed, layer-stacked* form
(``pack_bucketed_stack``, DESIGN.md section 8): all layers of a projection
group — optionally two row-concatenated halves (gate+up) under one shared
balance permutation — packed to uniform per-bucket shapes so a
``lax.scan`` over layers consumes them directly, with 2-4 per-bucket ELL
widths (the SDDS ``plan_width_buckets`` pass) instead of one stack-global
max.

All packing is offline host-side numpy (it is part of SDDS compilation);
kernels consume the arrays as jnp inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import integrity
from repro_torch.core.pruning import row_tile_balance
from repro_torch.core.sdds import (ChunkPlan, WidthBucketPlan, chunk_cells,
                             plan_chunks, plan_width_buckets)

__all__ = [
    "PackStats",
    "ELLPack",
    "ELLChunkedPack",
    "BucketedStackedPack",
    "pack_ell",
    "pack_ell_chunked",
    "chunk_pack",
    "pack_bucketed_stack",
    "pack_group",
    "compose_cols_with_pack",
    "projection_padded_slots",
    "ell_to_dense",
    "ell_chunked_to_dense",
    "bucketed_stack_to_dense",
    "shard_ell",
]

LANE = 128  # TPU lane width: the adaptation of the paper's 16-elt slice


@dataclasses.dataclass(frozen=True)
class PackStats:
    n_rows: int
    n_cols: int
    nnz: int
    ell_width: int          # L
    padded_slots: int       # R_pad * L
    padding_frac: float     # 1 - nnz / padded_slots  (the "stall" fraction)
    density: float
    tile_widths: tuple      # per-tile max nnz before global padding
    # value-plane storage override: None = fp32 (4 bytes per slot); a
    # quantized pack replaces it with the packed size (repro_torch.quant.qpack)
    value_bytes: int | None = None

    @property
    def value_plane_bytes(self) -> int:
        """Bytes the value plane occupies in the stored format."""
        return (4 * self.padded_slots if self.value_bytes is None
                else self.value_bytes)

    @property
    def index_plane_bytes(self) -> int:
        """Bytes the index plane occupies (int32 chunk-local col ids) —
        untouched by quantization, per the paper's value/index decoupling."""
        return 4 * self.padded_slots

    @property
    def bits_per_nnz(self) -> float:
        """Value-plane bits per useful cell — the bytes/nnz crossing the
        pin that the paper's narrow fixed-point values optimize (padding
        slots and scale overhead charged to the nnz they serve)."""
        return 8.0 * self.value_plane_bytes / max(1, self.nnz)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"PackStats({self.n_rows}x{self.n_cols}, nnz={self.nnz}, "
            f"L={self.ell_width}, pad={self.padding_frac:.3f}, "
            f"bits/nnz={self.bits_per_nnz:.1f})"
        )


@dataclasses.dataclass
class ELLPack:
    """Row-tile ELL pack of a sparse matrix W (n_rows x n_cols).

    Rows are permuted by ``perm`` (packed position -> original row id;
    -1 marks pad rows added to round up to the row tile).  ``cols`` is
    column-ascending per row (the paper's slice order); pad slots have
    ``valid == False``, ``values == 0``, ``cols == 0``.
    """

    values: np.ndarray  # (R_pad, L) float32
    cols: np.ndarray    # (R_pad, L) int32
    valid: np.ndarray   # (R_pad, L) bool
    perm: np.ndarray    # (R_pad,) int64
    n_rows: int
    n_cols: int
    row_tile: int
    stats: PackStats
    qplane: object = None   # QuantizedValuePlane (repro_torch.quant.qpack)
    # build-time per-plane digests + bound pack digest (core.integrity);
    # None only for hand-assembled packs that bypass the builders
    fingerprint: dict | None = None

    @property
    def r_pad(self) -> int:
        return self.values.shape[0]

    @property
    def ell_width(self) -> int:
        return self.values.shape[1]

    def scatter_rows(self, y_packed: np.ndarray) -> np.ndarray:
        """Map packed-row outputs back to original row order."""
        return _scatter_packed_rows(self.perm, self.n_rows, y_packed)

    def gather_perm(self) -> np.ndarray:
        """Inverse permutation: original row id -> packed position."""
        inv = np.full(self.n_rows, -1, dtype=np.int64)
        keep = self.perm >= 0
        inv[self.perm[keep]] = np.nonzero(keep)[0]
        return inv


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scatter_packed_rows(perm: np.ndarray, n_rows: int,
                         y_packed: np.ndarray) -> np.ndarray:
    """Packed-order outputs -> original row order (perm < 0 = pad row)."""
    out_shape = (n_rows,) + tuple(y_packed.shape[1:])
    y = np.zeros(out_shape, dtype=y_packed.dtype)
    keep = perm >= 0
    y[perm[keep]] = y_packed[keep]
    return y


def pack_ell(
    w: np.ndarray,
    row_tile: int = LANE,
    balance: bool = True,
    width_multiple: int = 8,
) -> ELLPack:
    """Pack a (possibly sparse) dense-storage matrix into row-tile ELL.

    ``width_multiple`` rounds L up for sublane-aligned VMEM tiles (the
    analogue of the paper's column-granular reads).
    """
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {w.shape}")
    n_rows, n_cols = w.shape
    nnz_per_row = (w != 0).sum(axis=1)
    nnz = int(nnz_per_row.sum())

    if balance and n_rows > 1:
        perm_rows = row_tile_balance(nnz_per_row, row_tile)
    else:
        perm_rows = np.arange(n_rows, dtype=np.int64)

    r_pad = _round_up(max(n_rows, 1), row_tile)
    perm = np.full(r_pad, -1, dtype=np.int64)
    perm[:n_rows] = perm_rows

    ell_w = int(nnz_per_row.max()) if n_rows else 0
    ell_w = max(width_multiple, _round_up(max(ell_w, 1), width_multiple))

    values = np.zeros((r_pad, ell_w), dtype=np.float32)
    cols = np.zeros((r_pad, ell_w), dtype=np.int32)
    valid = np.zeros((r_pad, ell_w), dtype=bool)

    tile_widths = []
    for t in range(0, r_pad, row_tile):
        tile_max = 0
        for i in range(t, min(t + row_tile, r_pad)):
            src = perm[i]
            if src < 0:
                continue
            (nz,) = np.nonzero(w[src])
            tile_max = max(tile_max, nz.size)
            values[i, : nz.size] = w[src, nz]
            cols[i, : nz.size] = nz
            valid[i, : nz.size] = True
        tile_widths.append(tile_max)

    padded = r_pad * ell_w
    stats = PackStats(
        n_rows=n_rows,
        n_cols=n_cols,
        nnz=nnz,
        ell_width=ell_w,
        padded_slots=padded,
        padding_frac=1.0 - (nnz / padded if padded else 0.0),
        density=nnz / max(1, n_rows * n_cols),
        tile_widths=tuple(tile_widths),
    )
    pack = ELLPack(
        values=values,
        cols=cols,
        valid=valid,
        perm=perm,
        n_rows=n_rows,
        n_cols=n_cols,
        row_tile=row_tile,
        stats=stats,
    )
    pack.fingerprint = integrity.fingerprint_pack(pack)
    return pack


@dataclasses.dataclass
class ELLChunkedPack:
    """Column-chunked row-tile ELL pack (the fused-kernel layout).

    ``values``/``cols``/``valid`` are (R_pad, n_chunks, chunk_width); cell
    (i, k, l) belongs to column chunk k and ``cols`` holds the
    *chunk-local* column id in [0, chunk_cols), so a kernel block gathers
    straight into the k-th ``x`` slab.  Within a chunk, cells keep
    ascending column order (``chunk_cells`` is stable).  Pad slots have
    ``valid == False``, ``values == 0``, ``cols == 0``.
    """

    values: np.ndarray      # (R_pad, K, Lc) float32
    cols: np.ndarray        # (R_pad, K, Lc) int32, chunk-local
    valid: np.ndarray       # (R_pad, K, Lc) bool
    perm: np.ndarray        # (R_pad,) int64, -1 = pad row
    n_rows: int
    n_cols: int
    row_tile: int
    chunk_cols: int
    stats: PackStats
    plan: ChunkPlan
    qplane: object = None   # QuantizedValuePlane (repro_torch.quant.qpack)
    fingerprint: dict | None = None     # see ELLPack.fingerprint
    # The tuned kernel schedule this layout was chunked under (a
    # repro_torch.autotune.TunedPlan), or None for the hand-picked default.
    # Advisory metadata: integrity fingerprints deliberately exclude it
    # (the pack bytes are what they are regardless of who chose Lc), so
    # carrying a plan never invalidates an existing fingerprint.
    schedule: object = None

    @property
    def r_pad(self) -> int:
        return self.values.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.values.shape[1]

    @property
    def chunk_width(self) -> int:
        return self.values.shape[2]

    def scatter_rows(self, y_packed: np.ndarray) -> np.ndarray:
        """Map packed-row outputs back to original row order."""
        return _scatter_packed_rows(self.perm, self.n_rows, y_packed)


def chunk_pack(pack: ELLPack, chunk_cols: int,
               width_multiple: int = 8,
               schedule=None) -> ELLChunkedPack:
    """Re-layout a row-tile ELL pack into the column-chunked format.

    Runs the SDDS chunk pass (``chunk_cells``) per packed row: cells are
    grouped chunk-major, column ids are rebased to the chunk, and the
    uniform chunk width Lc is the global max per-(row, chunk) count
    rounded to ``width_multiple`` (the lockstep-width discipline of the
    plain pack, applied per chunk).

    ``schedule`` optionally records the autotuned plan that picked this
    ``chunk_cols`` (carried on the pack as advisory metadata, excluded
    from the integrity fingerprint).
    """
    if chunk_cols <= 0:
        raise ValueError(f"chunk_cols must be positive, got {chunk_cols}")
    chunk_cols = min(chunk_cols, max(1, pack.n_cols))
    n_chunks = -(-max(pack.n_cols, 1) // chunk_cols)
    r_pad = pack.r_pad

    row_cols = []
    row_vals = []
    counts = np.zeros((r_pad, n_chunks), dtype=np.int64)
    for i in range(r_pad):
        sel = pack.valid[i]
        c = pack.cols[i, sel].astype(np.int64)
        v = pack.values[i, sel]
        order, cnt = chunk_cells(c, chunk_cols, n_chunks)
        row_cols.append(c[order])
        row_vals.append(v[order])
        counts[i] = cnt

    plan = plan_chunks(counts, chunk_cols=chunk_cols,
                       row_tile=pack.row_tile, n_cols=pack.n_cols,
                       width_multiple=width_multiple)
    lc = plan.chunk_width
    values = np.zeros((r_pad, n_chunks, lc), dtype=np.float32)
    cols = np.zeros((r_pad, n_chunks, lc), dtype=np.int32)
    valid = np.zeros((r_pad, n_chunks, lc), dtype=bool)
    for i in range(r_pad):
        off = 0
        for k in range(n_chunks):
            n = counts[i, k]
            if n:
                seg = slice(off, off + n)
                values[i, k, :n] = row_vals[i][seg]
                cols[i, k, :n] = row_cols[i][seg] - k * chunk_cols
                valid[i, k, :n] = True
                off += n

    stats = dataclasses.replace(
        pack.stats,
        ell_width=n_chunks * lc,
        padded_slots=r_pad * n_chunks * lc,
        padding_frac=plan.chunk_pad_frac,
    )
    out = ELLChunkedPack(
        values=values,
        cols=cols,
        valid=valid,
        perm=pack.perm.copy(),
        n_rows=pack.n_rows,
        n_cols=pack.n_cols,
        row_tile=pack.row_tile,
        chunk_cols=chunk_cols,
        stats=stats,
        plan=plan,
        schedule=schedule,
    )
    out.fingerprint = integrity.fingerprint_pack(out)
    return out


def pack_ell_chunked(
    w: np.ndarray,
    row_tile: int = LANE,
    chunk_cols: int = 512,
    balance: bool = True,
    width_multiple: int = 8,
) -> ELLChunkedPack:
    """Pack a dense-storage matrix straight into column-chunked ELL.

    ``chunk_cols`` is the VMEM slab of ``x`` one kernel block consumes —
    the TPU analogue of the paper's 16-element broadcast slice (scaled up
    to amortize DMA, default 512 = 2KB f32 per lane).
    """
    return chunk_pack(
        pack_ell(w, row_tile=row_tile, balance=balance,
                 width_multiple=width_multiple),
        chunk_cols,
        width_multiple=width_multiple,
    )


@dataclasses.dataclass
class BucketedStackedPack:
    """Width-bucketed, layer-stacked, (optionally) half-fused chunked ELL.

    The serving-stack layout: all ``L`` layers of one projection group are
    packed into uniform arrays (so a ``lax.scan`` over layers consumes them
    directly) and the packed rows are split into <= ``n_buckets``
    contiguous segments, each padded to its own ELL width (the SDDS
    ``plan_width_buckets`` pass) instead of one stack-global max.

    ``halves > 1`` row-concatenates several same-shape matrices (gate and
    up) that share one balance permutation: bucket ``g`` stores
    ``halves * bucket_rows[g]`` packed rows ordered half-major
    ([gate rows of the bucket; up rows of the bucket]), so one SpMV launch
    computes both projections and their outputs pair up elementwise in
    packed order — no unscatter between gate*up and the down projection.

    * ``buckets[g]['values'|'cols'|'valid']``: (L, halves*Rg, K, Lc_g);
      ``cols`` chunk-local as in ``ELLChunkedPack``.
    * ``perm``: (L, r_pad) packed position -> logical row (-1 = pad),
      shared by every half of a layer.
    * ``inv_perm``: (L, n_rows) logical row -> packed position.
    """

    buckets: list           # [{values, cols, valid} ...] numpy arrays
    bucket_rows: tuple      # Rg per bucket (per half); sums to r_pad
    halves: int
    perm: np.ndarray        # (L, r_pad) int64
    inv_perm: np.ndarray    # (L, n_rows) int64
    n_rows: int             # logical rows per half
    n_cols: int             # gather domain (x length the pack consumes)
    chunk_cols: int
    row_tile: int
    plan: WidthBucketPlan
    nnz_per_layer: np.ndarray       # (L,) over all halves
    nnz_per_half: np.ndarray        # (halves, L)
    qplanes: list | None = None     # per-bucket QuantizedValuePlane
    fingerprint: dict | None = None  # see ELLPack.fingerprint

    @property
    def n_layers(self) -> int:
        return self.perm.shape[0]

    @property
    def r_pad(self) -> int:
        return self.perm.shape[1]

    @property
    def n_chunks(self) -> int:
        return self.buckets[0]["values"].shape[2]

    @property
    def widths(self) -> tuple:
        return tuple(b["values"].shape[3] for b in self.buckets)

    @property
    def padded_slots_per_layer(self) -> int:
        return sum(self.halves * rg * self.n_chunks * lc
                   for rg, lc in zip(self.bucket_rows, self.widths))

    @property
    def nnz(self) -> int:
        return int(self.nnz_per_layer.sum())

    @property
    def pad_frac(self) -> float:
        padded = self.padded_slots_per_layer * self.n_layers
        return 1.0 - (self.nnz / padded if padded else 0.0)

    def pad_frac_layer(self, l: int) -> float:
        padded = self.padded_slots_per_layer
        return 1.0 - (float(self.nnz_per_layer[l]) / padded if padded else 0.0)


def pack_bucketed_stack(
    mats: list,
    row_tile: int = LANE,
    chunk_cols: int = 512,
    n_buckets: int = 4,
    width_multiple: int = 8,
    balance: bool = True,
    group_rows: int = 32,
) -> BucketedStackedPack:
    """Pack ``mats[half][layer]`` (each (n_rows, n_cols)) into one
    width-bucketed stack.

    Per layer the halves are balanced on their *combined* per-row nnz (one
    shared permutation, the gate+up fusion contract); cells are grouped by
    column chunk with local ids (``chunk_cells``); bucket boundaries are
    chosen once for the whole stack by ``plan_width_buckets`` over per-row-
    group max cell counts taken across layers, halves and chunks.
    """
    halves = len(mats)
    n_layers = len(mats[0])
    if any(len(h) != n_layers for h in mats):
        raise ValueError("every half must hold the same number of layers")
    n_rows, n_cols = np.asarray(mats[0][0]).shape
    for h in mats:
        for m in h:
            if np.asarray(m).shape != (n_rows, n_cols):
                raise ValueError("all matrices in a stack must share shape")

    r_pad = _round_up(max(n_rows, 1), row_tile)
    cc = min(chunk_cols, max(1, n_cols))
    n_chunks = -(-max(n_cols, 1) // cc)
    group = math.gcd(r_pad, group_rows) or 1

    perm = np.full((n_layers, r_pad), -1, dtype=np.int64)
    inv_perm = np.zeros((n_layers, n_rows), dtype=np.int64)
    counts = np.zeros((n_layers, halves, r_pad, n_chunks), dtype=np.int64)
    cells: list = [[[None] * r_pad for _ in range(halves)]
                   for _ in range(n_layers)]
    nnz_per_half = np.zeros((halves, n_layers), dtype=np.int64)

    for l in range(n_layers):
        ms = [np.asarray(mats[h][l]) for h in range(halves)]
        joint_nnz = sum((m != 0).sum(axis=1) for m in ms)
        if balance and n_rows > 1:
            perm_rows = row_tile_balance(joint_nnz, row_tile)
        else:
            perm_rows = np.arange(n_rows, dtype=np.int64)
        perm[l, :n_rows] = perm_rows
        inv_perm[l, perm_rows] = np.arange(n_rows, dtype=np.int64)
        for h, m in enumerate(ms):
            nnz_per_half[h, l] = int((m != 0).sum())
            for i in range(n_rows):
                src = perm_rows[i]
                (nz,) = np.nonzero(m[src])
                order, cnt = chunk_cells(nz, cc, n_chunks)
                cells[l][h][i] = (nz[order], m[src, nz][order])
                counts[l, h, i] = cnt

    widths = counts.reshape(
        n_layers, halves, r_pad // group, group, n_chunks).max(axis=(0, 1, 3, 4))
    plan = plan_width_buckets(widths, rows_per_group=group,
                              n_buckets=n_buckets,
                              width_multiple=width_multiple)

    buckets = []
    for (row0, row1, lc) in plan.boundaries:
        rg = row1 - row0
        values = np.zeros((n_layers, halves * rg, n_chunks, lc), np.float32)
        cols = np.zeros((n_layers, halves * rg, n_chunks, lc), np.int32)
        valid = np.zeros((n_layers, halves * rg, n_chunks, lc), bool)
        for l in range(n_layers):
            for h in range(halves):
                for i in range(row0, min(row1, n_rows)):
                    c, v = cells[l][h][i]
                    r = h * rg + (i - row0)
                    off = 0
                    for k in range(n_chunks):
                        n = int(counts[l, h, i, k])
                        if n:
                            seg = slice(off, off + n)
                            values[l, r, k, :n] = v[seg]
                            cols[l, r, k, :n] = c[seg] - k * cc
                            valid[l, r, k, :n] = True
                            off += n
        buckets.append({"values": values, "cols": cols, "valid": valid})

    pack = BucketedStackedPack(
        buckets=buckets,
        bucket_rows=tuple(b1 - b0 for b0, b1, _ in plan.boundaries),
        halves=halves,
        perm=perm,
        inv_perm=inv_perm,
        n_rows=n_rows,
        n_cols=n_cols,
        chunk_cols=cc,
        row_tile=row_tile,
        plan=plan,
        nnz_per_layer=nnz_per_half.sum(axis=0),
        nnz_per_half=nnz_per_half,
    )
    pack.fingerprint = integrity.fingerprint_pack(pack)
    return pack


# --------------------------------------------------------------------------
# Projection-generic pack groups (the PackGroupSpec compilation step)
# --------------------------------------------------------------------------
def pack_group(
    mats_by_proj: dict,
    fuse: str = "concat",
    row_tile: int = LANE,
    chunk_cols: int = 512,
    n_buckets: int = 4,
    width_multiple: int = 8,
    balance: bool = True,
) -> tuple:
    """Compile one pack group: ``mats_by_proj[name][layer]`` are the
    transposed per-layer matrices (rows = the projection's output dim).

    ``fuse="halves"`` packs each projection as one half under the shared
    permutation (identical shapes required — gate+up); ``fuse="concat"``
    row-concatenates the projections into one matrix per layer (row
    counts may differ — fused QKV under GQA).

    Returns ``(BucketedStackedPack, row_offsets)`` where
    ``row_offsets[name] = (half, r0, r1)`` locates the projection's rows
    in the group's logical (pre-permutation) row domain.
    """
    names = list(mats_by_proj)
    n_layers = len(mats_by_proj[names[0]])
    if fuse == "halves":
        halves = [list(mats_by_proj[n]) for n in names]
        n_rows = np.asarray(halves[0][0]).shape[0]
        offsets = {n: (h, 0, n_rows) for h, n in enumerate(names)}
    elif fuse == "concat":
        offsets = {}
        r0 = 0
        for n in names:
            rows = np.asarray(mats_by_proj[n][0]).shape[0]
            offsets[n] = (0, r0, r0 + rows)
            r0 += rows
        halves = [[np.concatenate([np.asarray(mats_by_proj[n][l])
                                   for n in names], axis=0)
                   for l in range(n_layers)]]
    else:
        raise ValueError(f"unknown fuse {fuse!r}")
    pack = pack_bucketed_stack(halves, row_tile=row_tile,
                               chunk_cols=chunk_cols, n_buckets=n_buckets,
                               width_multiple=width_multiple,
                               balance=balance)
    return pack, offsets


def compose_cols_with_pack(mats: list, upstream: BucketedStackedPack) -> list:
    """Offline column pre-composition: permute each layer matrix's columns
    to the upstream group's *packed* row order (pad positions become zero
    columns), so the upstream packed output feeds this group's pack with
    zero runtime permutation.  The returned matrices' gather domain is the
    upstream ``r_pad``."""
    out = []
    for l, m in enumerate(mats):
        m = np.asarray(m)
        mp = np.zeros((m.shape[0], upstream.r_pad), np.float32)
        mp[:, upstream.inv_perm[l]] = m
        out.append(mp)
    return out


def projection_padded_slots(pack: BucketedStackedPack,
                            row_offsets: dict) -> dict:
    """Exact per-projection padded-slot counts, (L,) per projection.

    A logical row's slots are set by the width bucket its packed position
    landed in (``n_chunks * Lc_bucket``); the balance permutation scatters
    a projection's rows across buckets, so this walks ``inv_perm``.
    Bucket widths are shared by every half, so the count is
    half-independent.
    """
    slots_per_pos = np.repeat(
        [pack.n_chunks * lc for lc in pack.widths],
        [rg for rg in pack.bucket_rows]).astype(np.int64)
    out = {}
    for name, (_, r0, r1) in row_offsets.items():
        pos = pack.inv_perm[:, r0:r1]                  # (L, rows)
        out[name] = slots_per_pos[pos].sum(axis=1)     # (L,)
    return out


def bucketed_stack_to_dense(pack: BucketedStackedPack, layer: int,
                            half: int) -> np.ndarray:
    """Inverse of ``pack_bucketed_stack`` for one (layer, half) — the
    property-test oracle."""
    w = np.zeros((pack.n_rows, pack.n_cols), dtype=np.float32)
    row0 = 0
    for b, rg in zip(pack.buckets, pack.bucket_rows):
        for r in range(rg):
            src = pack.perm[layer, row0 + r]
            if src < 0:
                continue
            i = half * rg + r
            for k in range(b["values"].shape[2]):
                sel = b["valid"][layer, i, k]
                w[src, b["cols"][layer, i, k, sel] + k * pack.chunk_cols] = \
                    b["values"][layer, i, k, sel]
        row0 += rg
    return w


def ell_to_dense(pack: ELLPack) -> np.ndarray:
    """Inverse of ``pack_ell`` (property-test oracle)."""
    w = np.zeros((pack.n_rows, pack.n_cols), dtype=pack.values.dtype)
    for i in range(pack.r_pad):
        src = pack.perm[i]
        if src < 0:
            continue
        sel = pack.valid[i]
        w[src, pack.cols[i, sel]] = pack.values[i, sel]
    return w


def ell_chunked_to_dense(pack: ELLChunkedPack) -> np.ndarray:
    """Inverse of ``pack_ell_chunked`` (property-test oracle)."""
    w = np.zeros((pack.n_rows, pack.n_cols), dtype=pack.values.dtype)
    for i in range(pack.r_pad):
        src = pack.perm[i]
        if src < 0:
            continue
        for k in range(pack.n_chunks):
            sel = pack.valid[i, k]
            w[src, pack.cols[i, k, sel] + k * pack.chunk_cols] = \
                pack.values[i, k, sel]
    return w


def shard_ell(pack: ELLPack, n_shards: int) -> dict:
    """Re-layout an ELLPack for ``shard_map`` over the ``model`` axis.

    Devices are the cluster-level "banks": each holds a contiguous packed
    row range; the dense x is replicated (the ICI broadcast).  Returns
    stacked arrays with a leading shard dim and a uniform per-shard width
    (the global L — banks operate in lockstep, exactly as in the paper).
    """
    r_pad = pack.r_pad
    if r_pad % n_shards != 0:
        # pad packed rows up to a multiple of n_shards * row_tile
        new_rpad = _round_up(r_pad, n_shards * pack.row_tile)
        pad = new_rpad - r_pad
        pack = ELLPack(
            values=np.pad(pack.values, ((0, pad), (0, 0))),
            cols=np.pad(pack.cols, ((0, pad), (0, 0))),
            valid=np.pad(pack.valid, ((0, pad), (0, 0))),
            perm=np.pad(pack.perm, (0, pad), constant_values=-1),
            n_rows=pack.n_rows,
            n_cols=pack.n_cols,
            row_tile=pack.row_tile,
            stats=pack.stats,
        )
        r_pad = new_rpad
    per = r_pad // n_shards
    return {
        "values": pack.values.reshape(n_shards, per, pack.ell_width),
        "cols": pack.cols.reshape(n_shards, per, pack.ell_width),
        "perm": pack.perm.reshape(n_shards, per),
        "n_rows": pack.n_rows,
        "n_cols": pack.n_cols,
        "pack": pack,
    }
