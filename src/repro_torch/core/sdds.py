"""Static Data-Dependent Scheduling (SDDS) — faithful to Sections III-D/E/F/G.

SDDS is the paper's central mechanism: because the sparsity pattern is static
and known at training time, the *entire cycle-level command stream* of the
sparse MV (which slots broadcast a new vector slice ``COMP-BR``, which stall
and re-use the latched slice ``COMP-NoBR``, where index-only prefetch reads
``LOAD-IDX`` go, and where dummy/invalid cells pad the compressed matrix) is
derived **once, offline**, by simulating the machine.  The host then replays
the stream; the DRAM-side datapath stays headless.

This module implements that offline construction as two slot-stepped
machines, selected by ``ESPIMConfig.prefetch``:

* machine A (Section III-D, no decoupling): each compute slot consumes at
  most one cell per MAC and only if the cell's column falls in the currently
  latched vector slice; otherwise the compressed matrix gets an invalid cell.
* machine B (Sections III-E/F, full ESPIM): per-MAC iFIFO (prefetched
  indices) and eFIFO (extracted vector elements) decouple the column-reads
  from the broadcasts; the 4x11 simplified switch constrains extraction to
  ascending index-range chains within each t_CCD window; SDDS's reorder pass
  permutes same-slice cells into ascending-range chains to dodge conflicts.

Load balance (Section III-G): SparTen's greedy scheme assigns rows to banks
round-robin by density, then co-locates the densest and the sparsest row *on
the same MAC* — their cells intermingled in increasing column order with a
per-cell ``select`` bit steering accumulation into one of two output buffers.
That is why ``rows_per_mac = 2``: each MAC's stream is the column-merged pair,
and the pair's combined nnz is what the greedy sort equalizes.

The broadcast-advance rule is global across banks (the banks run in lockstep
off one broadcast bus): the next slice is broadcast only when no bank has a
pending cell (in an iFIFO or still unread in its stream) matching the current
slice — the paper's "current slice consumed fully across all the banks".
Per-MAC column order is non-decreasing in slice (reorder only permutes within
a slice), which makes this rule sufficient for correctness; ``verify=True``
executes the dataflow and checks it against a numpy dot product.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.integrity import plan_fingerprint
from repro_torch.core.pruning import sparten_balance

__all__ = [
    "ESPIMConfig",
    "Schedule",
    "build_bank_streams",
    "schedule_matrix",
    "ChunkPlan",
    "chunk_cells",
    "plan_chunks",
    "WidthBucketPlan",
    "plan_width_buckets",
    "PackGroupSpec",
    "validate_group_specs",
    "decoder_layer_groups",
    "KernelSchedule",
    "DEFAULT_SCHEDULE",
    "WARPS_PER_ROW",
    "STREAM_U",
    "EPILOGUE_U",
    "WIDE_ROW_SLOTS",
    "WIDE_ROW_WARPS",
    "fill_warps_per_row",
    "schedule_us",
    "schedule_legal",
    "enumerate_schedules",
]


# --------------------------------------------------------------------------
# Configuration (Table I commands, Table II DRAM parameters)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ESPIMConfig:
    n_banks: int = 16
    macs_per_bank: int = 11          # k: sparse cells per 256-bit column read
    dense_macs_per_bank: int = 16    # Newton / flexible-dense path
    slice_elems: int = 16            # vector slice per broadcast (256 bits)
    fifo_depth: int = 8              # iFIFO and eFIFO entries per MAC
    tccd: int = 4                    # DRAM cycles between column reads
    switch_ranges: int = 4           # simplified switch: 4 ranges x 4 elems
    cols_per_dram_row: int = 32      # 8K bits / 256-bit column I/O
    vector_row_elems: int = 512      # 1KB DRAM row / 2B element
    idx_per_mac_idxread: int = 3     # ~23 spare bits/MAC in an idx-only read
    decouple_dist: int = 6           # prefetch depth targeted at stripe start
    rows_per_mac: int = 2            # select bit + 2 output buffers (III-G)
    # DRAM timing (Table II, DRAM cycles)
    t_rcd: int = 10
    t_rp: int = 10
    t_ras: int = 24
    t_rtp: int = 5
    # feature toggles (Figure 11 ablation)
    prefetch: bool = True
    reorder: bool = True
    balance: bool = True
    full_switch: bool = False        # brute-force 16x11 switch

    @property
    def range_width(self) -> int:
        return self.slice_elems // self.switch_ranges

    @property
    def slices_per_vector_row(self) -> int:
        return self.vector_row_elems // self.slice_elems

    def replace(self, **kw) -> "ESPIMConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Schedule result
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Schedule:
    """Counters of the statically derived command stream (Table I)."""

    comp_br: int = 0        # compute + broadcast slots
    comp_nobr: int = 0      # compute + stalled-broadcast slots
    load_idx: int = 0       # index-only prefetch column reads
    all_act: int = 0        # all-bank activations
    rdres_elems: int = 0    # result elements read out to host
    load_gb_bytes: int = 0  # vector bytes loaded into the global buffer
    mac_ops: int = 0        # real multiply-accumulates executed
    dummy_cells: int = 0    # invalid/placeholder cells in the compressed matrix
    ififo_pushes: int = 0
    efifo_pushes: int = 0
    nnz: int = 0
    n_stripes: int = 0
    vector_rows: int = 0

    @property
    def compute_slots(self) -> int:
        return self.comp_br + self.comp_nobr

    @property
    def column_reads(self) -> int:
        return self.compute_slots + self.load_idx

    @property
    def broadcasts(self) -> int:
        return self.comp_br

    @property
    def stalls(self) -> int:
        return self.comp_nobr

    def merge(self, other: "Schedule") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def fingerprint(self) -> str:
        """Digest of the derived command stream — lets a replayed schedule
        be bound to the pack it was compiled against."""
        return plan_fingerprint(self)


# --------------------------------------------------------------------------
# Bank stream construction (load balance + fine-grained interleaving order)
# --------------------------------------------------------------------------
def build_bank_streams(pattern: np.ndarray, cfg: ESPIMConfig) -> list[list[int]]:
    """Assign matrix rows to banks; returns per-bank row-id lists in
    processing order.  With ``cfg.balance``, SparTen's greedy balance
    (Section III-G); otherwise round-robin original order."""
    pattern = np.asarray(pattern)
    n_rows = pattern.shape[0]
    nnz_per_row = (pattern != 0).sum(axis=1)
    if cfg.balance:
        assign = sparten_balance(nnz_per_row, cfg.n_banks)
        return [list(r) for r in assign.bank_rows]
    return [list(range(b, n_rows, cfg.n_banks)) for b in range(cfg.n_banks)]


def _reorder_in_slice(cols: np.ndarray, tags: np.ndarray, cfg: ESPIMConfig):
    """SDDS's switch-conflict-avoiding reorder (Section III-F).

    Within each vector slice, permute a MAC's cells into ascending-range
    chains: deal one index per range per pass (ranges in ascending order) so
    consecutive cells land in different mux ranges and extract in one t_CCD
    window instead of forcing head-of-line stalls.  Slice order is preserved
    (the broadcast-advance rule relies on per-MAC slice monotonicity).
    """
    if cols.size <= 1:
        return cols, tags
    out_c = np.empty_like(cols)
    out_t = np.empty_like(tags)
    slice_ids = cols // cfg.slice_elems
    pos = 0
    start = 0
    for end in range(1, cols.size + 1):
        if end == cols.size or slice_ids[end] != slice_ids[start]:
            n = end - start
            if n > 1:
                rel = cols[start:end] % cfg.slice_elems
                rng = rel // cfg.range_width
                buckets: list[deque] = [deque() for _ in range(cfg.switch_ranges)]
                for i in range(start, end):
                    buckets[int(rng[i - start])].append(i)
                emitted = []
                while len(emitted) < n:
                    for b in buckets:
                        if b:
                            emitted.append(b.popleft())
                out_c[pos : pos + n] = cols[emitted]
                out_t[pos : pos + n] = tags[emitted]
            else:
                out_c[pos : pos + n] = cols[start:end]
                out_t[pos : pos + n] = tags[start:end]
            pos += n
            start = end
    return out_c, out_t


# --------------------------------------------------------------------------
# Column-chunk grouping (the broadcast-sharing pass restated for VMEM)
# --------------------------------------------------------------------------
def chunk_cells(cols: np.ndarray, chunk_cols: int,
                n_chunks: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """SDDS pass: stable-bucket one row's cells by column chunk.

    The paper advances one broadcast slice at a time and schedules every
    cell that consumes the latched slice before moving on; on TPU the
    "slice" is a ``chunk_cols``-wide slab of ``x`` resident in VMEM, and
    this pass is the same reorder one level up: permute a row's cells so
    all cells of chunk k are contiguous (and chunks appear in ascending
    order), which lets a (row-tile x col-chunk) kernel block touch exactly
    one ``x`` slab.  Stable, so any finer-grained order (ascending column,
    switch-conflict reorder) survives within each chunk.

    Returns ``(order, counts)``: ``cols[order]`` is chunk-grouped and
    ``counts[k]`` is the number of cells in chunk k.
    """
    cols = np.asarray(cols)
    if chunk_cols <= 0:
        raise ValueError(f"chunk_cols must be positive, got {chunk_cols}")
    chunk_of = cols // chunk_cols
    if n_chunks is None:
        n_chunks = int(chunk_of.max()) + 1 if cols.size else 1
    elif cols.size and int(chunk_of.max()) >= n_chunks:
        raise ValueError(
            f"column {int(cols.max())} falls past chunk {n_chunks - 1} "
            f"(chunk_cols={chunk_cols})")
    order = np.argsort(chunk_of, kind="stable")
    counts = np.bincount(chunk_of, minlength=n_chunks)
    return order, counts


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Static plan for the column-chunked layout of one matrix.

    The analogue of the schedule's broadcast accounting: ``active_blocks``
    counts the (row-tile x col-chunk) blocks holding at least one cell
    (each costs one ``x``-slab load, the COMP-BR analogue), and
    ``chunk_pad_frac`` is the extra static stall padding chunking adds on
    top of plain ELL.  ``x_bytes_per_step`` vs ``x_bytes_full`` is the
    VMEM-residency reduction the layout exists for.
    """

    chunk_cols: int
    n_chunks: int
    row_tile: int
    chunk_width: int        # Lc: padded cells per (row, chunk)
    nnz: int
    active_blocks: int
    total_blocks: int
    chunk_pad_frac: float   # 1 - nnz / (R_pad * n_chunks * Lc)
    x_bytes_full: int       # full-vector VMEM residency (old kernels)
    x_bytes_per_step: int   # one chunk slab (new kernels)

    @property
    def block_occupancy(self) -> float:
        return self.active_blocks / max(1, self.total_blocks)

    def fingerprint(self) -> str:
        """Digest of this plan — part of the pack's bound fingerprint
        (``core.integrity``), so pairing a pack with a foreign chunk plan
        fails verification."""
        return plan_fingerprint(self)


def plan_chunks(counts: np.ndarray, *, chunk_cols: int, row_tile: int,
                n_cols: int, width_multiple: int = 8,
                elem_bytes: int = 4) -> ChunkPlan:
    """Derive the ChunkPlan from per-(row, chunk) cell counts.

    ``counts`` is (R_pad, n_chunks) as produced by ``chunk_cells`` row by
    row; the chunk width Lc is the global max rounded up for sublane
    alignment (uniform width keeps the kernel grid regular — banks in
    lockstep, exactly like the paper's global ELL width).
    """
    counts = np.asarray(counts)
    r_pad, n_chunks = counts.shape
    lc = int(counts.max()) if counts.size else 0
    lc = max(width_multiple,
             -(-max(lc, 1) // width_multiple) * width_multiple)
    nnz = int(counts.sum())
    n_tiles = max(1, r_pad // max(1, row_tile))
    tile_active = counts.reshape(n_tiles, -1, n_chunks).sum(axis=1) > 0
    padded = r_pad * n_chunks * lc
    return ChunkPlan(
        chunk_cols=chunk_cols,
        n_chunks=n_chunks,
        row_tile=row_tile,
        chunk_width=lc,
        nnz=nnz,
        active_blocks=int(tile_active.sum()),
        total_blocks=n_tiles * n_chunks,
        chunk_pad_frac=1.0 - (nnz / padded if padded else 0.0),
        x_bytes_full=n_cols * elem_bytes,
        x_bytes_per_step=chunk_cols * elem_bytes,
    )


# --------------------------------------------------------------------------
# Width bucketing (per-segment ELL widths instead of one global max)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WidthBucketPlan:
    """Partition of the packed (density-sorted) rows into <= n_buckets
    contiguous segments, each padded to its own ELL width.

    The paper pads every MAC stream to the stripe's lockstep length; one
    global width makes the whole matrix pay for its densest row.  Because
    ``row_tile_balance`` sorts rows by nnz, widths decay monotonically down
    the packed order, so a handful of contiguous segments ("buckets") with
    per-bucket widths recovers most of the padding a single global width
    wastes.  Boundaries are chosen by exact DP over fixed-size row groups,
    minimizing total padded slots; an extra bucket is kept only if it saves
    more than ``slack`` of the single-bucket cost (each bucket is one more
    kernel launch at serving time).
    """

    boundaries: tuple       # ((row_start, row_end, width), ...) packed order
    group: int              # row granularity the DP ran at
    padded_slots: int       # sum over buckets of rows * width (per chunk)
    single_bucket_slots: int  # cost of the global-max-width layout
    widths_per_group: tuple

    @property
    def n_buckets(self) -> int:
        return len(self.boundaries)

    @property
    def savings_frac(self) -> float:
        if not self.single_bucket_slots:
            return 0.0
        return 1.0 - self.padded_slots / self.single_bucket_slots

    def fingerprint(self) -> str:
        """Digest of this plan (see ``ChunkPlan.fingerprint``)."""
        return plan_fingerprint(self)


def _bucket_width(w: int, width_multiple: int) -> int:
    return max(width_multiple, -(-max(int(w), 1) // width_multiple)
               * width_multiple)


def plan_width_buckets(widths, *, rows_per_group: int, n_buckets: int = 4,
                       width_multiple: int = 8,
                       slack: float = 0.02) -> WidthBucketPlan:
    """Choose bucket boundaries over per-group max cell counts.

    ``widths[g]`` is the max per-(row, chunk) cell count over row group
    ``g`` (``rows_per_group`` packed rows).  Exact DP partitions the groups
    into at most ``n_buckets`` contiguous segments minimizing total padded
    slots (each segment pays rows * round_up(segment max)); among bucket
    counts within ``slack`` of the optimum the smallest count wins.
    """
    widths = np.asarray(widths, dtype=np.int64)
    n = widths.size
    if n == 0:
        raise ValueError("empty widths")
    if rows_per_group <= 0:
        raise ValueError(f"rows_per_group must be positive, got {rows_per_group}")
    n_buckets = max(1, min(n_buckets, n))

    # seg_cost[i][j] = padded slots of one bucket spanning groups [i, j)
    seg_max = np.zeros((n, n + 1), dtype=np.int64)
    for i in range(n):
        m = 0
        for j in range(i + 1, n + 1):
            m = max(m, widths[j - 1])
            seg_max[i, j] = _bucket_width(m, width_multiple)

    def seg_cost(i, j):
        return (j - i) * rows_per_group * seg_max[i, j]

    inf = np.iinfo(np.int64).max
    # best[k][j] = min cost covering groups [0, j) with exactly k buckets
    best = np.full((n_buckets + 1, n + 1), inf, dtype=np.int64)
    back = np.zeros((n_buckets + 1, n + 1), dtype=np.int64)
    best[0, 0] = 0
    for k in range(1, n_buckets + 1):
        for j in range(1, n + 1):
            for i in range(k - 1, j):
                if best[k - 1, i] == inf:
                    continue
                c = best[k - 1, i] + seg_cost(i, j)
                if c < best[k, j]:
                    best[k, j] = c
                    back[k, j] = i

    single = seg_cost(0, n)
    optimum = min(int(best[k, n]) for k in range(1, n_buckets + 1))
    chosen_k = next(k for k in range(1, n_buckets + 1)
                    if best[k, n] <= optimum + slack * single)
    cuts = [n]
    j = n
    for k in range(chosen_k, 0, -1):
        j = int(back[k, j])
        cuts.append(j)
    cuts.reverse()
    boundaries = tuple(
        (cuts[i] * rows_per_group, cuts[i + 1] * rows_per_group,
         int(seg_max[cuts[i], cuts[i + 1]]))
        for i in range(chosen_k)
    )
    return WidthBucketPlan(
        boundaries=boundaries,
        group=rows_per_group,
        padded_slots=int(best[chosen_k, n]),
        single_bucket_slots=int(single),
        widths_per_group=tuple(int(w) for w in widths),
    )


# --------------------------------------------------------------------------
# Pack groups (projection-generic SDDS compilation units)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackGroupSpec:
    """Declarative spec for one *pack group*: a set of same-input
    projections compiled into ONE width-bucketed layer-stacked pack under
    ONE balance permutation and one set of width buckets.

    The paper's format and scheduling are projection-agnostic — every MV
    of the decode step gets fine-grained interleaving, balance permutation
    and decoupled value/index planes — so pack/partition planning is a
    reusable compilation pass over group specs, not per-matrix special
    cases.

    * ``projections``: parameter leaf names under
      ``params["layers"][module]``, row-concatenated in this order (rows
      of the packed matrix are the projections' *output* dims).
    * ``fuse``: how the projections share the pack.

      - ``"concat"``: row-concatenated into one matrix (per-projection
        row counts may differ — QKV under GQA).  The group output is a
        packed-order vector whose logical split points are the recorded
        per-projection row offsets.
      - ``"halves"``: every projection is one *half* of each bucket under
        a SHARED permutation (requires identical shapes); half outputs
        pair up elementwise in packed order, so products between them
        (``act(gate) * up``) need no unscatter.

    * ``compose_with``: name of an upstream group whose packed output
      this group consumes.  The group's column ids are pre-composed
      OFFLINE with the upstream packed order (its gather domain becomes
      the upstream ``r_pad``), deleting the inter-group permutation from
      the per-token path.
    * ``output``: the group's output contract.

      - ``"take"``: one static ``jnp.take`` by ``inv_perm`` restores
        logical row order at runtime.  Required whenever the consumer
        needs logical positions — QKV must unscatter because RoPE pairs
        head dims positionally and the paged KV cache stores logical
        head rows; the O/down projections feed the residual stream.
      - ``"folded"``: the output stays in packed order and exactly one
        downstream group declares ``compose_with`` = this group (gate+up
        feeding down).
    """

    name: str
    projections: tuple
    module: str = "mlp"          # params["layers"][<module>][<projection>]
    fuse: str = "concat"         # "concat" | "halves"
    compose_with: str | None = None
    output: str = "take"         # "take" | "folded"

    def __post_init__(self):
        if not self.projections:
            raise ValueError(f"group {self.name!r} lists no projections")
        if self.fuse not in ("concat", "halves"):
            raise ValueError(f"group {self.name!r}: unknown fuse "
                             f"{self.fuse!r}")
        if self.output not in ("take", "folded"):
            raise ValueError(f"group {self.name!r}: unknown output "
                             f"{self.output!r}")

    def fingerprint(self) -> str:
        """Digest of this spec (see ``ChunkPlan.fingerprint``)."""
        return plan_fingerprint(self)


def validate_group_specs(specs) -> dict:
    """Check a group-spec list's fold/compose contract; returns
    ``{name: spec}`` in compilation order.

    * names and projection leaves are unique;
    * ``compose_with`` must reference an *earlier* group (packs compile
      in order, the composed group needs the upstream packed order);
    * ``output="folded"`` requires exactly one downstream consumer
      composing with the group (a folded output that nobody composes
      with would never return to logical order), and ``output="take"``
      requires none (the take would double-unscatter).
    """
    by_name: dict = {}
    seen_proj: set = set()
    for s in specs:
        if s.name in by_name:
            raise ValueError(f"duplicate group name {s.name!r}")
        for p in s.projections:
            key = (s.module, p)
            if key in seen_proj:
                raise ValueError(
                    f"projection {s.module}/{p} appears in two groups")
            seen_proj.add(key)
        by_name[s.name] = s
    consumers: dict = {}
    for s in specs:
        if s.compose_with is not None:
            if s.compose_with not in by_name:
                raise ValueError(
                    f"group {s.name!r} composes with unknown group "
                    f"{s.compose_with!r}")
            if list(by_name).index(s.compose_with) >= list(by_name).index(
                    s.name):
                raise ValueError(
                    f"group {s.name!r} composes with {s.compose_with!r}, "
                    f"which must be compiled earlier")
            consumers.setdefault(s.compose_with, []).append(s.name)
    for s in specs:
        n = len(consumers.get(s.name, ()))
        if s.output == "folded" and n != 1:
            raise ValueError(
                f"group {s.name!r} has output='folded' but {n} composing "
                f"consumers (need exactly 1)")
        if s.output == "take" and n != 0:
            raise ValueError(
                f"group {s.name!r} has output='take' but downstream "
                f"groups compose with its packed order")
    return by_name


def decoder_layer_groups(gated: bool = True, attn: bool = True,
                         mlp: bool = True) -> tuple:
    """The standard decoder-layer group set.

    MLP: gate+up as shared-perm halves folding into the perm-composed
    down projection.  Attention: q/k/v row-concatenated (one SpMV, output
    unscattered by one static take so RoPE head pairing and KV-cache
    writes see logical order) and the O projection feeding the residual.
    """
    specs: list = []
    if attn:
        specs += [
            PackGroupSpec("qkv", ("wq", "wk", "wv"), module="attn",
                          fuse="concat", output="take"),
            PackGroupSpec("attn_out", ("wo",), module="attn",
                          fuse="concat", output="take"),
        ]
    if mlp:
        gu = ("w_gate", "w_up") if gated else ("w_up",)
        specs += [
            PackGroupSpec("gateup", gu, module="mlp", fuse="halves",
                          output="folded"),
            PackGroupSpec("down", ("w_down",), module="mlp", fuse="concat",
                          compose_with="gateup", output="take"),
        ]
    return tuple(specs)


# --------------------------------------------------------------------------
# Kernel schedule space (the autotuner's candidate set — DESIGN.md §15)
#
# SDDS's premise is that every scheduling decision can be made offline
# because the sparsity is static.  On Hopper the streaming SpMV kernels
# (kernels 1-4 and 6, ``kernels/csrc/espim_spmv.cu``) leave three such
# decisions: the column-chunk width (the offline chunk pass), the warps
# that walk one row (or, for the GLU kernels, one gate+up pair) and u,
# the ring's stages (up to u + 2, as shared memory allows).
# ``KernelSchedule`` names one point in that space; ``enumerate_schedules``
# + ``schedule_legal`` produce the candidate set the autotuner ranks and
# benchmarks.
# --------------------------------------------------------------------------
WARPS_PER_ROW = (0, 1, 2, 4)    # 0 = the launcher's default (by row slots)
STREAM_U = (1, 2, 4)            # u taken by kernels 1 and 2
EPILOGUE_U = (2,)               # u taken by kernels 3, 4 (GLU) and 6 (res)
WIDE_ROW_SLOTS = 1024           # kWideRowSlots of the launcher
WIDE_ROW_WARPS = 4              # kWideRowWarps


def fill_warps_per_row(slots: int) -> int:
    """The warps a row the launcher takes for ``warps_per_row`` 0
    (``resolve_wpr`` in ``espim_spmv.cu``), from a row's padded slots
    (K x Lc): one warp, or ``WIDE_ROW_WARPS`` above ``WIDE_ROW_SLOTS``.
    The row's own shape sets it, never the launch's rows, so a bucket
    walks its rows the same way alone and in a grouped launch."""
    return WIDE_ROW_WARPS if slots > WIDE_ROW_SLOTS else 1


def schedule_us(epilogue: str | None = None) -> tuple:
    """The U values the kernels are built for: kernels 1-2 (``epilogue``
    None) take ``STREAM_U``, the GLU and residual kernels ``EPILOGUE_U``."""
    if epilogue not in (None, "glu", "residual"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return STREAM_U if epilogue is None else EPILOGUE_U


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """One candidate SDDS kernel schedule for the chunked-ELL SpMV on
    Hopper.

    ``chunk_cols`` is the offline chunk pass's slab width (re-chunking the
    pack is part of applying the schedule, never a launch knob);
    ``warps_per_row`` is the warps that walk one row (one gate+up pair for
    the GLU kernels): 1, 2 or 4, or 0 for the launcher's default
    (``fill_warps_per_row``: by the row's slots); ``u`` sets the ring's
    stages (up to u + 2, as shared memory allows).  The default is
    exactly the launch the kernels make with no schedule.  On the ``ref`` lowering, and on the unbatched kernel 5 (the
    mv body, launched on ``kernels/espim_spmv._mv_plan``), only
    ``chunk_cols`` is live.
    """

    chunk_cols: int = 512
    warps_per_row: int = 0
    u: int = 2

    def fingerprint(self) -> str:
        return plan_fingerprint(self)

    def effective_key(self, impl: str) -> tuple:
        """The knobs that actually change the launched computation for
        ``impl`` — candidates identical under this key are deduplicated
        before benchmarking.  ``ref`` (and kernel 5, which launches the
        same under every schedule of one ``chunk_cols``) reads only
        ``chunk_cols``; the streaming kernels read all three."""
        if impl == "ref":
            return ("ref", self.chunk_cols)
        return ("cuda", self.chunk_cols, self.warps_per_row, self.u)


DEFAULT_SCHEDULE = KernelSchedule()


def schedule_legal(s: KernelSchedule, *, n_cols: int,
                   epilogue: str | None = None) -> bool:
    """Candidate legality for a pack over ``n_cols`` input columns,
    launched by the kernel of ``epilogue`` (None: kernels 1-2; ``"glu"``:
    3-4, where ``warps_per_row`` counts warps a pair; ``"residual"``: 6):

    * ``warps_per_row`` in ``WARPS_PER_ROW`` (0 = the fill rule);
    * ``u`` among the values the kernel is built for (``schedule_us``):
      the GLU and residual kernels are built for U = 2 only;
    * ``chunk_cols`` must be positive and is capped at ``n_cols`` by the
      chunk pass, so wider candidates collapse onto the single-chunk one.

    The TPU's sublane rule (a row block of gcd >= 8 with R_pad) has no
    counterpart: a Hopper launch takes any row count.
    """
    if s.chunk_cols <= 0 or s.chunk_cols > max(1, n_cols):
        return False
    return (s.warps_per_row in WARPS_PER_ROW
            and s.u in schedule_us(epilogue))


def enumerate_schedules(*, n_cols: int, epilogue: str | None = None,
                        chunk_cols_options=(256, 512, 1024)) -> list:
    """All legal candidates over the knob grid, default schedule first.
    ``chunk_cols == n_cols`` (single chunk) is always included — on small
    matrices it is often the only legal slab width."""
    ccs = sorted({min(cc, max(1, n_cols))
                  for cc in (*chunk_cols_options, n_cols)})
    # the default's knobs lead within each chunk width (ties in the
    # tuner's cost model keep this order)
    d = DEFAULT_SCHEDULE
    ws = sorted(WARPS_PER_ROW, key=lambda w: (w != d.warps_per_row, w))
    us = sorted(schedule_us(epilogue), key=lambda u: (u != d.u, u))
    out = [KernelSchedule(chunk_cols=cc, warps_per_row=w, u=u)
           for cc in ccs for w in ws for u in us]
    if schedule_legal(d, n_cols=n_cols, epilogue=epilogue):
        out = [d] + [s for s in out if s != d]
    return out


# --------------------------------------------------------------------------
# Slot machines
# --------------------------------------------------------------------------
class _MacState:
    """Per-(bank, MAC) stream + FIFO state for one (vector-row, stripe).

    ``cols`` is the column-merged stream of this MAC's ``rows_per_mac`` rows
    (relative to the vector-row base); ``tags`` is the per-cell select bit;
    ``rows`` maps tag -> original matrix row id (or None).
    """

    __slots__ = ("cols", "tags", "rows", "slices", "ranges", "ip", "vp",
                 "ififo", "efifo")

    def __init__(self, cols: np.ndarray, tags: np.ndarray, rows, cfg: ESPIMConfig):
        self.cols = cols
        self.tags = tags
        self.rows = rows
        self.slices = cols // cfg.slice_elems
        self.ranges = (cols % cfg.slice_elems) // cfg.range_width
        self.ip = 0  # next index to load into the iFIFO
        self.vp = 0  # next value to multiply (paired with eFIFO head)
        self.ififo: deque = deque()
        self.efifo: deque = deque()

    @property
    def n(self) -> int:
        return len(self.cols)

    def done(self) -> bool:
        return self.vp >= self.n


class _ExecCtx:
    """Optional dataflow execution for verify mode."""

    __slots__ = ("x_row", "values", "lo", "acc")

    def __init__(self, x_row, values, lo, n_macs, rows_per_mac):
        self.x_row = x_row
        self.values = values
        self.lo = lo
        self.acc = np.zeros((n_macs, rows_per_mac), dtype=np.float64)

    def fire(self, mi: int, m: _MacState) -> None:
        c = m.cols[m.vp]
        t = m.tags[m.vp]
        row = m.rows[t]
        self.acc[mi, t] += self.values[row, self.lo + c] * self.x_row[c]


def _machine_prefetch(
    macs: list[_MacState], cfg: ESPIMConfig, sched: Schedule, ctx: _ExecCtx | None
) -> None:
    """Machine B: full ESPIM with decoupled prefetch + simplified switch."""
    n_slices = cfg.slices_per_vector_row
    total = sum(m.n for m in macs)
    if total == 0:
        return
    # --- prologue LOAD-IDX reads establish the decoupling distance -------
    need = -(-min(cfg.decouple_dist, cfg.fifo_depth)
             // max(1, cfg.idx_per_mac_idxread))
    for _ in range(max(0, need)):
        pushed_any = False
        for m in macs:
            for _ in range(cfg.idx_per_mac_idxread):
                if m.ip < m.n and len(m.ififo) < cfg.fifo_depth:
                    m.ififo.append(m.ip)
                    m.ip += 1
                    sched.ififo_pushes += 1
                    pushed_any = True
        if pushed_any:
            sched.load_idx += 1

    cur = -1  # latched slice id; first COMP-BR latches slice 0
    guard, max_slots = 0, 64 * (total + n_slices * len(macs) + 64)
    while not all(m.done() for m in macs):
        guard += 1
        if guard > max_slots:  # pragma: no cover - safety net
            raise RuntimeError("SDDS prefetch machine failed to converge (bug)")
        # ---- broadcast-advance decision (global across banks) -----------
        blocked = False
        for m in macs:
            if m.ififo:
                if m.slices[m.ififo[0]] <= cur:
                    blocked = True
                    break
            elif m.ip < m.n:
                # empty iFIFO with unread indices: conservative stall
                # (Section III-E case 1) once something is latched.
                if cur >= 0 and m.slices[m.ip] <= cur:
                    blocked = True
                    break
        if blocked or cur + 1 >= n_slices:
            sched.comp_nobr += 1
        else:
            sched.comp_br += 1
            cur += 1
        # ---- compute: column-read values x eFIFO heads -------------------
        for mi, m in enumerate(macs):
            if m.vp < m.n and m.efifo:
                m.efifo.popleft()
                if ctx is not None:
                    ctx.fire(mi, m)
                m.vp += 1
                sched.mac_ops += 1
            else:
                sched.dummy_cells += 1
        # ---- index side of the normal column read ------------------------
        for m in macs:
            if m.ip < m.n:
                if len(m.ififo) < cfg.fifo_depth:
                    m.ififo.append(m.ip)
                    m.ip += 1
                    sched.ififo_pushes += 1
                else:
                    sched.dummy_cells += 1  # placeholder, dropped at the bank
        # ---- switch: extract matching elements into eFIFOs ---------------
        if cur >= 0:
            for m in macs:
                last_range, pulled = -1, 0
                while (
                    m.ififo
                    and m.slices[m.ififo[0]] == cur
                    and len(m.efifo) < cfg.fifo_depth
                ):
                    head = m.ififo[0]
                    if cfg.full_switch:
                        if pulled >= cfg.tccd:
                            break
                    else:
                        r = m.ranges[head]
                        if r <= last_range:
                            break
                        last_range = r
                    m.ififo.popleft()
                    m.efifo.append(head)
                    pulled += 1
                    sched.efifo_pushes += 1


def _machine_basic(
    macs: list[_MacState], cfg: ESPIMConfig, sched: Schedule, ctx: _ExecCtx | None
) -> None:
    """Machine A (Section III-D): no decoupling; one cell per MAC per slot,
    and only when it matches the latched slice."""
    n_slices = cfg.slices_per_vector_row
    if sum(m.n for m in macs) == 0:
        return
    cur = -1
    guard, max_slots = 0, 64 * (sum(m.n for m in macs) + n_slices * len(macs) + 64)
    while not all(m.done() for m in macs):
        guard += 1
        if guard > max_slots:  # pragma: no cover
            raise RuntimeError("SDDS basic machine failed to converge (bug)")
        blocked = any(
            (not m.done()) and cur >= 0 and m.slices[m.vp] <= cur for m in macs
        )
        if blocked or cur + 1 >= n_slices:
            sched.comp_nobr += 1
        else:
            sched.comp_br += 1
            cur += 1
        for mi, m in enumerate(macs):
            if not m.done() and m.slices[m.vp] == cur:
                if ctx is not None:
                    ctx.fire(mi, m)
                m.vp += 1
                sched.mac_ops += 1
            else:
                sched.dummy_cells += 1


# --------------------------------------------------------------------------
# Whole-matrix scheduling
# --------------------------------------------------------------------------
def schedule_matrix(
    pattern: np.ndarray,
    cfg: ESPIMConfig = ESPIMConfig(),
    values: np.ndarray | None = None,
    x: np.ndarray | None = None,
    verify: bool = False,
) -> tuple[Schedule, np.ndarray | None]:
    """Run SDDS over a full matrix.

    ``pattern`` is the (R, C) sparse weight matrix (or boolean pattern).
    With ``verify=True`` the machines also execute the dataflow — each MAC
    accumulates value*element exactly when the schedule fires it, through
    the select-bit output buffers — and the resulting ``y`` is returned for
    comparison against ``values @ x``.

    Returns ``(Schedule, y_or_None)``.
    """
    pattern = np.asarray(pattern)
    n_rows, n_cols = pattern.shape
    if verify:
        if values is None:
            values = pattern.astype(np.float64)
        if x is None:
            rng = np.random.default_rng(0)
            x = rng.standard_normal(n_cols)
        values = np.asarray(values, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)

    bank_rows = build_bank_streams(pattern, cfg)
    cols_by_row = [np.nonzero(pattern[r])[0].astype(np.int64)
                   for r in range(n_rows)]

    k = cfg.macs_per_bank
    rpm = cfg.rows_per_mac
    rows_per_stripe = k * rpm
    n_stripes = max(
        (-(-len(rows) // rows_per_stripe) for rows in bank_rows if rows),
        default=0,
    )
    n_vr = max(1, -(-n_cols // cfg.vector_row_elems))
    sched = Schedule(nnz=int((pattern != 0).sum()), n_stripes=n_stripes,
                     vector_rows=n_vr)
    y = np.zeros(n_rows, dtype=np.float64) if verify else None
    machine = _machine_prefetch if cfg.prefetch else _machine_basic

    for vr in range(n_vr):
        lo = vr * cfg.vector_row_elems
        hi = min(n_cols, lo + cfg.vector_row_elems)
        sched.load_gb_bytes += (hi - lo) * 2
        x_row = x[lo:hi] if verify else None
        for s in range(n_stripes):
            slots_before = sched.column_reads
            macs: list[_MacState] = []
            for b in range(cfg.n_banks):
                window = bank_rows[b][s * rows_per_stripe : (s + 1) * rows_per_stripe]
                for j in range(k):
                    pair = window[j * rpm : (j + 1) * rpm]
                    segs, tags = [], []
                    rows_of_mac: list = [None] * rpm
                    for t, r in enumerate(pair):
                        rows_of_mac[t] = r
                        c = cols_by_row[r]
                        seg = c[(c >= lo) & (c < hi)] - lo
                        segs.append(seg)
                        tags.append(np.full(seg.size, t, dtype=np.int8))
                    if segs:
                        cat = np.concatenate(segs)
                        tag = np.concatenate(tags)
                        order = np.argsort(cat, kind="stable")
                        cat, tag = cat[order], tag[order]
                    else:
                        cat = np.empty(0, np.int64)
                        tag = np.empty(0, np.int8)
                    if cfg.reorder and cfg.prefetch:
                        cat, tag = _reorder_in_slice(cat, tag, cfg)
                    macs.append(_MacState(cat, tag, rows_of_mac, cfg))
            ctx = (
                _ExecCtx(x_row, values, lo, len(macs), rpm) if verify else None
            )
            machine(macs, cfg, sched, ctx)
            if verify:
                for mi, m in enumerate(macs):
                    for t, r in enumerate(m.rows):
                        if r is not None:
                            y[r] += ctx.acc[mi, t]
            slots = sched.column_reads - slots_before
            sched.all_act += -(-max(slots, 1) // cfg.cols_per_dram_row)
            sched.rdres_elems += sum(
                1 for m in macs for r in m.rows if r is not None
            )
    return sched, y
