"""Kernel 5's launch plan (``repro_torch.kernels.espim_spmv._mv_plan``),
on the CPU.

The mv body (``csrc/espim_spmv.cu``: ``espim_spmv_mv_kernel``) launches on
the plan the host computes: every row in exactly one block, whole; at most
as many blocks as the SMs hold; shared memory within the card's 232,448
bytes a block; stages in 16-byte units that hold their tile; x staged in
shared memory exactly when it fits; a row's team from its padded slots
K * Lc alone.  The last is the bits condition: a row's sum order is fixed
by its slots and its team, so a row gives the same bits whatever R, the
grid, the stage or where x lives.  The kernel itself is held against the
plain version, and a slice of rows against the whole launch in bits, on
the card by ``chip_smoke.py``."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import espim_spmv as K  # noqa: E402

SMEM_BLOCK = 232448          # shared memory a block may take on an H100
BARRIERS, LEAST_STAGE = 256, 4224
# (R, K, Lc, M): chip_smoke.py's kernel-5 packs (llama7b-espim's fused
# wq/wk/wv and w_down at 90% sparsity: Lc 80 or 88), its 64-row pack and
# its x of 65536 f32 columns, then small, ragged and empty packs
CHIP = [(12288, 8, 88, 4096), (12288, 8, 80, 4096), (4096, 22, 88, 11008),
        (4096, 22, 80, 11008)]
SHAPES = CHIP + [(64, 8, 88, 4096), (256, 128, 48, 65536), (4096, 22, 13, 11008),
                 (1, 1, 8, 100), (7, 3, 13, 1500), (130, 2, 5, 1000),
                 (133, 1, 1, 1), (1000, 4, 16, 2048), (5000, 300, 8, 153600),
                 (0, 8, 88, 4096)]
DTYPES = [(4, 4), (2, 2), (4, 2), (2, 4)]     # (value, x) bytes
SMS = [132, 114, 78, 1]


def _plans(shape, vb, xb):
    r, k, lc, m = shape
    for sms in SMS:
        yield sms, K._mv_plan(r, k, lc, m, vb, xb, sms)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("vb,xb", DTYPES)
def test_every_row_in_exactly_one_block(shape, vb, xb):
    """Block j takes rows [j * rows_a_block, ...): the blocks partition
    the rows, none is empty, a row never spans two, and there are at most
    as many blocks as SMs, one a block (the fewest rows a block that
    fit)."""
    r = shape[0]
    for cap, p in _plans(shape, vb, xb):
        assert p.blocks <= cap
        owners = np.zeros(r, np.int64)
        for j in range(p.blocks):
            lo, hi = j * p.rows_a_block, min(r, (j + 1) * p.rows_a_block)
            assert lo < hi, (j, p)
            owners[lo:hi] += 1
        assert (owners == 1).all()
        if r:
            assert (p.rows_a_block - 1) * cap < r <= p.rows_a_block * cap
        else:
            assert p.blocks == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("vb,xb", DTYPES)
def test_ring_fits_shared_memory_and_holds_its_tiles(shape, vb, xb):
    """Dynamic shared memory (barriers, ring, x) plus the static team sums
    stays within 232,448 bytes a block; stages are 16-byte (128-byte)
    units of 2 to 6; a stage holds its tile of whole rows and the spans'
    alignment slack, or a piece whose slots are a multiple of 4 x the
    team's lanes."""
    r, k, lc, m = shape
    row = k * lc * (4 + vb)
    for sms, p in _plans(shape, vb, xb):
        assert p.smem_bytes + 4 * K.MV_CONSUMERS <= SMEM_BLOCK
        assert p.smem_bytes == BARRIERS + p.stages * p.stage_bytes + (
            K._x_region(m, xb) if p.xstage else 0)
        assert p.stage_bytes % 16 == 0 and p.stage_bytes % 128 == 0
        assert 2 <= p.stages <= K.MV_MAX_STAGES
        assert p.team in (1, 4) and K.MV_CONSUMERS % p.team == 0
        if p.tile_rows:
            assert p.piece == 0
            assert p.tile_rows * row + 64 <= p.stage_bytes
        else:
            unit = 4 * 32 * p.team
            assert p.piece > 0 and p.piece % unit == 0
            assert p.piece * (4 + vb) + 64 <= p.stage_bytes
            assert (p.stage_bytes - 64) // row == 0   # no whole row fits


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("vb,xb", DTYPES)
def test_x_is_staged_when_and_only_when_it_fits(shape, vb, xb):
    """x goes into shared memory when its bytes (with a head offset below
    16, in 128-byte units) fit beside the barriers and two least stages;
    else it is gathered through L1."""
    r, k, lc, m = shape
    need = -(-(m * xb + 15) // 128) * 128
    for sms, p in _plans(shape, vb, xb):
        assert p.xstage == (need + BARRIERS + 2 * LEAST_STAGE
                            <= SMEM_BLOCK - 2048)


def test_the_chip_shapes_stage_x_and_keep_a_deep_ring():
    """At the chip's kernel-5 shapes x is staged (16 / 44 KB in f32, half
    in bf16), each block walks whole rows, and the ring keeps over 128
    KB of rows in flight an SM; x of 65536 f32 columns (256 KB) is not
    staged and its 48 KB rows go in pieces."""
    for r, k, lc, m in CHIP:
        for vb, xb in DTYPES:
            p = K._mv_plan(r, k, lc, m, vb, xb)
            assert p.xstage and p.tile_rows >= 1
            assert p.stages * p.tile_rows * k * lc * (4 + vb) > 128 * 1024
            assert p.blocks == -(-r // -(-r // 132))
    wide = K._mv_plan(256, 128, 48, 65536, 4, 4)
    assert not wide.xstage and wide.tile_rows == 0 and wide.piece > 0
    assert K._mv_plan(256, 128, 48, 65536, 2, 2).xstage   # 128 KB of bf16


@pytest.mark.parametrize("k,lc", [(8, 88), (22, 88), (22, 13), (1, 8),
                                  (128, 8), (129, 8), (256, 8), (128, 48)])
def test_team_reads_the_rows_slots_alone(k, lc):
    """The bits condition: a row's team comes from K * Lc alone, so the
    same row walks the same way in the whole pack, a slice of its rows
    or a sharded bank, on any card, for any x or dtypes."""
    want = K.mv_team(k * lc)
    assert want == (1 if k * lc <= K.MV_WIDE_ROW_SLOTS else 4)
    for r in (1, 3, 64, 131, 4096, 12288, 100000):
        for m in (k * 512 - 511, k * 512):
            for vb, xb in DTYPES:
                for sms in SMS:
                    assert K._mv_plan(r, k, lc, m, vb, xb, sms).team == want


def _source() -> str:
    return re.sub(r"//[^\n]*", "", build.SOURCES["espim_spmv"].read_text())


def test_plan_fields_match_the_c_entry_and_its_constants():
    """``_spmv_launch`` passes the plan's fields in order after ``m``:
    they must be the C entry's parameters by name, and the plan's limits
    the source's constants."""
    src = _source()
    params = re.search(r"int espim_spmv\(([^)]*)\)", src).group(1)
    names = [p.split()[-1] for p in params.split(",")]
    tail = names[names.index("m") + 1:-1]
    assert tail == list(K.MvPlan._fields[:-1])
    consts = dict(re.findall(r"constexpr int (kMv\w+|kSmemLimit) = ([^;]+);",
                             src))
    assert int(consts["kMvConsumers"]) == K.MV_CONSUMERS
    assert int(consts["kMvMaxStages"]) == K.MV_MAX_STAGES
    assert int(consts["kMvBarBytes"]) == K.MV_BAR_BYTES == BARRIERS
    assert eval(consts["kSmemLimit"]) == K.MV_SMEM == SMEM_BLOCK - 2048
    assert "(m * xb + 15 + 127) / 128 * 128" in src


def test_the_warp_per_row_body_is_gone():
    """Kernel 5 launches only the mv body: the first design's kernel and
    helpers are deleted from the source."""
    src = _source()
    for name in ("espim_spmv_kernel", "row_accumulate", "launch_unbatched",
                 "kWarpsPerBlock", "load_x", "slot_value"):
        assert not re.search(rf"\b{name}\b", src), name
    assert "espim_spmv_mv_kernel" in src


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """On CPU tensors ``ops.espim_spmv`` runs the plain version, whatever
    the shape the plan would give, and counts no launch; the wrapper
    refuses them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as PR
    rng = np.random.default_rng(7)
    vals = torch.from_numpy(rng.standard_normal((5, 3, 13)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, 64, (5, 3, 13)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(150).astype(np.float32))
    K.reset_launches()
    got = ops.espim_spmv(vals, cols, x, chunk_cols=64)
    assert torch.equal(got, PR.espim_spmv_chunked_ref(vals, cols, x, 64))
    assert K.LAUNCHES["espim_spmv"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.espim_spmv_cuda(vals, cols, x, chunk_cols=64)
    empty = ops.espim_spmv(vals[:0], cols[:0], x, chunk_cols=64)
    assert empty.shape == (0,) and empty.dtype == torch.float32
    assert Path(build.SOURCES["espim_spmv"]).is_file()
