"""The hand-written kernels' ``torch.library`` ops under ``FakeTensorMode``
(``kernels/library.py``): each of the eight launch wrappers, and the WKV
recurrence's forward and backward, called on fake ``cuda`` tensors,
gives its plain version's output shapes and dtypes without a card, a
data pointer or a launch count; and the cost analysis
reads each op's FLOPs and bytes equal to ``chip_smoke.py``'s bound
column at the kernel table's shapes (``PERF.md`` §6)."""
import contextlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import dense_mv as DM  # noqa: E402
from repro_torch.kernels import espim_spmv as SP  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as KR  # noqa: E402
from repro_torch.kernels import wkv as WKV  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import analyze_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CC = 64


def _planes(gen, r, k, lc, dtype=torch.float32):
    cols = torch.randint(0, CC, (r, k, lc), generator=gen,
                         dtype=torch.int32)
    return torch.randn((r, k, lc), generator=gen).to(dtype), cols


def _cases():
    """kernel -> (wrapper on the tensors, plain version on the tensors,
    the tensors)."""
    gen = torch.Generator().manual_seed(0)
    vals, cols = _planes(gen, 8, 3, 5)
    codes = torch.randint(-127, 128, (8, 3, 5), generator=gen,
                          dtype=torch.int8)
    x = torch.randn((3 * CC, 4), generator=gen)
    x1 = torch.randn((3 * CC,), generator=gen)
    res = torch.randn((8, 4), generator=gen)
    srow = torch.rand((8,), generator=gen)
    w = torch.randn((6, 40), generator=gen)
    wx = torch.randn((40,), generator=gen)
    q = torch.randn((2, 9, 80), generator=gen).to(torch.bfloat16)
    # the WKV: bf16 r / k / v, B 2 x S 40 (two checkpoints), H 3, K' 16,
    # V 64
    rkv = [torch.randn(shape, generator=gen).to(torch.bfloat16)
           for shape in ((2, 40, 3, 16), (2, 40, 3, 16), (2, 40, 3, 64))]
    wus = [torch.rand((2, 40, 3, 16), generator=gen),
           torch.randn((3, 16), generator=gen),
           torch.randn((2, 3, 16, 64), generator=gen)]
    gy = torch.randn((2, 40, 3, 64), generator=gen)

    # a take group of two int8 buckets (Lc 5 and 4) with per-row scales,
    # 12 packed rows onto 10 logical rows; an fp32 gate+up group of two
    # half-major buckets (4 and 2 pairs)
    codes2 = torch.randint(-127, 128, (4, 3, 4), generator=gen,
                           dtype=torch.int8)
    cols2 = torch.randint(0, CC, (4, 3, 4), generator=gen, dtype=torch.int32)
    srow2 = torch.rand((4,), generator=gen)
    perm = torch.tensor([3, -1, 0, 9, 1, 2, 8, 4, -1, 5, 7, 6],
                        dtype=torch.int32)
    gvals, gcols = _planes(gen, 4, 3, 6)

    def group_take(impl):
        def call(q0, c0, s0, q1, c1, s1, p, x):
            kw = dict(chunk_cols=CC, srow=[s0, s1], perm=p, n_out=10)
            if impl == "cuda":
                return SP.espim_spmv_group_cuda([q0, q1], [c0, c1], x, **kw)
            return ops.espim_spmv_group([q0, q1], [c0, c1], x, **kw)
        return call

    def group_glu(impl):
        def call(v0, c0, v1, c1, x):
            kw = dict(chunk_cols=CC, act="silu")
            if impl == "cuda":
                return SP.espim_spmv_group_cuda([v0, v1], [c0, c1], x, **kw)
            return ops.espim_spmv_group([v0, v1], [c0, c1], x, **kw)
        return call

    def wkv_bwd(r, k, v, w, u, st, gy):
        ckpt = WKV.wkv6_cuda(r, k, v, w, u, st, WKV.CHUNK)[2]
        return WKV.wkv6_bwd_cuda(r, k, v, w, u, ckpt, gy, st)

    return {
        "espim_spmv": (
            lambda v, c, x: SP.espim_spmv_cuda(v, c, x, chunk_cols=CC),
            lambda v, c, x: ops.espim_spmv(v, c, x, chunk_cols=CC),
            (vals, cols, x1)),
        "espim_spmv_batched": (
            lambda v, c, x: SP.espim_spmv_batched_cuda(v, c, x,
                                                       chunk_cols=CC),
            lambda v, c, x: ops.espim_spmv_batched(v, c, x, chunk_cols=CC),
            (vals, cols, x)),
        "espim_spmv_batched_res": (
            lambda v, c, x, r: SP.espim_spmv_batched_res_cuda(
                v, c, x, r, chunk_cols=CC),
            lambda v, c, x, r: ops.espim_spmv_batched(
                v, c, x, chunk_cols=CC, epilogue="residual", residual=r),
            (vals, cols, x, res)),
        "espim_spmv_batched_quant": (
            lambda q, c, x: SP.espim_spmv_batched_quant_cuda(
                q, c, None, x, chunk_cols=CC),
            lambda q, c, x: ops.espim_spmv_batched_quant(
                q, c, None, x, chunk_cols=CC),
            (codes, cols, x)),
        "espim_spmv_batched_glu": (
            lambda v, c, x: SP.espim_spmv_batched_glu_cuda(v, c, x,
                                                           chunk_cols=CC),
            lambda v, c, x: ops.espim_spmv_batched(
                v, c, x, chunk_cols=CC, epilogue="glu", act="silu"),
            (vals, cols, x)),
        "espim_spmv_batched_quant_glu": (
            lambda q, c, s, x: SP.espim_spmv_batched_quant_glu_cuda(
                q, c, s, x, chunk_cols=CC),
            lambda q, c, s, x: ops.espim_spmv_batched_quant(
                q, c, None, x, chunk_cols=CC, epilogue="glu", act="silu",
                srow=s),
            (codes, cols, srow, x)),
        "espim_spmv_group:take": (
            group_take("cuda"), group_take(None),
            (codes, cols, srow, codes2, cols2, srow2, perm, x)),
        "espim_spmv_group:glu": (
            group_glu("cuda"), group_glu(None),
            (vals, cols, gvals, gcols, x)),
        "dense_mv": (DM.dense_mv_cuda, ops.dense_mv, (w, wx)),
        # hd 80: the wrapper zero-pads to 128 and slices back
        "flash_attention": (
            lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=True),
            lambda q, k, v: FA.flash_attention(q, k, v, causal=True),
            (q, q.clone(), q.clone())),
        "wkv6": (lambda *ts: WKV.wkv6_cuda(*ts)[:2], KR.wkv6_ref,
                 (*rkv, *wus)),
        "wkv6_bwd": (wkv_bwd,
                     lambda r, k, v, w, u, st, gy: KR.wkv6_bwd_ref(
                         r, k, v, w, u, st, gy, st),
                     (*rkv, *wus, gy)),
    }


def _indexing():
    """A CPU-only PyTorch cannot index or slice fake ``cuda`` tensors from
    Python (the binding takes a CUDA device guard): the dry run's aten
    indexing there, nothing on a CUDA build."""
    if torch.backends.cuda.is_built():
        return contextlib.nullcontext()
    return dryrun._CudaIndexing()


def _launches() -> dict:
    return {**SP.LAUNCHES, **DM.LAUNCHES, **FA.LAUNCHES, **WKV.LAUNCHES}


@pytest.mark.parametrize("kernel", sorted(_cases()))
def test_op_traces_on_fake_cuda_tensors(kernel):
    wrapper, plain, tensors = _cases()[kernel]
    want = plain(*tensors)
    before = _launches()
    with FakeTensorMode(), _indexing():
        fakes = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
                 for t in tensors]
        got = wrapper(*fakes)
        got = got if isinstance(got, tuple) else (got,)
        assert all(g.device.type == "cuda" for g in got)
    want = want if isinstance(want, tuple) else (want,)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert _launches() == before
    # one counter per op; a grouped launch counts as the kernel it computes
    assert _COUNTED.get(kernel, kernel) in before


_COUNTED = {"espim_spmv_group:take": "espim_spmv_batched_quant",
            "espim_spmv_group:glu": "espim_spmv_batched_glu"}


def _fake_cost(fn, *shapes):
    """(flops, bytes) the cost analysis reads of ``fn`` on fake cuda
    tensors of ``shapes`` ((shape, dtype) pairs)."""
    with FakeTensorMode():
        ts = [torch.empty(s, dtype=d, device="cuda") for s, d in shapes]
        cost = analyze_step(fn, *ts)
    assert cost.flops == cost.dot_flops
    assert cost.bytes == cost.dot_bytes
    return cost.dot_flops, cost.bytes


# one full-width llama7b-espim bucket (rows, chunks of 512, Lc) at B = 4
R, K, LC, M, B = 4096, 8, 56, 4096, 4
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("kernel", [
    "espim_spmv_batched", "espim_spmv_batched_quant",
    "espim_spmv_batched_glu", "espim_spmv_batched_quant_glu",
    "espim_spmv_batched_res"])
def test_spmv_cost_equals_the_bound_column(kernel):
    """Kernels 1-4 and 6 against ``chip_smoke.case_bytes`` at one
    bucket's shape."""
    quant = "quant" in kernel
    planes = {"cols": ((R, K, LC), torch.int32),
              ("q" if quant else "values"): ((R, K, LC),
                                             torch.int8 if quant else F32)}
    if kernel == "espim_spmv_batched_quant_glu":
        planes["srow"] = ((R,), F32)
    rows_out = R // 2 if "glu" in kernel else R
    call = {
        "espim_spmv_batched": lambda v, c, x: SP.espim_spmv_batched_cuda(
            v, c, x, chunk_cols=512),
        "espim_spmv_batched_quant":
            lambda q, c, x: SP.espim_spmv_batched_quant_cuda(
                q, c, None, x, chunk_cols=512),
        "espim_spmv_batched_glu":
            lambda v, c, x: SP.espim_spmv_batched_glu_cuda(
                v, c, x, chunk_cols=512),
        "espim_spmv_batched_quant_glu":
            lambda q, c, s, x: SP.espim_spmv_batched_quant_glu_cuda(
                q, c, s, x, chunk_cols=512),
        "espim_spmv_batched_res":
            lambda v, c, x, r: SP.espim_spmv_batched_res_cuda(
                v, c, x, r, chunk_cols=512),
    }[kernel]
    order = (["q" if quant else "values", "cols"]
             + (["srow"] if "srow" in planes else []))
    shapes = [planes[k] for k in order] + [((M, B), F32)]
    if kernel == "espim_spmv_batched_res":
        shapes.append(((R, B), F32))
    flops, nbytes = _fake_cost(call, *shapes)
    with FakeTensorMode():
        case = {k: torch.empty(s, dtype=d, device="cuda")
                for k, (s, d) in planes.items()}
        case.update(kernel=kernel, m=M)
        if kernel == "espim_spmv_batched_res":
            case["res"] = None
        want_bytes, want_flops = chip_smoke.case_bytes(case, B)
    assert flops == want_flops == 2 * R * K * LC * B
    assert nbytes == want_bytes
    assert rows_out * B * 4 < nbytes


def test_unbatched_spmv_cost_equals_the_bound_column():
    """Kernel 5, 1-D x (row 5: values + cols + x + y; 2 slots)."""
    flops, nbytes = _fake_cost(
        lambda v, c, x: SP.espim_spmv_cuda(v, c, x, chunk_cols=512),
        ((R, K, LC), F32), ((R, K, LC), torch.int32), ((M,), F32))
    assert flops == 2 * R * K * LC
    assert nbytes == R * K * LC * 4 + R * K * LC * 4 + M * 4 + R * 4


def test_dense_mv_cost_equals_the_bound_column():
    """Kernel 7 at row 7's W 4096 x 11008 fp32."""
    r, c = 4096, 11008
    flops, nbytes = _fake_cost(DM.dense_mv_cuda, ((r, c), F32), ((c,), F32))
    assert flops == 2 * r * c
    assert nbytes == (r * c + c) * 4 + r * 4


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cost_equals_the_bound_column(causal):
    """Kernel 8 at row 8's BH 32, hd 128, S 2048, bf16."""
    bh, s, hd = 32, 2048, 128
    flops, nbytes = _fake_cost(
        lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=causal),
        *[((bh, s, hd), BF16)] * 3)
    pairs = s * (s + 1) // 2 if causal else s * s
    assert flops == 4 * bh * hd * pairs
    assert nbytes == 4 * bh * s * hd * 2


@pytest.mark.parametrize("glu", [False, True])
def test_group_cost_is_its_buckets_plus_srow_perm_and_output(glu):
    """The grouped op (one launch a group) costs what its buckets' launches
    cost, less the copies of x and the bucket outputs they count apiece:
    its flops are the sum of theirs, its bytes each bucket's planes once,
    x once, the scales (srow), the take's perm and its own output."""
    shapes = [(R, K, LC), (R // 2, K, LC + 8), (R // 4, K, LC - 8)]
    planes = [(((r, k, lc), torch.int8), ((r, k, lc), torch.int32),
               ((r,), F32)) for r, k, lc in shapes]
    xs = ((M, B), F32)
    rows = sum(r for r, _, _ in shapes)
    per = []
    for q, c, s in planes:
        if glu:
            def call(q, c, s, x):
                return SP.espim_spmv_batched_quant_glu_cuda(
                    q, c, s, x, chunk_cols=512)
        else:
            def call(q, c, s, x):
                return SP.espim_spmv_batched_quant_cuda(
                    q, c, s, x, chunk_cols=512, group_rows=1)
        per.append(_fake_cost(call, q, c, s, xs))
    n = len(planes)
    n_out = rows // 2 if glu else rows - 100
    perm = () if glu else (((rows,), torch.int32),)

    def grouped(*ts):
        qs, cs, ss = ts[0:3 * n:3], ts[1:3 * n:3], ts[2:3 * n:3]
        x = ts[3 * n]
        kw = (dict(act="silu") if glu else
              dict(perm=ts[3 * n + 1], n_out=n_out))
        return SP.espim_spmv_group_cuda(list(qs), list(cs), x,
                                        chunk_cols=512, srow=list(ss), **kw)

    flops, nbytes = _fake_cost(grouped, *[p for ps in planes for p in ps],
                               xs, *perm)
    out_b = [r // (2 if glu else 1) * B * 4 for r, _, _ in shapes]
    x_b = M * B * 4
    assert flops == sum(f for f, _ in per)
    assert nbytes == (sum(b for _, b in per) - n * x_b - sum(out_b) + x_b
                      + (0 if glu else rows * 4) + n_out * B * 4)
