"""The grouped SpMV op (``kernels/ops.espim_spmv_group``: one packed group's
buckets in one launch on the card, with the decode step's per-row scale,
concatenation and take in its epilogue), here through its plain version,
against the JAX package's ``_group_apply`` then ``_group_take``
(``src/repro/core/sparse_model.py``, its ``ref`` lowering) on the same
packs: a 2-layer reduced ``llama7b-espim`` in float32, fp32 / int8 / int4
planes, B in {1, 3, 4}.  Tolerance 1e-5 of max|reference|: XLA and torch
sum a bucket's slots in different orders.  Inside the port the grouped op
gives the per-bucket path's bits."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402

from _torch_parity import smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.kernels import espim_spmv as SP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REL = 1e-5
BATCHES = (1, 3, 4)


@pytest.fixture(scope="module")
def packs():
    """quant -> (reference sparse dict, port sparse dict), one prune and
    pack of the same float32 params each."""
    cfg, pcfg, params, tparams = smoke_model(n_layers=2)
    out = {}
    for quant in (None, "int8", "int4"):
        out[quant] = (RSM.sparsify_model(cfg, params, 0.9, quant=quant),
                      PSM.sparsify_model(pcfg, tparams, 0.9, quant=quant,
                                         device="cpu"))
    return out


def _ref_groups(rs, layer, xts):
    """The reference's output of each group at ``layer`` (x ``xts[name]``):
    its buckets' launches (the fused GLU for gate+up), concatenated, then
    its take; one jit for all groups, as the reference's step compiles
    them."""
    bufs = jax.tree.map(lambda a: a[layer], RSM._scan_bufs(rs))

    def run(bufs, xts):
        out = {}
        for name, gb in bufs.items():
            g, xt = rs["groups"][name], xts[name]
            if name != "gateup":
                parts = RSM._group_apply(g, gb, xt, "ref")
                out[name] = (RSM._group_take(gb, parts)
                             if g["output"] == "take"
                             else jnp.concatenate(parts, axis=0))
            else:
                out[name] = jnp.concatenate(
                    [RSM._bucket_spmv(g, buf, i, xt, "ref", epilogue="glu",
                                      act="silu")
                     for i, buf in enumerate(gb["bufs"])], axis=0)
        return out
    return jax.tree.map(np.asarray, jax.jit(run)(bufs, xts))


def _port_group(ps, name, layer, xt, impl=None, act=None):
    g = ps["groups"][name]
    gb = PSM._layer_bufs(ps, layer)[name]
    return PSM._group_apply(g, gb, xt, impl, act=act)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_group_matches_reference(packs, quant, b):
    """Every group of layer 1, the gate+up group with its GLU fused: the
    grouped op against the reference's per-bucket launches + scale,
    concatenation and take."""
    rs, ps = packs[quant]
    rng = np.random.default_rng(b)
    xs = {name: rng.standard_normal((g["n_cols"], b)).astype(np.float32)
          for name, g in ps["groups"].items()}
    want = _ref_groups(rs, 1, {n: jnp.asarray(x) for n, x in xs.items()})
    for name in ps["groups"]:
        act = "silu" if name == "gateup" else None
        got = _port_group(ps, name, 1, torch.from_numpy(xs[name]), act=act)
        assert got.shape == want[name].shape
        np.testing.assert_allclose(
            got.numpy(), want[name], rtol=0,
            atol=REL * float(np.abs(want[name]).max()))


def _odd_lc_group(rng, lcs=(7, 5, 9), rows=(6, 5, 3), k=3, cc=16):
    """int4 codes with odd Lc, nibble-packed (slot 2j the low nibble of
    byte j), three buckets, their per-row scales and a take's perm with
    two pad rows: (codes, cols, srow, perm) as numpy."""
    codes, cols, srow = [], [], []
    for r, lc in zip(rows, lcs):
        c = rng.integers(-7, 8, (r, k, lc)).astype(np.int8)
        if lc % 2:
            c = np.concatenate([c, np.zeros((r, k, 1), np.int8)], -1)
        u = c.astype(np.int16) & 0xF
        codes.append((u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8))
        cols.append(rng.integers(0, cc, (r, k, lc)).astype(np.int32))
        srow.append(rng.random(r).astype(np.float32))
    n = sum(rows)
    perm = np.full(n, -1, np.int32)
    perm[rng.permutation(n)[:n - 2]] = np.arange(n - 2)
    return codes, cols, srow, perm


@pytest.mark.parametrize("b", BATCHES)
def test_odd_lc_int4_group_matches_reference(b):
    """A take group of int4 buckets with odd Lc through both packages'
    per-bucket quantized versions (the reference infers the nibble plane
    from the width mismatch), scale, concatenation and take."""
    from repro.kernels import ops as rops
    rng = np.random.default_rng(10 + b)
    codes, cols, srow, perm = _odd_lc_group(rng)
    cc, m = 16, 3 * 16 - 5
    x = rng.standard_normal((m, b)).astype(np.float32)
    inv = np.argsort(np.where(perm < 0, len(perm), perm))[:len(perm) - 2]

    @jax.jit
    def ref(codes, cols, srow, x):
        parts = [rops.espim_spmv_batched_quant(q, c, None, x, chunk_cols=cc,
                                               impl="ref") * s[:, None]
                 for q, c, s in zip(codes, cols, srow)]
        return jnp.take(jnp.concatenate(parts, 0), jnp.asarray(inv), axis=0)
    want = np.asarray(ref(codes, cols, srow, x))
    got = ops.espim_spmv_group(
        [torch.from_numpy(q) for q in codes],
        [torch.from_numpy(c) for c in cols], torch.from_numpy(x),
        chunk_cols=cc, srow=[torch.from_numpy(s) for s in srow],
        perm=torch.from_numpy(perm), n_out=len(perm) - 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_group_is_the_per_bucket_path_in_bits(packs, quant):
    """The grouped op gives the bits of the path it replaced: one launch a
    bucket (``_bucket_spmv``: a quantized bucket times its srow, the
    gate+up bucket with its GLU), the concatenation and the take."""
    _, ps = packs[quant]
    rng = np.random.default_rng(5)
    for name, g in ps["groups"].items():
        act = "silu" if name == "gateup" else None
        gb = PSM._layer_bufs(ps, 1)[name]
        xt = torch.from_numpy(
            rng.standard_normal((g["n_cols"], 4)).astype(np.float32))
        parts = [PSM._bucket_spmv(g, buf, i, xt, None,
                                  epilogue="glu" if act else None)
                 for i, buf in enumerate(gb["bufs"])]
        want = torch.cat(parts, dim=0)
        if "inv" in gb:
            want = torch.index_select(want, 0, gb["inv"])
        assert torch.equal(_port_group(ps, name, 1, xt, act=act), want)


def test_pad_rows_are_never_written():
    """A take group whose pad rows (perm -1) hold NaN values: no output
    row takes a pad row's result, every logical row is written once."""
    rng = np.random.default_rng(3)
    _, cols, _, perm = _odd_lc_group(rng, lcs=(8, 6, 4))
    vals = [rng.standard_normal(c.shape).astype(np.float32) for c in cols]
    pads = np.flatnonzero(perm < 0)
    row0 = np.cumsum([0] + [c.shape[0] for c in cols])
    for p in pads:
        i = int(np.searchsorted(row0, p, side="right") - 1)
        vals[i][p - row0[i]] = np.nan
    x = torch.from_numpy(rng.standard_normal((45, 4)).astype(np.float32))
    got = ops.espim_spmv_group([torch.from_numpy(v) for v in vals],
                               [torch.from_numpy(c) for c in cols], x,
                               chunk_cols=16, perm=torch.from_numpy(perm),
                               n_out=len(perm) - len(pads))
    assert got.shape == (len(perm) - len(pads), 4)
    assert bool(torch.isfinite(got).all())
    want = torch.cat([ops.espim_spmv_batched(torch.from_numpy(v),
                                             torch.from_numpy(c), x,
                                             chunk_cols=16)
                      for v, c in zip(vals, cols)])
    keep = np.flatnonzero(perm >= 0)
    assert torch.equal(got[perm[keep]], want[keep])


def test_group_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only (the ops pick the plain
    version for the CPU); ``impl="cuda"`` on CPU tensors raises."""
    rng = np.random.default_rng(4)
    codes, cols, srow, perm = _odd_lc_group(rng)
    args = ([torch.from_numpy(q) for q in codes],
            [torch.from_numpy(c) for c in cols], torch.zeros((45, 4)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        SP.espim_spmv_group_cuda(*args, chunk_cols=16,
                                 srow=[torch.from_numpy(s) for s in srow],
                                 perm=torch.from_numpy(perm), n_out=13)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.espim_spmv_group(*args, chunk_cols=16, impl="cuda")
