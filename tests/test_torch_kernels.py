"""The port's plain kernel versions (``repro_torch.kernels.ref``, which
``ops`` runs for CPU tensors) against the JAX package's jnp oracles AND
its Pallas kernels in interpret mode, at the tolerances of the JAX
package's own tests (``tests/test_kernels.py``,
``tests/test_flash_kernel.py``): 1e-5 in fp32 for the SpMV family, 3e-2
for bf16 SpMV, 1e-4 / 5e-2 for dense MV, 2e-5 / 5e-2 for attention.
The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.pruning import magnitude_prune  # noqa: E402
from repro.core.sparse_format import pack_ell, pack_ell_chunked  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import ref as RR  # noqa: E402
from repro.kernels.dense_mv import dense_mv_pallas  # noqa: E402
from repro.kernels.espim_spmv import (  # noqa: E402
    espim_spmv_batched_glu_pallas, espim_spmv_batched_pallas,
    espim_spmv_batched_quant_glu_pallas, espim_spmv_batched_quant_pallas,
    espim_spmv_batched_res_pallas, espim_spmv_pallas)
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.quant.qpack import nibble_pack  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ["silu", "gelu", "relu", "relu2"]
# the batches chip_smoke.CHECK_BATCHES holds the GLU kernels to on the card:
# every batch tile (1, 2, 4, 8), a tile's remainder (3), tiles of 8 (13)
GLU_BATCHES = [1, 2, 3, 4, 8, 13]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, *refs):
    for r in refs:
        np.testing.assert_allclose(port.numpy(), np.asarray(r), **TOL)


def _fp_pack(r, m, cc, seed):
    """A pruned random (r, m) matrix as a chunked-ELL pack."""
    rng = np.random.default_rng(seed)
    w = magnitude_prune(rng.standard_normal((r, m)).astype(np.float32), 0.85)
    pack = pack_ell_chunked(w, chunk_cols=cc)
    return (np.asarray(pack.values, np.float32),
            np.asarray(pack.cols, np.int32))


def _code_planes(r, m, cc, lc, bits, seed):
    """Synthetic quantized planes (r, K, lc): in-range chunk-local ids,
    codes within the bit width, a quarter of the slots pads (code 0,
    col 0).  Returns (int8 codes, device codes, cols)."""
    rng = np.random.default_rng(seed)
    k = -(-m // cc)
    lim = np.minimum(cc, m - np.arange(k) * cc)[None, :, None]
    cols = (rng.integers(0, 1 << 30, (r, k, lc)) % lim).astype(np.int32)
    qmax = 127 if bits == 8 else 7
    codes = rng.integers(-qmax, qmax + 1, (r, k, lc)).astype(np.int8)
    pad = rng.random((r, k, lc)) < 0.25
    codes[pad], cols[pad] = 0, 0
    if bits == 8:
        return codes, codes, cols
    even = codes if lc % 2 == 0 else np.concatenate(
        [codes, np.zeros((r, k, 1), np.int8)], axis=-1)
    return codes, nibble_pack(even), cols


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("cc", [64, 128, 512])
def test_batched_matches_reference_and_pallas(b, cc):
    vals, cols = _fp_pack(128, 300, cc, seed=cc + b)
    x = np.random.default_rng(b).standard_normal((300, b)).astype(np.float32)
    got = ops.espim_spmv_batched(_t(vals), _t(cols), _t(x), chunk_cols=cc)
    _close(got,
           RR.espim_spmv_batched_chunked_ref(jnp.asarray(vals),
                                             jnp.asarray(cols),
                                             jnp.asarray(x), cc),
           espim_spmv_batched_pallas(jnp.asarray(vals), jnp.asarray(cols),
                                     jnp.asarray(x), chunk_cols=cc,
                                     block_r=128, block_l=32))


@pytest.mark.parametrize("bits,lc", [(8, 12), (4, 12), (4, 7)])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("scaled", [False, True])
def test_quant_matches_reference_and_pallas(bits, lc, b, scaled):
    r, m, cc, gr = 64, 300, 128, 8
    _, dcodes, cols = _code_planes(r, m, cc, lc, bits, seed=lc + b)
    rng = np.random.default_rng(b)
    # x scaled by 1/qmax keeps the code-domain sums O(1), where a float32
    # sum-order difference stays inside the 1e-5 tolerance
    x = (rng.standard_normal((m, b)) / (2 ** (bits - 1) - 1)).astype(
        np.float32)
    scales = (rng.random(r // gr).astype(np.float32) + 0.5) * 0.01
    got = ops.espim_spmv_batched_quant(
        _t(dcodes), _t(cols), _t(scales) if scaled else None, _t(x),
        chunk_cols=cc, group_rows=gr)
    jd, jc, jx = jnp.asarray(dcodes), jnp.asarray(cols), jnp.asarray(x)
    want = RR.espim_spmv_batched_chunked_quant_ref(
        jd, jc, jnp.asarray(scales) if scaled else None, jx, cc, gr)
    # the Pallas kernel always scales; scales=None is its unit-scale case
    ks, kg = ((jnp.asarray(scales), gr) if scaled
              else (jnp.ones(1, jnp.float32), r))
    pallas = espim_spmv_batched_quant_pallas(jd, jc, ks, jx, chunk_cols=cc,
                                             group_rows=kg, block_r=64,
                                             block_l=32)
    _close(got, want, pallas)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("b", GLU_BATCHES)
def test_glu_matches_reference_and_pallas(act, b):
    vals, cols = _fp_pack(128, 300, 128, seed=7)
    # x / 8 keeps each row's gate and up sums (45 nonzeros of N(0, 1))
    # O(1), as the quant tests do: at unit-scale x the outputs reach 1e3 -
    # 5e4 and the JAX package's own jnp ref and Pallas kernel differ by up
    # to 12x the 1e-5 tolerance on a few elements near a cancellation
    # (float32 sum order) at B = 3, 8 and 13
    x = (np.random.default_rng(b).standard_normal((300, b)) / 8).astype(
        np.float32)
    got = ops.espim_spmv_batched(_t(vals), _t(cols), _t(x), chunk_cols=128,
                                 epilogue="glu", act=act)
    jv, jc, jx = jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)
    _close(got,
           RR.espim_spmv_batched_chunked_glu_ref(jv, jc, jx, 128, act),
           espim_spmv_batched_glu_pallas(jv, jc, jx, chunk_cols=128, act=act,
                                         block_r=64, block_l=32))


# int8 at an even Lc and int4 at an odd one, at every batch of
# GLU_BATCHES; B = 4 keeps its original test ids
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bits,lc,b", [
    pytest.param(bits, lc, b, id=f"{bits}-{lc}" + ("" if b == 4 else f"-b{b}"))
    for bits, lc in [(8, 12), (4, 7)] for b in GLU_BATCHES])
def test_quant_glu_matches_reference_and_pallas(act, bits, lc, b):
    r, m, cc = 128, 300, 128
    _, dcodes, cols = _code_planes(r, m, cc, lc, bits, seed=lc)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((m, b)) / (2 ** (bits - 1) - 1)).astype(
        np.float32)
    srow = (rng.random(r).astype(np.float32) + 0.5) * 0.01
    got = ops.espim_spmv_batched_quant(_t(dcodes), _t(cols), None, _t(x),
                                       chunk_cols=cc, epilogue="glu",
                                       act=act, srow=_t(srow))
    jd, jc, jx, js = (jnp.asarray(a) for a in (dcodes, cols, x, srow))
    _close(got,
           RR.espim_spmv_batched_chunked_quant_glu_ref(jd, jc, js, jx, cc,
                                                       act),
           espim_spmv_batched_quant_glu_pallas(jd, jc, js, jx, chunk_cols=cc,
                                               act=act, block_r=64,
                                               block_l=32))


def test_nibble_unpack_matches_reference_bit_exact():
    packed = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(
        PR.nibble_unpack_ref(_t(packed)).numpy(),
        np.asarray(RR.nibble_unpack_ref(jnp.asarray(packed))))


@pytest.mark.parametrize("act", ACTS)
def test_epilogue_act_matches_reference(act):
    v = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(PR.epilogue_act(act)(_t(v)).numpy(),
                               np.asarray(RR.epilogue_act(act)(
                                   jnp.asarray(v))), rtol=1e-6, atol=1e-6)


def test_scatter_rows_ref_pad_rows():
    yp = torch.tensor([1.0, 2.0, 3.0, 4.0])
    perm = torch.tensor([2, 0, -1, 1], dtype=torch.int32)
    out = PR.scatter_rows_ref(yp, perm, 3)
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0, 1.0])
    want = RR.scatter_rows_ref(jnp.asarray(yp.numpy()),
                               jnp.asarray(perm.numpy()), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want))


def test_ops_dispatch_guards():
    vals, cols = _fp_pack(32, 100, 64, seed=1)
    v, c = _t(vals), _t(cols)
    x = torch.ones((100, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=64, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=64, impl="pallas")
    with pytest.raises(ValueError, match="chunk_cols is required"):
        ops.espim_spmv_batched(v, c, x)
    with pytest.raises(ValueError, match="inconsistent"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=512)
    with pytest.raises(ValueError, match="needs the residual operand"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=64, epilogue="residual")
    with pytest.raises(ValueError, match="needs the residual operand"):
        ops.espim_spmv_batched_quant(v.to(torch.int8), c, None, x,
                                     chunk_cols=64, epilogue="residual")
    with pytest.raises(ValueError, match="needs srow"):
        ops.espim_spmv_batched_quant(v.to(torch.int8), c, None, x,
                                     chunk_cols=64, epilogue="glu")
    with pytest.raises(ValueError, match="column-chunked"):
        ops.espim_spmv_batched(v[:, 0], c[:, 0], x, chunk_cols=64)
    # "ref" and the default agree bit for bit on the CPU
    assert torch.equal(ops.espim_spmv_batched(v, c, x, chunk_cols=64),
                       ops.espim_spmv_batched(v, c, x, chunk_cols=64,
                                              impl="ref"))


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — they never run
    a CPU tensor (that is ``ops``' plain-version dispatch)."""
    from repro_torch.kernels import espim_spmv as K
    vals, cols = _fp_pack(32, 100, 64, seed=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.espim_spmv_batched_cuda(_t(vals), _t(cols), torch.ones(100, 1),
                                  chunk_cols=64)
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_kernel_library_is_keyed_by_source_and_needs_nvcc(monkeypatch,
                                                          tmp_path):
    """The CUDA library builds under build/repro_torch at the repository
    root, named by a hash of source and flags; without nvcc the build
    raises (it never falls back)."""
    from pathlib import Path

    from repro_torch.kernels import build as B
    root = Path(__file__).resolve().parents[1]
    path = B.library_path("espim_spmv")
    assert path.parent == root / "build" / "repro_torch"
    assert path.name.startswith("libespim_spmv_") and path.suffix == ".so"
    monkeypatch.setattr(B, "NVCC_FLAGS", B.NVCC_FLAGS + ("-lineinfo",))
    assert B.library_path("espim_spmv") != path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        B.find_nvcc()


# --------------------------------------------------------------------------
# kernels 5-8: the unbatched SpMV, the residual epilogue, dense MV and
# flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("r,c,sparsity", [
    (128, 256, 0.9), (256, 1000, 0.8), (384, 512, 0.5), (128, 128, 0.95),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unbatched_matches_reference_and_pallas(r, c, sparsity, dtype):
    """``tests/test_kernels.py:26-38``: the same packs, x and tolerances
    (1e-5 fp32, 3e-2 bf16), the bf16 planes rounded once on each side."""
    rng = np.random.default_rng(0)
    w = magnitude_prune(rng.standard_normal((r, c)).astype(np.float32),
                        sparsity)
    pack = pack_ell_chunked(w, chunk_cols=128)
    x = rng.standard_normal(c).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jv, jc, jx = (jnp.asarray(pack.values, jd),
                  jnp.asarray(pack.cols, jnp.int32), jnp.asarray(x, jd))
    got = ops.espim_spmv(_t(pack.values).to(td), _t(pack.cols), _t(x).to(td),
                         chunk_cols=pack.chunk_cols)
    assert got.dtype == torch.float32 and got.shape == (pack.r_pad,)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in (RR.espim_spmv_chunked_ref(jv, jc, jx, pack.chunk_cols),
                 espim_spmv_pallas(jv, jc, jx, chunk_cols=pack.chunk_cols,
                                   block_r=128, block_l=64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("batched", [False, True])
def test_plain_layout_matches_reference(batched):
    """The plain (R_pad, L) ELL layout: plain versions only, as in the
    reference (``tests/test_kernels.py::test_plain_ell_requires_ref_impl``);
    the kernels' impls raise."""
    rng = np.random.default_rng(3)
    w = magnitude_prune(rng.standard_normal((128, 300)).astype(np.float32),
                        0.9)
    pack = pack_ell(w)
    x = rng.standard_normal((300, 4) if batched else 300).astype(np.float32)
    op, rop = ((ops.espim_spmv_batched, RO.espim_spmv_batched) if batched
               else (ops.espim_spmv, RO.espim_spmv))
    v, c = _t(pack.values), _t(pack.cols.astype(np.int32))
    got = op(v, c, _t(x), impl="ref")
    want = rop(jnp.asarray(pack.values), jnp.asarray(pack.cols, jnp.int32),
               jnp.asarray(x), impl="ref")
    _close(got, want)
    for impl in (None, "cuda"):
        with pytest.raises(ValueError, match="column-chunked"):
            op(v, c, _t(x), impl=impl)


@pytest.mark.parametrize("b", GLU_BATCHES)
def test_residual_matches_reference_and_pallas(b):
    """``tests/test_autotune.py:291-300``: the fp residual epilogue against
    the reference's ref lowering (bit-exact there: the same sums) and its
    Pallas kernel (1e-5), at every batch tile the streaming body that runs
    it on the card instantiates (1, 2, 4, 8), a remainder (3) and tiles of
    8 (13)."""
    rng = np.random.default_rng(11)
    rg, m = 64, 256
    w = (rng.standard_normal((2 * rg, m))
         * (rng.random((2 * rg, m)) < 0.15)).astype(np.float32)
    pack = pack_ell_chunked(w, chunk_cols=128)
    x = rng.standard_normal((m, b)).astype(np.float32)
    res = rng.standard_normal((pack.r_pad, b)).astype(np.float32)
    got = ops.espim_spmv_batched(_t(pack.values), _t(pack.cols), _t(x),
                                 chunk_cols=pack.chunk_cols,
                                 epilogue="residual", residual=_t(res))
    plain = ops.espim_spmv_batched(_t(pack.values), _t(pack.cols), _t(x),
                                   chunk_cols=pack.chunk_cols)
    assert torch.equal(got, plain + _t(res))
    jv, jc = jnp.asarray(pack.values), jnp.asarray(pack.cols, jnp.int32)
    jx, jr = jnp.asarray(x), jnp.asarray(res)
    _close(got,
           RO.espim_spmv_batched(jv, jc, jx, chunk_cols=pack.chunk_cols,
                                 impl="ref", epilogue="residual",
                                 residual=jr),
           espim_spmv_batched_res_pallas(jv, jc, jx, jr,
                                         chunk_cols=pack.chunk_cols,
                                         block_r=64, block_l=32))


@pytest.mark.parametrize("bits,lc", [(8, 12), (4, 7)])
@pytest.mark.parametrize("scaled", [False, True])
def test_quant_residual_matches_reference(bits, lc, scaled):
    """The quant residual epilogue is op-level: the scaled (or, with
    ``scales=None``, ``srow``-scaled) product plus the residual."""
    r, m, cc, gr, b = 64, 300, 128, 8, 4
    _, dcodes, cols = _code_planes(r, m, cc, lc, bits, seed=lc)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((m, b)) / (2 ** (bits - 1) - 1)).astype(
        np.float32)
    scales = (rng.random(r // gr).astype(np.float32) + 0.5) * 0.01
    srow = np.repeat(scales, gr)
    res = rng.standard_normal((r, b)).astype(np.float32)
    kw = (dict(scales=scales, srow=None) if scaled
          else dict(scales=None, srow=srow))
    got = ops.espim_spmv_batched_quant(
        _t(dcodes), _t(cols), None if kw["scales"] is None
        else _t(kw["scales"]), _t(x), chunk_cols=cc, group_rows=gr,
        epilogue="residual", residual=_t(res),
        srow=None if kw["srow"] is None else _t(kw["srow"]))
    want = RO.espim_spmv_batched_quant(
        jnp.asarray(dcodes), jnp.asarray(cols),
        None if kw["scales"] is None else jnp.asarray(kw["scales"]),
        jnp.asarray(x), chunk_cols=cc, group_rows=gr, impl="ref",
        epilogue="residual", residual=jnp.asarray(res),
        srow=None if kw["srow"] is None else jnp.asarray(kw["srow"]))
    _close(got, want)


@pytest.mark.parametrize("r,c", [(128, 128), (200, 333), (384, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_mv_matches_reference_and_pallas(r, c, dtype):
    """``tests/test_kernels.py:77-86``: tolerances 1e-4 fp32, 5e-2 bf16."""
    rng = np.random.default_rng(r + c)
    w = rng.standard_normal((r, c)).astype(np.float32)
    x = rng.standard_normal(c).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = ops.dense_mv(_t(w).to(getattr(torch, dtype)),
                       _t(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    jw, jx = jnp.asarray(w, jd), jnp.asarray(x, jd)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for want in (RR.dense_mv_ref(jw, jx),
                 dense_mv_pallas(jw, jx, block_r=128, block_c=128)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def _flash_oracle(q, k, v, causal):
    bh, s, hd = q.shape
    return RL.flash_attention(
        q.reshape(bh, s, 1, hd), k.reshape(bh, s, 1, hd),
        v.reshape(bh, s, 1, hd), causal=causal, q_chunk=64, kv_chunk=64,
    ).reshape(bh, s, hd)


@pytest.mark.parametrize("s,hd,causal,blk", [
    (256, 64, True, 64), (128, 128, False, 128), (77, 32, True, 32),
    (200, 64, True, 128),
])
def test_flash_attention_matches_reference_and_pallas(s, hd, causal, blk):
    """``tests/test_flash_kernel.py``'s shapes, at its 2e-5."""
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.standard_normal((3, s, hd)).astype(np.float32)
               for _ in range(3))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (3, s, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (_flash_oracle(jq, jk, jv, causal),
                 flash_attention_pallas(jq, jk, jv, causal=causal,
                                        blk_q=blk, blk_k=blk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_matches_reference_and_pallas():
    """``tests/test_flash_kernel.py::test_flash_pallas_bf16`` at 5e-2; the
    output stays bf16."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 128, 64)).astype(np.float32)
               for _ in range(3))
    got = flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    f32 = [a.astype(jnp.float32) for a in (jq, jk, jv)]
    for want in (_flash_oracle(*f32, True),
                 flash_attention_pallas(jq, jk, jv, blk_q=64, blk_k=64)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=5e-2,
                                   atol=5e-2)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_ragged_matches_reference_and_pallas(hd,
                                                                  causal):
    """bf16 at the other head widths the kernel is built for (32: 64-byte
    swizzle, 64: 128-byte) and a ragged S = 200, against the reference's
    oracle and its Pallas kernel at 5e-2; the output stays bf16."""
    rng = np.random.default_rng(hd + causal)
    q, k, v = (rng.standard_normal((2, 200, hd)).astype(np.float32)
               for _ in range(3))
    got = flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 200, hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    f32 = [a.astype(jnp.float32) for a in (jq, jk, jv)]
    for want in (_flash_oracle(*f32, causal),
                 flash_attention_pallas(jq, jk, jv, causal=causal, blk_q=64,
                                        blk_k=64)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=5e-2,
                                   atol=5e-2)


# bf16 value planes on the batched kernels (kernels 1, 3 and 6 take them
# on the card; each activation of the GLU at one of the batches)
BF16_BATCHES = [1, 3, 4, 13]


@pytest.mark.parametrize("epilogue,act,b", [
    *[pytest.param(e, None, b, id=f"{e}-b{b}") for e in ("plain", "residual")
      for b in BF16_BATCHES],
    *[pytest.param("glu", a, b, id=f"glu-{a}-b{b}")
      for a, b in zip(ACTS, BF16_BATCHES)]])
def test_bf16_planes_match_pallas(epilogue, act, b):
    """``ops.espim_spmv_batched`` on a bf16 value plane (plain, residual
    and GLU epilogues) against the reference's Pallas kernels in interpret
    mode on the same bf16 pack (which cast the values to f32 in the
    kernel), within the JAX package's bf16 tolerance of 3e-2."""
    rng = np.random.default_rng(20 + b)
    w = magnitude_prune(rng.standard_normal((128, 300)).astype(np.float32),
                        0.85)
    pack = pack_ell_chunked(w, chunk_cols=128)
    vals = np.asarray(pack.values, np.float32)
    cols = np.asarray(pack.cols, np.int32)
    x = (rng.standard_normal((300, b)) / 8).astype(np.float32)
    jv, jc, jx = (jnp.asarray(vals, jnp.bfloat16), jnp.asarray(cols),
                  jnp.asarray(x))
    tv, tc, tx = _t(vals).to(torch.bfloat16), _t(cols), _t(x)
    kw = dict(chunk_cols=128, block_r=64, block_l=32)
    if epilogue == "plain":
        got = ops.espim_spmv_batched(tv, tc, tx, chunk_cols=128)
        want = espim_spmv_batched_pallas(jv, jc, jx, **kw)
    elif epilogue == "residual":
        res = rng.standard_normal((pack.r_pad, b)).astype(np.float32)
        got = ops.espim_spmv_batched(tv, tc, tx, chunk_cols=128,
                                     epilogue="residual", residual=_t(res))
        want = espim_spmv_batched_res_pallas(jv, jc, jx, jnp.asarray(res),
                                             **kw)
    else:
        got = ops.espim_spmv_batched(tv, tc, tx, chunk_cols=128,
                                     epilogue="glu", act=act)
        want = espim_spmv_batched_glu_pallas(jv, jc, jx, act=act, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


def test_espim_matvec_bf16_pack_with_2d_x_matches_pallas():
    """The case that raised on the card before bf16 planes reached the
    batched kernels: ``espim_matvec`` on a bf16 ``pack_to_device`` pack
    of a 200 x 500 matrix at 90% sparsity, x (500, 4), against the
    reference's ``espim_matvec(impl="pallas")`` on its bf16 pack of the
    same matrix, within 3e-2."""
    from repro.core import sparse_format as RSF

    from repro_torch.core import sparse_format as PSF
    rng = np.random.default_rng(7)
    w = magnitude_prune(rng.standard_normal((200, 500)).astype(np.float32),
                        0.9)
    x = rng.standard_normal((500, 4)).astype(np.float32)
    got = ops.espim_matvec(
        ops.pack_to_device(PSF.pack_ell_chunked(w, chunk_cols=128),
                           dtype=torch.bfloat16, device="cpu"), _t(x))
    want = RO.espim_matvec(
        RO.pack_to_device(RSF.pack_ell_chunked(w, chunk_cols=128),
                          dtype=jnp.bfloat16), jnp.asarray(x),
        impl="pallas")
    assert got.shape == (200, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("hd", [48, 80, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_head_padding_matches_pallas(hd, causal):
    """The kernel's wrapper zero-pads a head width it is not built for up
    to the next one (48 -> 64, 80 and 96 -> 128) and passes the softmax
    scale of the true hd: run through the plain version, the padded
    attention equals ``flash_attention_pallas`` at that hd within 2e-5."""
    from repro_torch.kernels.flash_attention import pad_heads
    rng = np.random.default_rng(hd + causal)
    q, k, v = (rng.standard_normal((2, 40, hd)).astype(np.float32)
               for _ in range(3))
    seen = []

    def plain(qp, kp, vp, cz, scale):
        seen.append((qp.shape[-1], scale))
        return PR.flash_attention_ref(qp, kp, vp, cz, scale=scale)

    got = pad_heads(plain, _t(q), _t(k), _t(v), causal)
    assert seen == [({48: 64}.get(hd, 128), 1.0 / np.sqrt(hd))]
    assert got.shape == (2, 40, hd) and got.is_contiguous()
    want = flash_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=causal, blk_q=64, blk_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_head_width_above_the_widest_built_raises():
    """hd > 128 has no width to pad to: the error names the widths the
    kernel is built for."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS, pad_heads
    q = torch.zeros((1, 8, 160))
    with pytest.raises(ValueError, match=r"hd in \(32, 64, 128\)"):
        pad_heads(lambda *a: a[0], q, q, q, True)
    assert HEAD_DIMS == (32, 64, 128)


def _attention_bf16_p(q, k, v, causal, drop=None):
    """Attention as the wgmma body computes it, in plain PyTorch: fp32
    scores and softmax state, P rounded to bf16 before P.V, the output in
    bf16; ``drop`` = (first, end) keys left out, a planted fault."""
    s, hd = q.shape[1], q.shape[2]
    scores = (q.float() / np.sqrt(hd)) @ k.float().transpose(1, 2)
    pos = torch.arange(s)
    keep = pos[None, :] <= pos[:, None] if causal else torch.ones(
        s, s, dtype=torch.bool)
    if drop is not None:
        keep = keep & ((pos < drop[0]) | (pos >= drop[1]))[None, :]
    scores = scores.masked_fill(~keep, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, keepdim=True)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_check_catches_a_dropped_key_tile(causal):
    """``chip_smoke``'s bf16 attention check at S = 2048, hd = 128: the
    output the wgmma body computes (P in bf16) passes it, and the output
    of a body that skipped the last key tile of 128 fails it, through the
    relative L2 bound (causal: every element stays within the elementwise
    5e-2 + 5e-2 |plain|, since only the last 128 rows lose a few keys)."""
    smoke = _chip_smoke()
    bound = smoke.REL_L2_TOL["flash_attention/bf16"]
    rng = np.random.default_rng(15 + causal)
    q, k, v = (_t(rng.standard_normal((1, 2048, 128)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = PR.flash_attention_ref(q, k, v, causal)
    sound = _attention_bf16_p(q, k, v, causal)
    assert smoke._within("flash_attention", "bf16", sound, want)[0]
    assert smoke.rel_l2(sound, want) < bound / 2
    faulty = _attention_bf16_p(q, k, v, causal, drop=(1920, 2048))
    if causal:                  # the elementwise limit alone passes it
        diff = (faulty.float() - want.float()).abs()
        assert bool((diff <= 5e-2 + 5e-2 * want.float().abs()).all())
    assert not smoke._within("flash_attention", "bf16", faulty, want)[0]
    assert smoke.rel_l2(faulty, want) > bound


def test_new_wrappers_reject_cpu_tensors_and_dispatch():
    """Kernels 5-8's wrappers launch on CUDA tensors or raise; their ops
    take the plain version for CPU tensors and refuse impl='cuda'."""
    from repro_torch.kernels import dense_mv as D
    from repro_torch.kernels import espim_spmv as K
    from repro_torch.kernels import flash_attention as FA
    vals, cols = _fp_pack(32, 100, 64, seed=3)
    v, c = _t(vals), _t(cols)
    q = torch.ones((1, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.espim_spmv_cuda(v, c, torch.ones(100), chunk_cols=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.espim_spmv_batched_res_cuda(v, c, torch.ones(100, 1),
                                      torch.zeros(32, 1), chunk_cols=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        D.dense_mv_cuda(torch.ones(4, 8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.espim_spmv(v, c, torch.ones(100), chunk_cols=64, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dense_mv(torch.ones(4, 8), torch.ones(8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, q, q, impl="pallas")
    assert all(n == 0 for mod in (K, D, FA) for n in mod.LAUNCHES.values())
    assert torch.equal(flash_attention(q, q, q),
                       PR.flash_attention_ref(q, q, q, True))


@pytest.mark.parametrize("name", ["espim_spmv", "dense_mv",
                                  "flash_attention", "wkv",
                                  "decode_attention"])
def test_every_source_has_a_hashed_library(name):
    """One library per CUDA source, each named by a hash of its own
    source and the flags, under build/repro_torch."""
    from repro_torch.kernels import build as B
    assert B.SOURCES[name].is_file()
    path = B.library_path(name)
    assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    others = {B.library_path(n) for n in B.SOURCES if n != name}
    assert path not in others and path.parent == B.build_dir()


# __global__ functions of the port's sources that are not SpMV kernels
NOT_SPMV_KERNELS = ("dense_mv_kernel", "flash_attention_tf32_kernel",
                    "flash_attention_wgmma_kernel", "wkv6_fwd_kernel",
                    "wkv6_bwd_kernel", "wkv6_du_kernel",
                    "decode_attention_kernel")


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports no torch at load)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _global_kernels(source):
    """Names of the ``__global__`` functions a CUDA source defines."""
    import re
    text = re.sub(r"//[^\n]*", "", source.read_text())
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s*)?(\w+)\s*\(", text)


def test_every_spmv_kernel_counts_in_the_profilers_spmv_share():
    """``chip_smoke`` sums the device time of the trace's kernels whose
    names contain one of ``SPMV_KERNEL_NAMES`` into the decode step's SpMV
    share: every ``__global__`` function of ``espim_spmv.cu`` must match
    one, and every other source's kernel must be listed as not an SpMV
    and match none, so renaming or adding a kernel cannot silently move
    its time out of (or into) the share."""
    from repro_torch.kernels import build as B
    names = _chip_smoke().SPMV_KERNEL_NAMES
    found = {}
    for lib, src in B.SOURCES.items():
        for k in _global_kernels(src):
            found[k] = lib
    assert set(found.values()) == set(B.SOURCES)
    assert "espim_spmv_stream_glu_kernel" in found
    for k, lib in found.items():
        spmv = any(n in k for n in names)
        if lib == "espim_spmv":
            assert spmv and k not in NOT_SPMV_KERNELS, k
        else:
            assert not spmv and k in NOT_SPMV_KERNELS, k


def _extern_c_signatures(source):
    """{function: [kind, ...]} of every function defined in the source's
    ``extern "C"`` block: "p" for a pointer parameter, else its type."""
    import re
    text = re.sub(r"//[^\n]*", "", source.read_text())
    block = text.split('extern "C" {', 1)[1].split('}  // extern "C"')[0]
    sigs = {}
    for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
        kinds = []
        for param in m.group(2).split(","):
            decl = param.strip()
            kinds.append("p" if "*" in decl else decl.split()[-2])
        sigs[m.group(1)] = kinds
    return sigs


@pytest.mark.parametrize("name", ["espim_spmv", "dense_mv",
                                  "flash_attention", "wkv",
                                  "decode_attention"])
def test_ctypes_signatures_match_the_sources(name):
    """Every ``extern "C"`` entry point of a CUDA source is bound by
    ``build._SIGNATURES`` with the same parameter count and kinds (a
    pointer as c_void_p, an int as c_int, a float as c_float), and every
    bound name exists in the source: a mismatch would pass a cut pointer
    or a shifted argument to the kernel on the card."""
    import ctypes

    from repro_torch.kernels import build as B
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    src = _extern_c_signatures(B.SOURCES[name])
    bound = {fn: [kind[t] for t in argtypes]
             for fn, argtypes in B._SIGNATURES[name].items()}
    assert src and src == bound
