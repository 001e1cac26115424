"""The port's plain kernel versions (``repro_torch.kernels.ref``, which
``ops`` runs for CPU tensors) against the JAX package's jnp oracles AND
its Pallas kernels 1-4 in interpret mode, at rtol = atol = 1e-5 as in
``tests/test_kernels.py``.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.pruning import magnitude_prune  # noqa: E402
from repro.core.sparse_format import pack_ell_chunked  # noqa: E402
from repro.kernels import ref as RR  # noqa: E402
from repro.kernels.espim_spmv import (  # noqa: E402
    espim_spmv_batched_glu_pallas, espim_spmv_batched_pallas,
    espim_spmv_batched_quant_glu_pallas, espim_spmv_batched_quant_pallas)
from repro.quant.qpack import nibble_pack  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ["silu", "gelu", "relu", "relu2"]


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
@pytest.mark.parametrize("b", [1, 4])
def test_glu_matches_reference_and_pallas(act, b):
    vals, cols = _fp_pack(128, 300, 128, seed=7)
    x = np.random.default_rng(b).standard_normal((300, b)).astype(np.float32)
    got = ops.espim_spmv_batched(_t(vals), _t(cols), _t(x), chunk_cols=128,
                                 epilogue="glu", act=act)
    jv, jc, jx = jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)
    _close(got,
           RR.espim_spmv_batched_chunked_glu_ref(jv, jc, jx, 128, act),
           espim_spmv_batched_glu_pallas(jv, jc, jx, chunk_cols=128, act=act,
                                         block_r=64, block_l=32))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bits,lc", [(8, 12), (4, 7)])
def test_quant_glu_matches_reference_and_pallas(act, bits, lc):
    r, m, cc, b = 128, 300, 128, 4
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
    with pytest.raises(NotImplementedError, match="Queue 2 item 6"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=64, epilogue="residual",
                               residual=torch.zeros(32, 2))
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
