"""The port's standalone projection path against the JAX package's:
``pack_to_device`` planes bit for bit, ``espim_matvec``, ``ESPIMLinear``
and ``ESPIMGroupLinear`` (fp, int8, int4; 1-D and batched x; bias; the
dense datapath) within 1e-5 * max|reference| at ``impl="ref"``, the PIM
cycle and energy models exactly, and the torch quickstart on the CPU."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import energy as RE  # noqa: E402
from repro.core import espim_linear as RLIN  # noqa: E402
from repro.core import pim_sim as RSIM  # noqa: E402
from repro.core import sparse_format as RSF  # noqa: E402
from repro.core.integrity import PackIntegrityError as RPIE  # noqa: E402
from repro.core.pruning import magnitude_prune  # noqa: E402
from repro.core.sdds import ESPIMConfig as RCfg  # noqa: E402
from repro.core.sdds import schedule_matrix as r_schedule  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402

from repro_torch.core import energy as PE  # noqa: E402
from repro_torch.core import pim_sim as PSIM  # noqa: E402
from repro_torch.core import sparse_format as PSF  # noqa: E402
from repro_torch.core.espim_linear import (ESPIMGroupLinear,  # noqa: E402
                                           ESPIMLinear)
from repro_torch.core.integrity import PackIntegrityError  # noqa: E402
from repro_torch.core.sdds import ESPIMConfig as PCfg  # noqa: E402
from repro_torch.core.sdds import schedule_matrix as p_schedule  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5          # max|port - reference| <= REL * max|reference|
QUANTS = [None, "int8", "int4"]


def _matrix(r=200, c=500, seed=7, sparsity=0.9):
    rng = np.random.default_rng(seed)
    return magnitude_prune(rng.standard_normal((r, c)).astype(np.float32),
                           sparsity)


def _near(port, ref):
    port = np.asarray(port.detach().numpy(), np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= REL * np.abs(ref).max()


def _bits(a):
    """Plane bytes as a uint8 view (bf16 and every other dtype)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("kind", ["plain", "chunked"])
@pytest.mark.parametrize("quant,dtype", [(None, "float32"),
                                         (None, "bfloat16"),
                                         ("int8", "float32"),
                                         ("int4", "float32")])
def test_pack_to_device_planes_equal_reference(kind, quant, dtype):
    """The device planes are the reference's bytes: a plain pack goes
    through the same chunk pass, values / codes / cols / perm / scales
    and the metadata agree exactly."""
    w = _matrix()
    build = ((lambda m, sf: sf.pack_ell(m)) if kind == "plain"
             else (lambda m, sf: sf.pack_ell_chunked(m, chunk_cols=128)))
    got = ops.pack_to_device(build(w, PSF), dtype=getattr(torch, dtype),
                             chunk_cols=128, quant=quant, device="cpu")
    want = RO.pack_to_device(build(w, RSF), dtype=getattr(jnp, dtype),
                             chunk_cols=128, quant=quant)
    assert isinstance(got, ops.QuantEspimWeights if quant
                      else ops.EspimWeights)
    for f in dataclasses.fields(got):
        g, r = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            assert tuple(g.shape) == tuple(r.shape), f.name
            np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=f.name)
        else:
            assert g == r, f.name


@pytest.mark.parametrize("corrupt", ["value", "col"])
def test_corrupted_pack_raises_as_reference_does(corrupt):
    """A value flipped after build fails the fingerprint; an out-of-range
    column fails the bounds check — in both packages, before upload."""
    w = _matrix()
    packs = [sf.pack_ell_chunked(w, chunk_cols=128) for sf in (PSF, RSF)]
    for p in packs:
        if corrupt == "value":
            p.values[0, 0, 0] += 1.0
        else:
            p.cols[0, 0, 0] = 10 ** 6
    match = "fingerprint mismatch" if corrupt == "value" else "col"
    with pytest.raises(PackIntegrityError, match=match):
        ops.pack_to_device(packs[0], device="cpu")
    with pytest.raises(RPIE, match=match):
        RO.pack_to_device(packs[1])
    # verify=False uploads as the reference does
    assert ops.pack_to_device(packs[0], verify=False, device="cpu").cols[
        0, 0, 0] == packs[0].cols[0, 0, 0]


def test_pack_to_device_autotune_returns_a_plan():
    """``autotune=True`` tunes on the given device and attaches the plan;
    the chunked pack keeps its own width, and the weights still match the
    reference's upload."""
    from repro_torch.autotune import PlanCache, TunedPlan
    pack = PSF.pack_ell_chunked(_matrix(), chunk_cols=128)
    w = ops.pack_to_device(pack, autotune=True, device="cpu",
                           tune={"b": 2, "cache": PlanCache(), "iters": 1})
    assert isinstance(w.schedule, TunedPlan)
    assert w.schedule.source == "search"
    assert w.schedule.schedule.chunk_cols == w.chunk_cols == 128
    want = RO.pack_to_device(RSF.pack_ell_chunked(_matrix(), chunk_cols=128))
    assert np.array_equal(_bits(w.values), _bits(want.values))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(500,), (500, 3)])
def test_espim_matvec_matches_reference(quant, shape):
    w = _matrix()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = ops.espim_matvec(
        ops.pack_to_device(PSF.pack_ell_chunked(w, chunk_cols=128),
                           quant=quant, device="cpu"), torch.from_numpy(x))
    want = RO.espim_matvec(
        RO.pack_to_device(RSF.pack_ell_chunked(w, chunk_cols=128),
                          quant=quant), jnp.asarray(x), impl="ref")
    _near(got, want)
    if quant is None:
        np.testing.assert_allclose(got.numpy(), w @ x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(500,), (2, 3, 500)])
@pytest.mark.parametrize("bias", [False, True])
def test_espim_linear_matches_reference(quant, shape, bias):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((200, 500)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32) if bias else None
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(prune_sparsity=0.9, chunk_cols=128, quant=quant)
    lin = ESPIMLinear.from_dense(w, b, device="cpu", **kw)
    ref = RLIN.ESPIMLinear.from_dense(w, b, **kw)
    assert lin.sparse and ref.sparse and lin.density == ref.density
    got = lin(torch.from_numpy(x), impl="ref")
    assert got.dtype == torch.float32
    _near(got, ref(jnp.asarray(x), impl="ref"))
    # the default impl on CPU tensors is the same plain version
    assert torch.equal(lin(torch.from_numpy(x)), got)


@pytest.mark.parametrize("shape", [(500,), (4, 500)])
def test_espim_linear_dense_datapath_matches_reference(shape):
    """At density >= sparse_threshold the layer keeps the dense weight and
    runs a float32 matmul, as the reference does."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((200, 500)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    lin = ESPIMLinear.from_dense(w, b, prune_sparsity=0.3, device="cpu")
    ref = RLIN.ESPIMLinear.from_dense(w, b, prune_sparsity=0.3)
    assert not lin.sparse and not ref.sparse
    assert lin.weights.shape == (200, 500)
    _near(lin(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(256,), (3, 256)])
def test_espim_group_linear_matches_reference(quant, shape):
    """GQA-shaped q/k/v (differing row counts) in one fused pack."""
    rng = np.random.default_rng(4)
    named = {"wq": rng.standard_normal((256, 256)).astype(np.float32),
             "wk": rng.standard_normal((64, 256)).astype(np.float32),
             "wv": rng.standard_normal((64, 256)).astype(np.float32)}
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(prune_sparsity=0.9, chunk_cols=128, quant=quant)
    grp = ESPIMGroupLinear.from_dense(named, device="cpu", **kw)
    ref = RLIN.ESPIMGroupLinear.from_dense(named, **kw)
    got = grp(torch.from_numpy(x), impl="ref")
    want = ref(jnp.asarray(x), impl="ref")
    assert list(got) == list(want) == ["wq", "wk", "wv"]
    for name in got:
        assert got[name].shape == shape[:-1] + (named[name].shape[0],)
        _near(got[name], want[name])


@pytest.mark.parametrize("layer", ["linear", "group"])
def test_bf16_layers_with_2d_x_match_pallas(layer):
    """``ESPIMLinear`` / ``ESPIMGroupLinear.from_dense(dtype=bfloat16)``
    with a 2-D x (the batched kernels' bf16 value planes on the card)
    against the reference's layers at ``impl="pallas"`` (interpret mode),
    within the JAX package's bf16 tolerance of 3e-2."""
    rng = np.random.default_rng(8)
    kw = dict(prune_sparsity=0.9, chunk_cols=128)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    if layer == "linear":
        w = rng.standard_normal((200, 256)).astype(np.float32)
        mod = ESPIMLinear.from_dense(w, dtype=torch.bfloat16, device="cpu",
                                     **kw)
        ref = RLIN.ESPIMLinear.from_dense(w, dtype=jnp.bfloat16, **kw)
        got, want = {"y": mod(torch.from_numpy(x))}, {
            "y": ref(jnp.asarray(x), impl="pallas")}
    else:
        named = {"wq": rng.standard_normal((256, 256)).astype(np.float32),
                 "wk": rng.standard_normal((64, 256)).astype(np.float32),
                 "wv": rng.standard_normal((64, 256)).astype(np.float32)}
        mod = ESPIMGroupLinear.from_dense(named, dtype=torch.bfloat16,
                                          device="cpu", **kw)
        ref = RLIN.ESPIMGroupLinear.from_dense(named, dtype=jnp.bfloat16,
                                               **kw)
        got, want = mod(torch.from_numpy(x)), ref(jnp.asarray(x),
                                                  impl="pallas")
    assert mod.weights.values.dtype == torch.bfloat16
    for name in got:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=3e-2, atol=3e-2)


def test_layers_keep_their_planes_as_buffers():
    """The planes are buffers: they travel with the module's state and
    ``weights`` is rebuilt from them."""
    w = _matrix(64, 128, sparsity=0.9)
    lin = ESPIMLinear.from_dense(w, np.ones(64, np.float32), quant="int8",
                                 device="cpu")
    names = {n for n, _ in lin.named_buffers()}
    assert names == {"values", "cols", "perm", "scales", "bias"}
    lin = lin.to(torch.float64)         # buffers move; int planes stay
    assert lin.cols.dtype == torch.int32 and lin.values.dtype == torch.int8
    assert isinstance(lin.weights, ops.QuantEspimWeights)
    assert lin.weights.values is lin.values


def test_pim_simulator_and_energy_equal_reference():
    """The copied PIM cycle and energy models give the reference's
    numbers exactly on a small matrix."""
    w = _matrix(96, 256, seed=5, sparsity=0.85)
    archs = ("espim", "espim_ideal", "newton", "spacea", "ideal_nonpim",
             "gpu")
    got = PSIM.simulate_matrix(w, archs=archs)
    want = RSIM.simulate_matrix(w, archs=archs)
    for a in archs:
        assert got[a].cycles == want[a].cycles, a
        assert got[a].breakdown == want[a].breakdown, a
    ps, _ = p_schedule(w, PCfg())
    rs, _ = r_schedule(w, RCfg())
    base = PE.gpu_dram_energy(*w.shape).total
    assert base == RE.gpu_dram_energy(*w.shape).total
    nnz = int((w != 0).sum())
    for got_e, want_e in ((PE.espim_energy(ps), RE.espim_energy(rs)),
                          (PE.newton_energy(96, 256, nnz),
                           RE.newton_energy(96, 256, nnz))):
        assert dataclasses.asdict(got_e) == dataclasses.asdict(want_e)
    assert PE.area_table() == RE.area_table()


def test_quickstart_torch_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    err = [ln for ln in lines if ln.startswith("espim_matvec on cpu")]
    assert len(err) == 1 and float(err[0].split()[-1]) < 1e-4
    assert any(ln.startswith("simulated PIM cycles") for ln in lines)
    assert any(ln.startswith("simulated energy") for ln in lines)
