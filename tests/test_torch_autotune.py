"""The port's schedule autotuner against the JAX package's: the Hopper
schedule space (``core.sdds``: legality, default first, deduplication),
the plan cache (``autotune.cache``: keys and digests equal to the
reference's for the same packs and strings, round-trip, invalidation),
the search (a warm cache performs zero benchmarks; ``pack_to_device``
attaches the plan), every legal schedule's ``impl="ref"`` output bit for
bit against the reference's on integer inputs, the ``ESPIM_IMPL`` pin,
and ``Provenance``.  On the CPU the tuner times the plain versions on the
host clock; the kernels under each schedule run on the card in
``chip_smoke.py``'s autotune phase."""
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.autotune import cache as RC  # noqa: E402
from repro.core import sdds as RS  # noqa: E402
from repro.core import sparse_format as RSF  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.quant import default_spec as r_spec  # noqa: E402
from repro.quant import quantize_pack as r_quantize  # noqa: E402

from repro_torch import autotune  # noqa: E402
from repro_torch.autotune import cache as PC  # noqa: E402
from repro_torch.autotune import tuner as PT  # noqa: E402
from repro_torch.core import sdds as PS  # noqa: E402
from repro_torch.core import sparse_format as PSF  # noqa: E402
from repro_torch.kernels import espim_spmv as PK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quant import default_spec as p_spec  # noqa: E402
from repro_torch.quant import quantize_pack as p_quantize  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "espim_spmv.cu"
CPU = {"device": "cpu"}


def _int_matrix(n_rows=96, n_cols=300, density=0.12, seed=0):
    """Integer-valued f32 weights: sums are exact in fp32, so every legal
    schedule (any accumulation order) must be bit-identical."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-3, 4, (n_rows, n_cols)).astype(np.float32)
    w *= rng.random((n_rows, n_cols)) < density
    return w, rng


def _packs(pkg_sf, w, kind, quantize, spec):
    """The same pack built by one package: plain ELL, chunked, or
    chunked with an int8 plane attached."""
    p = pkg_sf.pack_ell(w)
    if kind == "plain":
        return p
    cp = pkg_sf.chunk_pack(p, 128)
    if kind == "int8":
        quantize(cp, spec("int8"))
    return cp


def _unscatter(perm, n_rows, y):
    perm = np.asarray(perm)
    out = np.zeros((n_rows,) + tuple(y.shape[1:]), np.float32)
    keep = perm >= 0
    out[perm[keep]] = np.asarray(y)[keep]
    return out


# --------------------------------------------------------------------------
# 1) the Hopper schedule space
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_cols", [700, 300, 4096])
@pytest.mark.parametrize("epilogue", [None, "glu", "residual"])
def test_enumerated_schedules_are_legal_default_first(n_cols, epilogue):
    cands = PS.enumerate_schedules(n_cols=n_cols, epilogue=epilogue)
    assert cands and len(set(cands)) == len(cands)
    for s in cands:
        assert PS.schedule_legal(s, n_cols=n_cols, epilogue=epilogue)
        assert s.chunk_cols <= n_cols
    if PS.schedule_legal(PS.DEFAULT_SCHEDULE, n_cols=n_cols,
                         epilogue=epilogue):
        assert cands[0] == PS.DEFAULT_SCHEDULE
    # the single-chunk width is always a candidate
    assert any(s.chunk_cols == n_cols for s in cands)
    us = PS.STREAM_U if epilogue is None else PS.EPILOGUE_U
    widths = {s.chunk_cols for s in cands}
    assert len(cands) == len(widths) * len(PS.WARPS_PER_ROW) * len(us)


def test_schedule_legality_rules():
    legal = PS.schedule_legal
    d = PS.DEFAULT_SCHEDULE
    assert d == PS.KernelSchedule(512, 0, 2)
    assert legal(d, n_cols=4096)
    for s in (PS.KernelSchedule(512, 3, 2), PS.KernelSchedule(512, 8, 2),
              PS.KernelSchedule(512, 0, 3), PS.KernelSchedule(512, 0, 8),
              PS.KernelSchedule(0, 0, 2), PS.KernelSchedule(5000, 0, 2)):
        assert not legal(s, n_cols=4096), s
    # the GLU and residual kernels are built for U = 2 only
    for epi in ("glu", "residual"):
        assert legal(PS.KernelSchedule(512, 4, 2), n_cols=4096, epilogue=epi)
        assert not legal(PS.KernelSchedule(512, 4, 1), n_cols=4096,
                         epilogue=epi)
    assert legal(PS.KernelSchedule(512, 4, 4), n_cols=4096)
    # no TPU sublane rule: the row count plays no part
    assert "r_pad" not in PS.schedule_legal.__code__.co_varnames
    with pytest.raises(ValueError):
        legal(d, n_cols=4096, epilogue="softmax")


def test_effective_key_deduplicates():
    a = PS.KernelSchedule(256, 1, 1)
    b = PS.KernelSchedule(256, 4, 2)
    assert a.effective_key("ref") == b.effective_key("ref") == ("ref", 256)
    assert a.effective_key("cuda") == ("cuda", 256, 1, 1)
    assert a.effective_key("cuda") != b.effective_key("cuda")
    # the fingerprint method is the reference's: a digest of the fields
    assert a.fingerprint() == PS.KernelSchedule(256, 1, 1).fingerprint()
    assert a.fingerprint() != b.fingerprint()


@pytest.mark.parametrize("rows,want", [(32, 4), (1056, 4), (1057, 2),
                                       (2112, 2), (2113, 1), (11008, 1)])
def test_fill_rule_matches_the_launcher(rows, want):
    """``fill_warps_per_row`` is the CUDA launcher's ``stream_wpr`` (132
    SMs, ``kFillWarps`` warps an SM), read from the source."""
    src = CU.read_text()
    fill = int(re.search(r"constexpr int kFillWarps = (\d+);", src).group(1))
    assert fill == PS.FILL_WARPS
    assert PS.fill_warps_per_row(rows, 132) == want


def test_cuda_source_builds_the_schedule_space():
    """The launcher's U dispatch (``by_u``) takes exactly ``STREAM_U``
    when ALL_U and ``EPILOGUE_U`` otherwise; ``resolve_wpr`` takes 0, 1,
    2 and 4."""
    src = CU.read_text()
    body = src[src.index("int by_u(int u, F&& f)"):]
    body = body[:body.index("\n}\n")]
    always, _, all_u = body.partition("if constexpr (ALL_U)")
    assert {int(u) for u in re.findall(r"u == (\d)", always)} == \
        set(PS.EPILOGUE_U)
    assert {int(u) for u in re.findall(r"u == (\d)", body)} == \
        set(PS.STREAM_U)
    wpr = src[src.index("inline int resolve_wpr"):]
    wpr = wpr[:wpr.index("\n}\n")]
    assert {0} | {int(w) for w in re.findall(r"wpr == (\d)", wpr)} == \
        set(PS.WARPS_PER_ROW)


def test_kernel_wrappers_refuse_illegal_schedules():
    """An illegal schedule raises before any launch: it never becomes the
    default (the check precedes the device check, so it shows here)."""
    v = torch.zeros((8, 1, 4))
    c = torch.zeros((8, 1, 4), dtype=torch.int32)
    x = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="warps a row"):
        PK.espim_spmv_batched_cuda(v, c, x, chunk_cols=16, wpr=3)
    with pytest.raises(ValueError, match="u=8"):
        PK.espim_spmv_batched_quant_cuda(v.to(torch.int8), c, None, x,
                                         chunk_cols=16, u=8)
    with pytest.raises(ValueError, match="u=1"):
        PK.espim_spmv_batched_glu_cuda(v, c, x, chunk_cols=16, u=1)
    with pytest.raises(ValueError, match="u=4"):
        PK.espim_spmv_batched_res_cuda(v, c, x, x, chunk_cols=16, u=4)


def test_schedule_cost_terms():
    kw = dict(rows=8192, nnz=400_000, n_cols=4096, b=4)
    s = PS.KernelSchedule(512, 1, 2)
    # padding inflates the traffic term
    assert PT.schedule_cost(s, **kw, pad_frac=0.5) > \
        PT.schedule_cost(s, **kw, pad_frac=0.1)
    # narrower value planes are cheaper traffic
    assert PT.schedule_cost(s, **kw, quant="int4") < \
        PT.schedule_cost(s, **kw, quant="int8") < PT.schedule_cost(s, **kw)
    # a launch of few rows at one warp a row under-fills the SMs
    few = dict(kw, rows=512)
    assert PT.schedule_cost(PS.KernelSchedule(512, 1, 2), **few) > \
        PT.schedule_cost(PS.KernelSchedule(512, 4, 2), **few)
    # the fill rule (0) costs what its resolved value costs
    assert PT.schedule_cost(PS.KernelSchedule(512, 0, 2), **few) == \
        PT.schedule_cost(PS.KernelSchedule(512, 4, 2), **few)
    # every launch pays the fixed cost; the full card streams at its rate
    full = PT.schedule_cost(s, **kw)
    nbytes = 400_000 * 8 + 4096 * 4 * 4 + 8192 * 4 * 4
    assert full == pytest.approx(nbytes / PT.HBM_BYTES_PER_S * 1e6
                                 + PT.LAUNCH_US)


# --------------------------------------------------------------------------
# 2) the plan cache against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["plain", "chunked", "int8"])
def test_plan_free_digest_equals_the_reference(kind):
    w, _ = _int_matrix(seed=11)
    rp = _packs(RSF, w, kind, r_quantize, r_spec)
    pp = _packs(PSF, w, kind, p_quantize, p_spec)
    assert PC._plan_free_digest(pp) == RC._plan_free_digest(rp)


@pytest.mark.parametrize("ctx", [
    dict(b=4, quant="int8", impl="cuda", backend="cuda"),
    dict(b=1, quant=None, impl="ref", backend="cpu")], ids=["cuda", "cpu"])
def test_pack_cache_key_equals_the_reference(ctx):
    w, _ = _int_matrix(seed=12)
    assert PC.pack_cache_key(PSF.pack_ell(w), **ctx) == \
        RC.pack_cache_key(RSF.pack_ell(w), **ctx)


def test_plan_cache_roundtrip(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = autotune.PlanCache(path)
    cache.put("k1", {"schedule": {"chunk_cols": 256, "warps_per_row": 2,
                                  "u": 4},
                     "best_us": 12.5, "candidates": 3,
                     "created_by": "search"})
    warm = autotune.PlanCache(path)
    entry = warm.get("k1")
    assert entry is not None and entry["best_us"] == 12.5
    assert PS.KernelSchedule(**entry["schedule"]) == \
        PS.KernelSchedule(256, 2, 4)
    assert warm.hits == 1 and warm.misses == 0
    assert warm.get("nope") is None and warm.misses == 1
    # a table the JAX package wrote (TPU block knobs) reads as foreign
    RC.PlanCache(path).put("k1", {"schedule": {"chunk_cols": 256,
                                               "block_r": 64, "block_l": 128,
                                               "gather": "block"}})
    assert len(autotune.PlanCache(path)) == 0
    with open(path, "w") as f:
        f.write("{not json")
    assert len(autotune.PlanCache(path)) == 0


def test_cache_key_invalidates_on_pack_mutation():
    w, _ = _int_matrix(seed=5)
    pack = PSF.pack_ell(w)
    kw = dict(b=8, quant=None, impl="ref", backend="cpu")
    k1 = PC.pack_cache_key(pack, **kw)
    pack2 = PSF.pack_ell(w)
    assert PC.pack_cache_key(pack2, **kw) == k1
    pack2.values[0, 0] += 1.0
    from repro_torch.core.integrity import fingerprint_pack
    pack2.fingerprint = fingerprint_pack(pack2)
    assert PC.pack_cache_key(pack2, **kw) != k1
    assert PC.pack_cache_key(pack, **dict(kw, b=16)) != k1
    assert PC.pack_cache_key(pack, **dict(kw, quant="int4")) != k1
    # a plan tuned on the CPU never serves a CUDA launch
    assert PC.pack_cache_key(pack, **dict(kw, impl="cuda",
                                          backend="cuda")) != k1


# --------------------------------------------------------------------------
# 3) the search
# --------------------------------------------------------------------------
def test_warm_cache_skips_search():
    w, _ = _int_matrix()
    pack = PSF.pack_ell(w)
    cache = autotune.PlanCache()
    autotune.reset_search_stats()
    stats = autotune.search_stats
    plan = autotune.autotune_pack(pack, b=4, cache=cache, max_candidates=2,
                                  iters=1, warmup=0, **CPU)
    assert plan.source == "search" and plan.candidates == 2
    assert stats["benchmarks"] == 2 and stats["misses"] == 1
    plan2 = autotune.autotune_pack(pack, b=4, cache=cache,
                                   max_candidates=2, iters=1, warmup=0,
                                   **CPU)
    assert plan2.source == "cache" and plan2.candidates == 0
    assert plan2.schedule == plan.schedule
    assert stats["benchmarks"] == 2 and stats["hits"] == 1
    autotune.reset_search_stats()


def test_chunked_pack_searches_its_own_width_only():
    w, _ = _int_matrix(seed=2)
    cp = PSF.chunk_pack(PSF.pack_ell(w), 128)
    autotune.reset_search_stats()
    plan = autotune.autotune_pack(cp, b=2, max_candidates=5, iters=1,
                                  warmup=0, **CPU)
    # ref reads only chunk_cols: one distinct candidate, the pack's width
    assert plan.schedule == PS.KernelSchedule(128, 0, 2)
    assert plan.candidates == 1
    autotune.reset_search_stats()


def test_pack_to_device_autotune_attaches_plan(tmp_path):
    w, _ = _int_matrix()
    pack = PSF.pack_ell(w)
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    tune = {"b": 4, "cache": cache, "max_candidates": 2, "iters": 1,
            "warmup": 0}
    autotune.reset_search_stats()
    wt = ops.pack_to_device(pack, autotune=True, tune=tune, **CPU)
    assert isinstance(wt.schedule, autotune.TunedPlan)
    assert wt.schedule.source == "search"
    assert wt.chunk_cols == wt.schedule.schedule.chunk_cols
    n = autotune.search_stats["benchmarks"]
    wt2 = ops.pack_to_device(pack, autotune=True, tune=tune, **CPU)
    assert wt2.schedule.source == "cache"
    assert autotune.search_stats["benchmarks"] == n
    doc = json.load(open(cache.path))
    assert doc["schema"] == PC.CACHE_SCHEMA
    assert wt.schedule.key in doc["plans"]
    assert ops.pack_to_device(pack, **CPU).schedule is None
    # the tuned weights serve espim_matvec as the reference's plan does
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (w.shape[1], 4)).astype(np.float32))
    got = ops.espim_matvec(wt, x)
    np.testing.assert_allclose(got.numpy(), w @ x.numpy(), rtol=1e-5,
                               atol=1e-4)
    autotune.reset_search_stats()


def test_autotune_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pack = PSF.pack_ell(_int_matrix()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_pack(pack)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.pack_to_device(pack, autotune=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        autotune.autotune_pack(pack, impl="cuda", **CPU)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_legal_schedules_bit_identical_to_the_reference(quant):
    """Every legal schedule's ``impl="ref"`` output, unscattered, equals
    the reference's ``impl="ref"`` output under the schedule of the same
    chunk width, bit for bit, and equals the default's."""
    w, rng = _int_matrix()
    xn = rng.integers(-3, 4, (w.shape[1], 4)).astype(np.float32)
    rpack, ppack = RSF.pack_ell(w), PSF.pack_ell(w)
    base = None
    for s in PS.enumerate_schedules(n_cols=w.shape[1]):
        rcp = RSF.chunk_pack(rpack, s.chunk_cols)
        pcp = PSF.chunk_pack(ppack, s.chunk_cols)
        rsched = RS.KernelSchedule(chunk_cols=s.chunk_cols)
        if quant is None:
            want = RO.espim_spmv_batched(
                jnp.asarray(rcp.values), jnp.asarray(rcp.cols, jnp.int32),
                jnp.asarray(xn), chunk_cols=rcp.chunk_cols, impl="ref",
                schedule=rsched)
            got = ops.espim_spmv_batched(
                torch.from_numpy(pcp.values),
                torch.from_numpy(pcp.cols.astype(np.int32)),
                torch.from_numpy(xn), chunk_cols=pcp.chunk_cols, impl="ref",
                schedule=s)
        else:
            rq, pq = r_quantize(rcp, r_spec(quant)), p_quantize(pcp,
                                                                p_spec(quant))
            want = RO.espim_spmv_batched_quant(
                jnp.asarray(rq.device_codes()),
                jnp.asarray(rcp.cols, jnp.int32), None, jnp.asarray(xn),
                chunk_cols=rcp.chunk_cols, group_rows=rq.group_rows,
                impl="ref", schedule=rsched)
            got = ops.espim_spmv_batched_quant(
                torch.from_numpy(pq.device_codes()),
                torch.from_numpy(pcp.cols.astype(np.int32)), None,
                torch.from_numpy(xn), chunk_cols=pcp.chunk_cols,
                group_rows=pq.group_rows, impl="ref", schedule=s)
        got = _unscatter(pcp.perm, pcp.n_rows, got.numpy())
        np.testing.assert_array_equal(
            got, _unscatter(rcp.perm, rcp.n_rows, want), err_msg=repr(s))
        if quant is None:
            if base is None:
                base = got
            np.testing.assert_array_equal(got, base, err_msg=repr(s))


# --------------------------------------------------------------------------
# 4) the ESPIM_IMPL pin and Provenance
# --------------------------------------------------------------------------
def _chunked_operands():
    w, rng = _int_matrix(seed=4)
    cp = PSF.chunk_pack(PSF.pack_ell(w), 128)
    return (torch.from_numpy(cp.values),
            torch.from_numpy(cp.cols.astype(np.int32)),
            torch.from_numpy(rng.standard_normal((w.shape[1], 3)).astype(
                np.float32)), cp.chunk_cols)


def test_impl_pin_ref_wins_over_the_call(monkeypatch):
    v, c, x, cc = _chunked_operands()
    want = ops.espim_spmv_batched(v, c, x, chunk_cols=cc, impl="ref")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=cc, impl="cuda")

    def no_kernel(*a, **k):
        raise AssertionError("the ref pin launched a kernel")
    monkeypatch.setattr(PK, "espim_spmv_batched_cuda", no_kernel)
    monkeypatch.setenv(ops.ENV_IMPL, "ref")
    got = ops.espim_spmv_batched(v, c, x, chunk_cols=cc, impl="cuda",
                                 schedule=PS.KernelSchedule(cc, 4, 1))
    assert torch.equal(got, want)
    # the plain ELL layout is ref-only, and the pin makes it so
    p = PSF.pack_ell(_int_matrix(seed=4)[0])
    ops.espim_spmv_batched(torch.from_numpy(p.values),
                           torch.from_numpy(p.cols.astype(np.int32)), x,
                           impl="cuda")


def test_impl_pin_cuda_on_cpu_tensors_raises(monkeypatch):
    v, c, x, cc = _chunked_operands()
    monkeypatch.setenv(ops.ENV_IMPL, "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=cc, impl="ref")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.espim_spmv(v, c, x[:, 0], chunk_cols=cc)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        autotune.autotune_pack(PSF.pack_ell(_int_matrix()[0]), **CPU)


def test_impl_pin_unknown_value_raises(monkeypatch):
    v, c, x, cc = _chunked_operands()
    monkeypatch.setenv(ops.ENV_IMPL, "pallas")
    with pytest.raises(ValueError, match="ESPIM_IMPL"):
        ops.espim_spmv_batched(v, c, x, chunk_cols=cc)
    with pytest.raises(ValueError, match="ESPIM_IMPL"):
        ops.provenance(**CPU)


def test_provenance_matches_the_reference_layout(monkeypatch):
    monkeypatch.delenv(ops.ENV_IMPL, raising=False)
    monkeypatch.delenv(ops.ENV_PLAN_CACHE, raising=False)
    want = RO.provenance(impl="ref", quant="int8", attn="sparse",
                         packs={"gateup": "abc"})
    got = ops.provenance(quant="int8", attn="sparse",
                         packs={"gateup": "abc"}, **CPU)
    # the reference's keys in its order; ``pallas_interpret`` (whether
    # its Pallas kernels ran interpreted) maps to ``device`` (the card's
    # name, or "cpu")
    mapped = ["device" if k == "pallas_interpret" else k for k in want]
    assert list(got) == mapped
    assert got["backend"] == "cpu" and got["device"] == "cpu"
    assert got["impl"] == "ref"
    for k in ("quant", "attn", "packs", "schedule"):
        assert got[k] == want[k]
    assert got["env"] == {"ESPIM_IMPL": None, "ESPIM_PLAN_CACHE": None}
    assert ops.Provenance.collect(**CPU).to_dict()["quant"] == "none"
    monkeypatch.setenv(ops.ENV_IMPL, "ref")
    monkeypatch.setenv(ops.ENV_PLAN_CACHE, "/plans.json")
    pinned = ops.provenance(impl="cuda", **CPU)
    assert pinned["impl"] == "ref"
    assert pinned["env"] == {"ESPIM_IMPL": "ref",
                             "ESPIM_PLAN_CACHE": "/plans.json"}


def test_tuned_plan_provenance_shape():
    plan = autotune.TunedPlan(schedule=PS.KernelSchedule(256, 2, 4),
                              source="search", key="abc", best_us=9.0,
                              candidates=3)
    d = plan.to_provenance()
    assert d == {"source": "search", "tuned": True, "cache_key": "abc",
                 "chunk_cols": 256, "warps_per_row": 2, "u": 4,
                 "best_us": 9.0, "candidates": 3}
    prov = ops.provenance(schedule=d, **CPU)
    assert prov["schedule"]["source"] == "search"
    assert ops.provenance(**CPU)["schedule"] is None
