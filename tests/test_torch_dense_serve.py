"""The port's dense serving mode against the JAX package's: the dense
decode step and chunked prefill (bf16 and int8 KV caches), the dense
engine on the 8-request trace, and the fault ladder's two dense rungs —
quarantine to the dense fallback and degrade at load.

Tolerances: fp32 logits within rtol = atol = 1e-5 on the compute-dtype
cache (the smoke model is float32, so its "bf16" cache holds float32);
on the int8 cache a K/V code can round the other way where the two
packages' float32 RoPE outputs differ by an ulp at a .5 tie, so there
the logits are held within 1e-3 and the share of differing codes is
bounded.  Engines are held on greedy tokens (exact)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RFAULTS  # noqa: E402

from _torch_parity import smoke_model, to_np  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.core.integrity import PackIntegrityError  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve.serve_step import serve_step_sparse_fn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_LOGIT_TOL = 1e-3
INT8_CODE_DIFF_MAX = 1e-3          # share of int8 K/V codes that differ
KV_QUANT_REL_TOL = 5e-2            # tests/test_kv_quant.py's bound
PROMPT_LENS = [3, 20, 2, 28, 5, 12, 4, 9]
MAX_NEW = 4
KW = dict(batch_slots=4, max_len=48, block_size=8, prefill_chunk=8,
          policy="sjf")
KV_DTYPES = ["bfloat16", "int8"]


@pytest.fixture(scope="module")
def model():
    return smoke_model(n_layers=2)


def _kv(cfg, kv_dtype):
    return cfg.replace(kv_cache_dtype=kv_dtype)


def _trace(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def _drain(mod, eng, trace, on_step=None):
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.scheduler.has_pending or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng, steps)
    return [r.output for r in reqs], eng.stats


def _arena_clean(eng):
    assert eng.check_arena()["allocated"] == 0
    assert eng.cache.free_blocks == eng.cache.num_blocks


def _copy_first_bucket(sparse):
    """A structural copy of a sparse dict (either package's; the tensors
    shared, so the caller's stays clean once a plane is swapped) and the
    copy's first group's first bucket."""
    out = dict(sparse)
    out["groups"] = {n: dict(g, buckets=[dict(b) for b in g["buckets"]])
                     for n, g in sparse["groups"].items()}
    out.update(out["groups"])
    return out, out["groups"][next(iter(out["groups"]))]["buckets"][0]


def _poison(sparse, to_array):
    """A copy of a sparse dict with the first retained cell of the first
    group's first bucket poisoned: its value set to NaN, or on a
    quantized pack its row's scale."""
    out, b = _copy_first_bucket(sparse)
    cell = tuple(np.argwhere(np.asarray(b["valid"], bool))[0])
    key = "values" if "values" in b else "srow"
    arr = to_np(b[key]).copy()
    arr[cell if key == "values" else cell[:2]] = np.nan
    b[key] = to_array(arr, b[key])
    return out


def _force_nonfinite_once(victim):
    """An ``on_step`` hook: at the first tick after which a slot is
    decoding, wrap the engine's decode closure so that its next call
    flags that slot non-finite once; ``victim`` records the request."""
    def force(e, step):
        decoding = [i for i, s in enumerate(e.slots)
                    if s is not None and s.phase == "decode"]
        if victim or not decoding:
            return
        slot = decoding[0]
        victim["rid"] = e.slots[slot].req.rid
        inner = e._decode

        def once(p, c, b):
            nxt, ok, cache = inner(p, c, b)
            e._decode = inner
            ok = ok.clone()
            ok[slot] = False
            return nxt, ok, cache
        e._decode = once
    return force


def _inject_poisoned_decode(eng, sparse_bad):
    """Swap the port engine's decode closure for one over ``sparse_bad``
    (the engine's own ``sparse`` stays clean, so its dense fallback
    rebuilds uncontaminated weights)."""
    cfg, temp = eng.cfg, eng.temperature
    eng._decode = PE._finite_step(
        lambda p, c, b: serve_step_sparse_fn(
            cfg, p, sparse_bad, c, b, temperature=temp, impl=eng.impl,
            generator=eng._gen, device=eng.device))


# --------------------------------------------------------------------------
# the dense model
# --------------------------------------------------------------------------
def test_factory_dispatches_the_dense_family_only(model):
    """The dense family goes to ``transformer`` alone; the other five
    have modules of their own (``tests/test_torch_families.py``), the
    chunked prefill where the reference has it, and an unknown family
    raises."""
    from repro_torch.models import transformer
    _, pcfg, _, _ = model
    assert PF.get_family(pcfg) is transformer
    assert PF.supports_chunked_prefill(pcfg)
    for fam, chunked in (("moe", False), ("vlm", False), ("audio", False),
                         ("hybrid", True), ("ssm", True)):
        mod = PF.get_family(pcfg.replace(family=fam))
        assert mod is not transformer
        assert PF.supports_chunked_prefill(pcfg.replace(family=fam)) \
            == chunked
    with pytest.raises(ValueError, match="unknown model family"):
        PF.init_cache(pcfg.replace(family="bogus"), 1, 8, device="cpu")


def test_init_cache_int8_matches_reference(model):
    cfg, pcfg, _, _ = model
    rc = RF.init_cache(_kv(cfg, "int8"), 3, 10)
    pc = PF.init_cache(_kv(pcfg, "int8"), 3, 10, device="cpu")
    assert set(pc) == set(rc) == {"k", "v", "k_scale", "v_scale", "len"}
    for name, leaf in rc.items():
        assert tuple(pc[name].shape) == leaf.shape
        assert str(pc[name].dtype).removeprefix("torch.") == str(leaf.dtype)
        assert not pc[name].any()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_prefill_then_decode_matches_reference(model, kv_dtype):
    """Two prefill chunks (the second partial) and then four
    teacher-forced decode steps, B = 2, on the same cache."""
    cfg, pcfg, params, tparams = model
    cfg, pcfg = _kv(cfg, kv_dtype), _kv(pcfg, kv_dtype)
    b, c, steps = 2, 6, 4
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, 2 * c + steps)).astype(np.int32)
    rc = RF.init_cache(cfg, b, 2 * c + steps + 2)
    pc = PF.init_cache(pcfg, b, 2 * c + steps + 2, device="cpu")
    tol = TOL if kv_dtype != "int8" else dict(rtol=0, atol=INT8_LOGIT_TOL)
    calls, start = [], 0
    for n_valid in (c, 3):
        calls.append(("prefill", toks[:, start:start + c], n_valid))
        start += n_valid
    calls += [("decode", toks[:, start + s:start + s + 1], None)
              for s in range(steps)]
    for kind, tk, n_valid in calls:
        rb = {"tokens": jnp.asarray(tk)}
        pb = {"tokens": torch.from_numpy(tk)}
        if kind == "prefill":
            rb["n_valid"] = jnp.full((b,), n_valid, jnp.int32)
            pb["n_valid"] = torch.full((b,), n_valid, dtype=torch.int32)
            rl, rc = RF.prefill_chunk(cfg, params, rc, rb)
            pl, pc = PF.prefill_chunk(pcfg, tparams, pc, pb)
        else:
            rl, rc = RF.decode_step(cfg, params, rc, rb)
            pl, pc = PF.decode_step(pcfg, tparams, pc, pb)
        np.testing.assert_allclose(to_np(pl), to_np(rl), **tol)
        np.testing.assert_array_equal(pc["len"].numpy(),
                                      np.asarray(rc["len"]))
    assert int(pc["len"][0]) == c + 3 + steps
    if kv_dtype == "int8":
        for name in ("k", "v"):
            assert pc[name].dtype == torch.int8
            codes_p = pc[name].numpy().astype(np.int32)
            codes_r = np.asarray(rc[name]).astype(np.int32)
            assert np.abs(codes_p - codes_r).max() <= 1
            assert (codes_p != codes_r).mean() <= INT8_CODE_DIFF_MAX
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(to_np(pc[name]), to_np(rc[name]),
                                       rtol=1e-2, atol=0)
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(to_np(pc[name]), to_np(rc[name]),
                                       **TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-14b"])
def test_int8_cache_close_to_bf16(arch):
    """The reference's own bound (tests/test_kv_quant.py) on the port:
    ten decode steps, B = 2."""
    cfg = get_config(arch, reduced=True)
    params = PF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32))

    def roll(c):
        cache = PF.init_cache(c, 2, 14, device="cpu")
        outs = []
        for i in range(toks.shape[1]):
            lg, cache = PF.decode_step(c, params, cache,
                                       {"tokens": toks[:, i:i + 1]})
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)

    lg16 = roll(cfg)
    lg8 = roll(cfg.replace(kv_cache_dtype="int8"))
    err = float((lg8 - lg16).abs().max() / lg16.abs().max())
    assert 0 < err < KV_QUANT_REL_TOL, err


# --------------------------------------------------------------------------
# the dense engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_dense_engine_greedy_tokens_equal_reference(model, kv_dtype):
    cfg, pcfg, params, tparams = model
    cfg, pcfg = _kv(cfg, kv_dtype), _kv(pcfg, kv_dtype)
    trace = _trace(cfg.vocab_size)
    want, _ = _drain(RE, RE.ServeEngine(cfg, params, **KW), trace)
    eng = PE.ServeEngine(pcfg, tparams, device="cpu", **KW)
    assert eng.sparse is None and eng.verified_packs is None
    assert set(eng.cache.seq_names) == set(
        RE.ServeEngine(cfg, params, **KW).cache.seq_names)
    got, stats = _drain(PE, eng, trace)
    assert got == want
    assert stats.requests_completed == len(trace)
    assert stats.tokens_generated == len(trace) * MAX_NEW
    assert stats.quarantines == stats.requests_failed == 0
    assert stats.latency_summary()["states"] == {"completed": len(trace)}
    _arena_clean(eng)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_dense_paged_bit_identical_to_contiguous(model, kv_dtype):
    _, pcfg, _, tparams = model
    pcfg = _kv(pcfg, kv_dtype)
    trace = _trace(pcfg.vocab_size)
    outs = []
    for paged in (True, False):
        eng = PE.ServeEngine(pcfg, tparams, device="cpu", paged=paged, **KW)
        outs.append(_drain(PE, eng, trace)[0])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sparse_engine_equals_dense_engine_over_pruned(model, quant):
    """The paper's use case (tests/test_serve.py): the ESPIM-format engine
    is token-exact against a dense engine holding the pruned (or, for
    int8 packs, dequantized) weights."""
    _, pcfg, _, tparams = model
    trace = _trace(pcfg.vocab_size)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant=quant, device="cpu")
    sparse_out, _ = _drain(PE, PE.ServeEngine(pcfg, tparams, sparse=ps,
                                              device="cpu", **KW), trace)
    dense = PE.ServeEngine(pcfg, PSM.pruned_param_tree(tparams, ps),
                           device="cpu", **KW)
    assert _drain(PE, dense, trace)[0] == sparse_out


def test_sparse_engine_refuses_an_int8_kv_cache(model):
    _, pcfg, _, tparams = model
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, device="cpu")
    with pytest.raises(NotImplementedError, match="dense mode"):
        PE.ServeEngine(_kv(pcfg, "int8"), tparams, sparse=ps, device="cpu",
                       **KW)


# --------------------------------------------------------------------------
# the fault ladder's dense rungs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [None, "int8"])
def test_quarantine_degrades_to_dense_with_parity(model, quant):
    """A value plane poisoned after load verification, from tick 5 on:
    every poisoned slot is quarantined (no emit, no KV commit), then
    decoded by the dense fallback over the clean pruned weights — the
    outputs equal the no-fault run's and the reference's in the same
    scenario, and no block leaks (tests/test_robustness.py)."""
    cfg, pcfg, params, tparams = model
    trace = _trace(cfg.vocab_size)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant=quant, device="cpu")
    rs = RSM.sparsify_model(cfg, params, 0.9, quant=quant)
    ps_bad = _poison(ps, lambda a, old: torch.from_numpy(a).to(old.dtype))
    rs_bad = _poison(rs, lambda a, old: jnp.asarray(a))

    def port_poison(e, step):
        if step == 5:
            _inject_poisoned_decode(e, ps_bad)

    def ref_poison(e, step):
        if step == 5:
            RFAULTS.inject_poisoned_decode(e, rs_bad)

    base, _ = _drain(PE, PE.ServeEngine(pcfg, tparams, sparse=ps,
                                        device="cpu", **KW), trace)
    eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **KW)
    got, st = _drain(PE, eng, trace, port_poison)
    ref_eng = RE.ServeEngine(cfg, params, sparse=rs, impl="ref", **KW)
    want, ref_st = _drain(RE, ref_eng, trace, ref_poison)
    assert got == base == want
    assert st.quarantines >= 1 and st.degraded_tokens >= 1
    assert st.requests_degraded >= 1 and st.requests_failed == 0
    assert st.requests_completed == len(trace)
    assert set(st.latency_summary()["states"]) <= {"completed", "degraded"}
    assert (st.quarantines, st.degraded_tokens, st.requests_degraded) == (
        ref_st.quarantines, ref_st.degraded_tokens, ref_st.requests_degraded)
    assert eng._dense_params is not None
    _arena_clean(eng)


def _flip_first_value_bit(sparse):
    """A copy whose first value plane (fp values or int8 codes) has one
    bit flipped."""
    out, b = _copy_first_bucket(sparse)
    key = "values" if "values" in b else "q"
    arr = b[key].numpy().copy()
    arr.view(np.uint8).reshape(-1)[0] ^= np.uint8(1)
    b[key] = torch.from_numpy(arr)
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_on_verify_failure_degrade_serves_dense(model, quant):
    _, pcfg, _, tparams = model
    trace = _trace(pcfg.vocab_size)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant=quant, device="cpu")
    bad = _flip_first_value_bit(ps)
    with pytest.raises(PackIntegrityError, match="fingerprint"):
        PE.ServeEngine(pcfg, tparams, sparse=bad, device="cpu", **KW)
    with pytest.raises(ValueError, match="on_verify_failure"):
        PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu",
                       on_verify_failure="ignore", **KW)
    eng = PE.ServeEngine(pcfg, tparams, sparse=bad, device="cpu",
                         on_verify_failure="degrade", **KW)
    assert eng.sparse is None and eng.stats.degraded_to_dense
    got, st = _drain(PE, eng, trace)
    assert st.requests_completed == len(trace)
    assert all(len(o) == MAX_NEW for o in got)
    clean = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **KW)
    assert clean.verified_packs == PSM.verify_sparse(ps)
    assert got == _drain(PE, clean, trace)[0]
    eng.reset_stats()
    assert eng.stats.degraded_to_dense
    _arena_clean(eng)


def test_dense_engine_nonfinite_slot_fails_cleanly(model):
    """A dense engine has no lower rung: a slot flagged non-finite ends
    ``failed``, its blocks come back and the other slots' outputs are
    untouched (tests/test_robustness.py)."""
    _, pcfg, _, tparams = model
    trace = _trace(pcfg.vocab_size)[:4]
    base, _ = _drain(PE, PE.ServeEngine(pcfg, tparams, device="cpu", **KW),
                     trace)
    victim = {}
    eng = PE.ServeEngine(pcfg, tparams, device="cpu", **KW)
    got, st = _drain(PE, eng, trace, _force_nonfinite_once(victim))
    assert st.quarantines == 1 and st.requests_failed == 1
    assert st.requests_completed == len(trace) - 1
    assert st.degraded_tokens == 0
    assert st.latency_summary()["states"] == {"completed": len(trace) - 1,
                                              "failed": 1}
    for rid, (g, b) in enumerate(zip(got, base)):
        if rid == victim["rid"]:
            assert len(g) < MAX_NEW and g == b[:len(g)]
        else:
            assert g == b
    _arena_clean(eng)


def test_quarantine_leaves_healthy_samples_as_they_were(model):
    """Temperature sampling: in a tick with both a healthy and a degraded
    group, the two closures sample from the tick's one generator state
    (as the reference's share ``batch["rng"]``), so one slot's
    quarantine leaves every other slot's samples as in the no-fault
    run, and the victim still finishes, degraded."""
    _, pcfg, _, tparams = model
    trace = _trace(pcfg.vocab_size)[:4]
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, device="cpu")
    kw = dict(KW, temperature=1.0, seed=3)
    base, _ = _drain(PE, PE.ServeEngine(pcfg, tparams, sparse=ps,
                                        device="cpu", **kw), trace)
    victim = {}
    eng = PE.ServeEngine(pcfg, tparams, sparse=ps, device="cpu", **kw)
    got, st = _drain(PE, eng, trace, _force_nonfinite_once(victim))
    assert st.quarantines == 1 and st.degraded_tokens >= 1
    assert st.requests_degraded == 1 and st.requests_failed == 0
    for rid, (g, b) in enumerate(zip(got, base)):
        assert len(g) == MAX_NEW
        if rid != victim["rid"]:
            assert g == b
    _arena_clean(eng)
