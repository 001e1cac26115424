"""The port's engine hardening against the JAX package's: cancel, deadlines,
capped-backoff retry, the arena tripwire and OOM pressure, the shared
strike logic, the terminal-state contract, the reference's positional
constructor order, and ``sparse_stats``' per-projection breakdown.

Each engine scenario runs through the reference (``impl="ref"``) and the
port (``device="cpu"``, plain versions) on the same seeded smoke model
and requests.  Tolerance: greedy tokens, terminal states and counters
equal, and the arena accounting exact.  The framework-free
``runtime.fault_tolerance`` copy is held to the reference's behaviour on
the reference tests' inputs (``tests/test_fault_tolerance.py``)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402
from repro.runtime import fault_tolerance as RFT  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RF  # noqa: E402

from _torch_parity import drain, smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.runtime import fault_tolerance as PFT  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve import faults as PF  # noqa: E402
from repro_torch.serve.scheduler import (TERMINAL_STATES,  # noqa: E402
                                         RequestMetrics, Scheduler,
                                         latency_summary)

KW = dict(batch_slots=2, max_len=48, block_size=8)


@pytest.fixture(scope="module")
def model():
    return smoke_model(n_layers=2)


def _side(model, side):
    """(engine module, faults module, cfg, params, engine kwargs)."""
    cfg, pcfg, params, tparams = model
    if side == "ref":
        return RE, RF, cfg, params, {}
    return PE, PF, pcfg, tparams, {"device": "cpu"}


def _reqs(mod, n, max_new=6, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(
        1, 400, 4 + 3 * (i % 3)).tolist(), max_new_tokens=max_new, **kw)
        for i in range(n)]


def _states(eng):
    return eng.stats.latency_summary()["states"]


# --------------------------------------------------------------------------
# cancel / deadline / retry / arena invariant, reference and port
# --------------------------------------------------------------------------
def _cancel_run(model, side):
    E, _, cfg, params, dk = _side(model, side)
    eng = E.ServeEngine(cfg, params, validate_arena=True, **KW, **dk)
    reqs = _reqs(E, 3)
    done = []

    def on_step(e, step):
        if step == 3 and not done:
            done.append(step)
            assert e.cancel(reqs[0].rid)       # in-flight
            assert e.cancel(reqs[2].rid)       # still queued
            assert not e.cancel(99)            # unknown rid
    drain(eng, reqs, on_step)
    return eng, reqs


def test_cancel_releases_blocks_and_matches_reference(model):
    eng, reqs = _cancel_run(model, "port")
    ref_eng, ref_reqs = _cancel_run(model, "ref")
    # the survivor against a solo run of it
    solo = PE.ServeEngine(model[1], model[3], device="cpu", **KW)
    alone = _reqs(PE, 2)[1]
    drain(solo, [alone])
    assert eng.stats.requests_cancelled == 2
    assert eng.stats.requests_completed == 1
    assert reqs[0].done and reqs[2].done and reqs[2].output == []
    assert reqs[1].output == alone.output
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert _states(eng) == {"cancelled": 2, "completed": 1}
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert _states(eng) == _states(ref_eng)


def _deadline_run(model, side):
    E, _, cfg, params, dk = _side(model, side)
    eng = E.ServeEngine(cfg, params, batch_slots=1, max_len=48,
                        block_size=8, **dk)
    occupant, queued = _reqs(E, 2, max_new=4)
    queued.deadline_s = 0.0                    # expires while waiting
    eng.submit(occupant)
    eng.submit(queued)
    eng.step()
    eng.step()
    occupant.deadline_s = 0.0                  # now expire the in-flight one
    drain(eng, [])
    eng2 = E.ServeEngine(cfg, params, batch_slots=1, max_len=48,
                         block_size=8, **dk)
    r = _reqs(E, 1, max_new=4)[0]
    r.ttft_deadline_s = -1.0                   # never a first token
    drain(eng2, [r])
    return eng, eng2, (occupant, queued, r)


def test_deadlines_expire_queued_and_inflight(model):
    eng, eng2, (occupant, queued, r) = _deadline_run(model, "port")
    ref_eng, ref_eng2, ref_reqs = _deadline_run(model, "ref")
    assert occupant.done and queued.done
    assert eng.stats.requests_deadline_expired == 2
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert _states(eng) == {"deadline_expired": 2} == _states(ref_eng)
    assert r.done and r.output == []
    assert eng2.stats.requests_deadline_expired == 1
    assert _states(eng2) == _states(ref_eng2)
    assert [x.output for x in (occupant, queued, r)] == \
        [x.output for x in ref_reqs]


def _retry_run(model, side, n_failures, max_retries):
    E, F, cfg, params, dk = _side(model, side)
    eng = E.ServeEngine(cfg, params, max_retries=max_retries,
                        retry_backoff=0.001, **KW, **dk)
    reqs = _reqs(E, 2)
    armed = []

    def on_step(e, step):
        if step == 3 and not armed:
            armed.append(F.arm_transient_errors(e, at_call=1,
                                                n_failures=n_failures))
    drain(eng, reqs, on_step)
    return eng, reqs, armed[0]


def test_transient_retry_recovers_with_parity(model):
    base = PE.ServeEngine(model[1], model[3], device="cpu", **KW)
    base_reqs = _reqs(PE, 2)
    drain(base, base_reqs)
    eng, reqs, state = _retry_run(model, "port", 2, 2)
    ref_eng, ref_reqs, _ = _retry_run(model, "ref", 2, 2)
    assert state["fails"] == 2
    assert eng.stats.retries == 2 == ref_eng.stats.retries
    assert eng.stats.requests_failed == 0
    assert [r.output for r in reqs] == [r.output for r in base_reqs] \
        == [r.output for r in ref_reqs]
    eng.check_arena()


def test_transient_retry_exhaustion_fails_the_slots(model):
    eng, reqs, _ = _retry_run(model, "port", 99, 1)
    ref_eng, ref_reqs, _ = _retry_run(model, "ref", 99, 1)
    assert eng.stats.requests_failed == 2 == ref_eng.stats.requests_failed
    assert eng.stats.retries == ref_eng.stats.retries
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert _states(eng) == _states(ref_eng) == {"failed": 2}


def test_arena_invariant_tripwire(model):
    _, pcfg, _, tparams = model
    eng = PE.ServeEngine(pcfg, tparams, validate_arena=True, device="cpu",
                         **KW)
    drain(eng, _reqs(PE, 2))           # the per-step check stayed silent
    acct = eng.check_arena()
    assert acct["free"] == acct["num_blocks"] and acct["allocated"] == 0
    assert acct["quarantined"] == 0
    snap = eng.metrics.snapshot()
    assert any(k.startswith("serve_arena_checks_total") and v >= 1
               for k, v in snap.items())
    eng.cache._free.pop()              # simulate a leaked block
    with pytest.raises(RuntimeError, match="arena accounting"):
        eng.check_arena()


def _oom_run(model, side):
    E, _, cfg, params, dk = _side(model, side)
    eng = E.ServeEngine(cfg, params, validate_arena=True, **KW, **dk)
    reqs = _reqs(E, 3)
    taken = []

    def on_step(e, step):
        if step == 1:
            taken.append(e.cache.quarantine_blocks(e.cache.free_blocks // 2))
            acct = e.check_arena()
            assert acct["quarantined"] == taken[0] > 0
            assert e.cache.blocks_in_use >= taken[0]
        elif step == 10:
            assert e.cache.release_quarantined() == taken[0]
    steps = drain(eng, reqs, on_step)
    eng.cache.release_quarantined()
    return eng, reqs, steps


def test_arena_oom_pressure_only_delays_admission(model):
    eng, reqs, steps = _oom_run(model, "port")
    ref_eng, ref_reqs, ref_steps = _oom_run(model, "ref")
    assert eng.stats.requests_completed == 3
    assert eng.stats.requests_failed == 0
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert eng.cache.blocks_in_use == 0
    assert steps == ref_steps
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]


def test_contiguous_cache_has_no_arena_to_pressure(model):
    _, pcfg, _, tparams = model
    eng = PE.ServeEngine(pcfg, tparams, paged=False, device="cpu", **KW)
    assert eng.cache.quarantine_blocks(4) == 0
    assert eng.cache.release_quarantined() == 0
    assert eng.check_arena() == {"allocated": 0, "free": 0,
                                 "quarantined": 0, "reserved": 0,
                                 "num_blocks": 0}
    reqs = _reqs(PE, 2)
    drain(eng, reqs)                  # the gauges skip an arena-less cache
    assert eng.stats.requests_completed == 2


def _nonfinite_run(model, side):
    E, F, cfg, params, dk = _side(model, side)
    eng = E.ServeEngine(cfg, params, validate_arena=True, **KW, **dk)
    reqs = _reqs(E, 2)
    armed = []

    def on_step(e, step):
        if step == 4 and not armed:
            armed.append(step)
            F.force_nonfinite_flag(e, slots=[0], n_calls=1)
    drain(eng, reqs, on_step)
    return eng, reqs


def test_dense_engine_nonfinite_fails_cleanly(model):
    eng, reqs = _nonfinite_run(model, "port")
    ref_eng, ref_reqs = _nonfinite_run(model, "ref")
    assert eng.stats.quarantines == 1
    assert eng.stats.requests_failed == 1
    assert eng.stats.requests_completed == 1
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert _states(eng) == _states(ref_eng)


# --------------------------------------------------------------------------
# constructor: the reference's positional order, the new options' checks
# --------------------------------------------------------------------------
def test_positional_call_sets_temperature(model):
    _, pcfg, _, tparams = model
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, device="cpu")
    eng = PE.ServeEngine(pcfg, tparams, 4, 128, 0.0, device="cpu")
    assert eng.temperature == 0.0 and eng.sparse is None
    eng = PE.ServeEngine(pcfg, tparams, 2, 64, 0.5, ps, None, device="cpu")
    assert (eng.b, eng.max_len, eng.temperature) == (2, 64, 0.5)
    assert eng.sparse is ps and eng.impl is None
    with pytest.raises(TypeError):
        PE.ServeEngine(pcfg, tparams, 2, 64, 0.0, None, None, "cpu")


def test_constructor_rejects_bad_options(model):
    _, pcfg, _, tparams = model
    with pytest.raises(ValueError, match="prefill_mode"):
        PE.ServeEngine(pcfg, tparams, prefill_mode="eager", device="cpu",
                       **KW)
    with pytest.raises(ValueError, match="watermarks"):
        PE.ServeEngine(pcfg, tparams, watermark_high=0.5,
                       watermark_low=0.6, device="cpu", **KW)
    eng = PE.ServeEngine(pcfg, tparams, watermark_high=0.9, device="cpu",
                         **KW)
    assert eng._wm_low == pytest.approx(0.65)
    with pytest.raises(ValueError, match="unknown model family"):
        PE.ServeEngine(pcfg.replace(family="bogus"), tparams,
                       prefill_mode="replay", device="cpu", **KW)


# --------------------------------------------------------------------------
# shared strike logic + terminal-state plumbing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ft", [RFT, PFT], ids=["ref", "port"])
def test_strike_policy_and_watchdog(ft):
    pol = ft.StrikePolicy(patience=3)
    assert not pol.strike("w") and not pol.strike("w")
    pol.clear("w")                         # one clean observation forgives
    assert not pol.strike("w") and not pol.strike("w")
    assert pol.strike("w")                 # third consecutive trips

    wd = ft.LatencyWatchdog(threshold=3.0, patience=2, min_samples=4)
    for _ in range(6):
        assert not wd.observe(0.01)
    assert not wd.observe(1.0)
    assert wd.observe(1.0)
    assert not wd.observe(0.01)
    assert not wd.observe(1.0)


def _ft_trace(ft):
    """The reference tests' inputs through one fault_tolerance module."""
    out = {}
    hb = ft.HeartbeatMonitor(["w0", "w1", "w2"], timeout=10.0)
    for t in range(0, 30, 5):
        hb.beat("w0", t)
        hb.beat("w1", t)
        if t < 10:
            hb.beat("w2", t)
    out["failed"] = hb.failed(now=30.0)
    out["healthy"] = hb.healthy(now=30.0)
    hb.beat("w2", 31.0)
    out["failed_after_stale"] = hb.failed(now=32.0)
    sd = ft.StragglerDetector(threshold=2.0, patience=3)
    base = {f"w{i}": 1.0 for i in range(8)}
    out["straggler"] = [sd.observe_step({**base, "w7": 5.0})
                        for _ in range(3)]
    sd2 = ft.StragglerDetector(threshold=2.0, patience=2)
    out["recovered"] = [sd2.observe_step({**base, "w3": 9.0}),
                        sd2.observe_step(base),
                        sd2.observe_step({**base, "w3": 9.0})]
    out["plans"] = [
        (p.mesh_shape, p.dropped_devices) for p in (
            ft.plan_elastic_mesh(n_healthy=240, model_parallel=16),
            ft.plan_elastic_mesh(n_healthy=250, model_parallel=16),
            ft.plan_elastic_mesh(n_healthy=512, model_parallel=16,
                                 pod_size=256),
            ft.plan_elastic_mesh(n_healthy=400, model_parallel=16,
                                 pod_size=256))]
    with pytest.raises(ValueError):
        ft.plan_elastic_mesh(n_healthy=8, model_parallel=16)
    wd = ft.LatencyWatchdog(threshold=3.0, patience=2, min_samples=4)
    out["watchdog"] = [wd.observe(x) for x in
                       [0.01] * 6 + [1.0, 1.0, 0.01, 1.0, 1.0, 1.0]]
    return out


def test_fault_tolerance_copy_behaves_as_the_reference():
    port = _ft_trace(PFT)
    assert port == _ft_trace(RFT)
    assert port["failed"] == ["w2"] and "w2" in port["failed_after_stale"]
    assert port["straggler"] == [[], [], ["w7"]]
    assert port["plans"][:2] == [((15, 16), 0), ((15, 16), 10)]


def test_terminal_states_contract():
    assert set(TERMINAL_STATES) == {"completed", "degraded", "cancelled",
                                    "deadline_expired", "failed", "shed"}
    s = Scheduler()
    m = RequestMetrics(rid=0, prompt_len=1, t_submit=0.0)
    with pytest.raises(ValueError):
        s.finish(m, "vanished")
    s.finish(m, "failed")
    assert latency_summary(s.completed)["states"] == {"failed": 1}


def test_engine_stats_fields_match_reference():
    import dataclasses
    names = [f.name for f in dataclasses.fields(PE.EngineStats)]
    assert names == [f.name for f in dataclasses.fields(RE.EngineStats)]
    assert [f.name for f in dataclasses.fields(PE.Request)] == \
        [f.name for f in dataclasses.fields(RE.Request)]
    assert issubclass(PE.TransientStepError, RuntimeError)


# --------------------------------------------------------------------------
# sparse_stats: per-group, per-projection and per-layer, key for key
# --------------------------------------------------------------------------
def _same(a, b, path="stats"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_sparse_stats_equal_reference(model, quant):
    cfg, pcfg, params, tparams = model
    want = RSM.sparse_stats(RSM.sparsify_model(cfg, params, 0.9,
                                               quant=quant))
    got = PSM.sparse_stats(PSM.sparsify_model(pcfg, tparams, 0.9,
                                              quant=quant, device="cpu"))
    _same(want, got)
    for proj in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert got[proj]["nnz"] > 0 and "bits_per_nnz" in got[proj]
    assert len(got["gateup"]["pad_frac_per_layer"]) == cfg.n_layers
    assert got["total"]["bits_per_nnz"] > 0
