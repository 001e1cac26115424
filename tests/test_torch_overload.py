"""The port's overload hardening against the JAX package's: shed policies
through ``submit``, preempt-to-recompute, watermark backpressure, cancel
in the queue and mid-prefill, arena accounting under random
interleavings, and the overload drill.

Engines run through the reference (``impl="ref"``) and the port
(``device="cpu"``, plain versions) on the same seeded smoke model and
requests.  Tolerance: greedy tokens, terminal states and counters equal;
a preempted request's tokens equal the never-preempted run's bit for bit
inside the port, and the reference's; arena accounting exact."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: fall back to a seeded random sweep
    from _hypothesis_fallback import given, settings, st

from repro.core import sparse_model as RSM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve import faults as RF  # noqa: E402

from _torch_parity import drain, smoke_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve import faults as PF  # noqa: E402
from repro_torch.serve.paged_cache import PagedKVCache  # noqa: E402

EKW = dict(block_size=8, prefill_chunk=8, validate_arena=True)


@pytest.fixture(scope="module")
def model():
    cfg, pcfg, params, tparams = smoke_model(n_layers=2)
    rs = RSM.sparsify_model(cfg, params, 0.9, row_tile=32)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, row_tile=32, device="cpu")
    return {"ref": (RE, RF, cfg, params, rs, {}),
            "port": (PE, PF, pcfg, tparams, ps, {"device": "cpu"})}


def _req(mod, rid, plen, max_new=6, seed=0):
    rng = np.random.default_rng(seed + rid)
    return mod.Request(rid=rid, prompt=rng.integers(1, 400, plen).tolist(),
                       max_new_tokens=max_new)


def _states(eng):
    return eng.stats.latency_summary()["states"]


@pytest.mark.parametrize("policy,admitted,shed", [
    ("reject", [True, False, False, False], [1, 2, 3]),
    ("shed-oldest", [True, True, True, True], [0, 1, 2]),
    ("shed-largest", [True, False, True, False], [1, 0, 3]),
])
def test_engine_submit_sheds_by_policy(model, policy, admitted, shed):
    out = {}
    for side, (E, _, cfg, params, sparse, dk) in model.items():
        eng = E.ServeEngine(cfg, params, 1, 48, sparse=sparse,
                            max_queue_depth=1, shed_policy=policy, **EKW,
                            **dk)
        reqs = [_req(E, i, 5 + 2 * (i % 2), max_new=3) for i in range(4)]
        got = [eng.submit(r) for r in reqs]
        drain(eng, [])
        eng.check_arena()
        out[side] = (got, [r.output for r in reqs], _states(eng),
                     eng.stats.requests_shed,
                     [m.rid for m in eng.scheduler.completed
                      if m.state == "shed"])
    assert out["port"] == out["ref"]
    got, _, states, n_shed, shed_rids = out["port"]
    assert got == admitted and n_shed == 3
    assert shed_rids == shed
    assert states == {"completed": 1, "shed": 3}


def test_engine_shed_counter_and_trace(model):
    E, _, cfg, params, sparse, dk = model["port"]
    from repro_torch.telemetry.trace import Tracer
    tracer = Tracer(enabled=True)
    eng = E.ServeEngine(cfg, params, 1, 48, sparse=sparse, tracer=tracer,
                        max_queue_depth=1, shed_policy="reject", **EKW, **dk)
    for i in range(3):
        eng.submit(_req(E, i, 5, max_new=2))
    snap = eng.metrics.snapshot()
    assert any(k.startswith("serve_shed_total") and v == 2
               for k, v in snap.items())
    assert sum(i[0] == "fault.shed" for i in tracer.instants) == 2


def _preempt_run(side_rec, tight: bool):
    E, _, cfg, params, sparse, dk = side_rec

    def long_req():
        return _req(E, 0, 6, max_new=14, seed=7)

    def short_req():
        return _req(E, 1, 4, max_new=3, seed=7)

    kw = {}
    if tight:
        probe = E.ServeEngine(cfg, params, 2, 48, sparse=sparse, **EKW, **dk)
        kw["num_blocks"] = probe.cache.blocks_needed(
            long_req().worst_case_tokens(48))
    eng = E.ServeEngine(cfg, params, 2, 48, sparse=sparse, **kw, **EKW, **dk)
    lr, sr = long_req(), short_req()
    eng.submit(lr)
    for _ in range(3):                        # let the long one get going
        eng.step()
    eng.submit(sr)
    drain(eng, [])
    eng.check_arena()
    return eng, [lr.output, sr.output]


def test_preemption_parity_and_counters(model):
    base, base_out = _preempt_run(model["port"], tight=False)
    assert base.stats.preempts == 0
    eng, out = _preempt_run(model["port"], tight=True)
    ref_eng, ref_out = _preempt_run(model["ref"], tight=True)
    assert eng.stats.preempts >= 1
    assert eng.stats.preempts == ref_eng.stats.preempts
    assert _states(eng) == {"completed": 2}
    assert out == base_out == ref_out         # bit for bit, and reference
    snap = eng.metrics.snapshot()
    assert any(k.startswith("serve_preempts_total") and v >= 1
               for k, v in snap.items())
    assert eng.cache.free_blocks == eng.cache.num_blocks


def _watermark_run(side_rec):
    E, _, cfg, params, sparse, dk = side_rec
    eng = E.ServeEngine(cfg, params, 2, 48, sparse=sparse, num_blocks=6,
                        watermark_high=0.6, watermark_low=0.2, **EKW, **dk)
    reqs = [_req(E, i, 5, max_new=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    seen = []
    steps = 0
    while steps < 2000 and (eng.scheduler.has_pending
                            or any(s is not None for s in eng.slots)):
        eng.step()
        seen.append(eng._backpressure)
        steps += 1
    assert steps < 2000
    eng.check_arena()
    return eng, seen, [r.output for r in reqs]


def test_watermark_backpressure_pauses_admission(model):
    eng, seen, out = _watermark_run(model["port"])
    ref_eng, ref_seen, ref_out = _watermark_run(model["ref"])
    assert any(seen), "high watermark never engaged"
    assert not seen[-1], "backpressure never released"
    assert seen == ref_seen and out == ref_out
    assert _states(eng) == {"completed": 3}
    snap = eng.metrics.snapshot()
    occ = [v for k, v in snap.items() if k.startswith("serve_arena_occupancy")]
    assert occ == [0.0]                        # drained: nothing in use


def test_cancel_queued_request(model):
    E, _, cfg, params, sparse, dk = model["port"]
    eng = E.ServeEngine(cfg, params, 1, 48, sparse=sparse, **EKW, **dk)
    r0, r1 = _req(E, 0, 5, max_new=3), _req(E, 1, 5, max_new=3)
    eng.submit(r0), eng.submit(r1)
    eng.step()                                # r0 takes the slot
    assert eng.cancel(1)                      # r1 still queued
    assert r1.done and not eng.scheduler.has_pending
    assert eng.cancel(1) is False             # already gone
    drain(eng, [])
    eng.check_arena()
    states = {m.rid: m.state for m in eng.scheduler.completed}
    assert states == {1: "cancelled", 0: "completed"}
    assert eng.stats.requests_cancelled == 1


def test_cancel_mid_prefill_frees_blocks(model):
    E, _, cfg, params, sparse, dk = model["port"]
    eng = E.ServeEngine(cfg, params, 1, 64, sparse=sparse, block_size=8,
                        prefill_chunk=4, validate_arena=True, **dk)
    req = _req(E, 0, 14, max_new=3)           # several prefill chunks
    eng.submit(req)
    eng.step()
    slot = eng.slots[0]
    assert slot is not None and slot.phase == "prefill" and slot.pos < 14
    assert eng.cache.n_blocks[0] >= 1
    assert eng.cancel(0)
    assert eng.slots[0] is None and req.done
    eng.check_arena()
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert eng.scheduler.completed[-1].state == "cancelled"
    assert eng.stats.requests_cancelled == 1


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10**6))
def test_arena_accounting_under_random_interleavings(seed):
    """Random admit / grow / preempt / finish / restore sequences over the
    port's paged cache keep ``arena_check`` green after every op."""
    rng = np.random.default_rng(seed)
    cfg = get_config("granite-3-2b", reduced=True)
    pc = PagedKVCache(cfg, batch_slots=4, max_len=64,
                      block_size=int(rng.choice([4, 8])),
                      num_blocks=int(rng.integers(8, 24)), device="cpu")
    grown = np.zeros(4, int)
    live = [False] * 4
    for _ in range(60):
        slot = int(rng.integers(4))
        op = rng.choice(["admit", "grow", "preempt", "finish", "restore",
                         "pressure"])
        if op in ("admit", "restore"):
            if not live[slot]:
                worst = int(rng.integers(1, 64))
                if pc.reserve(slot, worst):
                    live[slot] = True
                    grown[slot] = int(rng.integers(1, worst + 1))
                    pc.ensure(slot, grown[slot])
        elif op == "grow" and live[slot]:
            grown[slot] = min(grown[slot] + int(rng.integers(1, 8)),
                              grown[slot] + pc._resv[slot] * pc.block_size)
            pc.ensure(slot, grown[slot])
        elif op in ("preempt", "finish") and live[slot]:
            pc.free_slot(slot)
            live[slot] = False
            grown[slot] = 0
        elif op == "pressure":
            if rng.integers(2):
                pc.quarantine_blocks(int(rng.integers(1, 4)))
            else:
                pc.release_quarantined()
        acct = pc.arena_check()
        assert acct["num_blocks"] == pc.num_blocks
        assert pc.blocks_in_use == (acct["allocated"]
                                    + acct["quarantined"])


def test_overload_drill_matches_reference(model):
    out = {}
    for side, (E, F, cfg, params, sparse, dk) in model.items():
        drill = F.run_overload_drill(cfg, params, sparse, seed=0, **dk)
        F.check_overload_drill(drill)
        out[side] = drill
    port, ref = out["port"], out["ref"]
    assert port["sheds"] >= 1 and port["preempts"] >= 1
    assert port["states"].get("failed", 0) == 0
    assert port["leaked_blocks"] == 0
    assert sum(port["states"].values()) == port["scale"]["n_requests"]
    for k in ("states", "tokens", "sheds", "preempts", "steps",
              "max_queue_depth_seen", "scale", "drained"):
        assert port[k] == ref[k], k
    # the port's check is the reference's, unchanged
    RF.check_overload_drill(port)
