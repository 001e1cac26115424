"""Per-request timelines of the port's engine (``telemetry/timeline.py``,
a copy of the reference's): traces of completed, preempted, restored,
quarantined, shed, cancelled and deadline-expired requests fold into
complete ``RequestTimeline``s whose segments sum to each request's wall
time, and the copy reconstructs the reference tests' hand-made traces
exactly as the reference does (``tests/test_timeline.py``).

The port runs on the CPU (``device="cpu"``, plain versions).  Tolerance:
the segment sum equals the wall time within 1e-6 s, and the timelines'
TTFT/TPOT agree with the engine's ``RequestMetrics`` within
``check_timelines``' own bound."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.telemetry import timeline as RT  # noqa: E402

from _torch_parity import smoke_model  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve import snapshot as snapmod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402
from repro_torch.telemetry import timeline as PT  # noqa: E402
from repro_torch.telemetry.flightrec import FlightRecorder  # noqa: E402
from repro_torch.telemetry.timeline import (check_timelines,  # noqa: E402
                                            format_timeline,
                                            timelines_from_chrome,
                                            timelines_from_jsonl,
                                            timelines_from_tracer)
from repro_torch.telemetry.trace import Tracer  # noqa: E402


@pytest.fixture(scope="module")
def model():
    _, pcfg, _, tparams = smoke_model(n_layers=2)
    sparse = PSM.sparsify_model(pcfg, tparams, 0.9, row_tile=32,
                                device="cpu")
    return pcfg, tparams, sparse


def _eng(model, tracer, **kw):
    cfg, params, sparse = model
    kw.setdefault("max_len", 48)
    return ServeEngine(cfg, params, batch_slots=2, sparse=sparse,
                       block_size=8, prefill_chunk=8, validate_arena=True,
                       tracer=tracer, flight=FlightRecorder(enabled=False),
                       device="cpu", **kw)


def _reqs(n=3, max_new=5, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, 400, 4 + 2 * i).tolist(),
                    max_new_tokens=max_new) for i in range(n)]


def _drain(eng, reqs, max_steps=2000):
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < max_steps, "engine did not drain"


def _partition(tls):
    for t in tls.values():
        assert t.complete
        assert abs(t.segment_sum_s() - t.wall_s) < 1e-6


@pytest.fixture(scope="module")
def traced_run(model):
    tracer = Tracer(enabled=True)
    eng = _eng(model, tracer)
    reqs = _reqs(3)
    for r in reqs:
        eng.submit(r)
    _drain(eng, reqs)
    return tracer, eng


def test_traced_run_timelines_complete_and_match_engine(traced_run):
    tracer, eng = traced_run
    tls = timelines_from_tracer(tracer)
    report = check_timelines(tls, {m.rid: m for m in eng.scheduler.completed})
    assert report["requests"] == report["complete"] == 3
    assert report["states"] == {"completed": 3}
    _partition(tls)
    for t in tls.values():
        kinds = t.by_kind()
        assert "prefill" in kinds and "decode" in kinds, kinds
        names = [n for _, n, _ in t.events]
        assert names[0] == "req.queued" and names[-1] == "req.terminal"
        assert names.index("req.admit") < names.index("req.first_token")
    # the reference's step spans, in the port's trace
    step_children = {s.name for s in tracer.spans()
                     if s.depth == 1 and s.cat in ("scheduler", "prefill",
                                                   "decode")}
    assert {"scheduler.expire", "scheduler.admit", "scheduler.plan",
            "metrics.update", "prefill.chunk",
            "decode.step"} <= step_children


def test_format_timeline_and_exports_roundtrip(traced_run, tmp_path):
    tracer, _ = traced_run
    live = timelines_from_tracer(tracer)
    txt = format_timeline(live[0])
    assert txt.startswith("rid 0: completed") and "ttft" in txt
    assert set(txt.splitlines()[1].strip("[] ")) <= set("qpd.")
    chrome_path, jsonl_path = tmp_path / "t.json", tmp_path / "t.jsonl"
    tracer.write_chrome_trace(str(chrome_path))
    tracer.write_jsonl(str(jsonl_path))
    with open(chrome_path) as f:
        from_chrome = timelines_from_chrome(json.load(f))
    from_jsonl = timelines_from_jsonl(str(jsonl_path))
    for tls, tol in ((from_chrome, 2e-6), (from_jsonl, 1e-12)):
        assert set(tls) == set(live)
        for rid, t in tls.items():
            assert t.complete and t.state == live[rid].state
            assert [s.kind for s in t.segments] == \
                [s.kind for s in live[rid].segments]
            assert abs(t.wall_s - live[rid].wall_s) <= tol


def test_preempted_and_resumed_request_timeline(model):
    def long_req():
        return Request(rid=0, prompt=list(range(1, 7)), max_new_tokens=14)

    probe = _eng(model, Tracer(enabled=False))
    nb = probe.cache.blocks_needed(long_req().worst_case_tokens(48))
    tracer = Tracer(enabled=True)
    eng = _eng(model, tracer, num_blocks=nb)
    long = long_req()
    eng.submit(long)
    for _ in range(3):
        eng.step()
    short = Request(rid=1, prompt=[5, 6, 7, 8], max_new_tokens=3)
    eng.submit(short)
    _drain(eng, [long, short])
    assert eng.stats.preempts >= 1
    tls = timelines_from_tracer(tracer)
    check_timelines(tls, {m.rid: m for m in eng.scheduler.completed})
    _partition(tls)
    t = tls[0]
    assert t.state == "completed" and t.preempts == eng.stats.preempts
    names = [n for _, n, _ in t.events]
    assert "fault.preempt" in names and "req.requeue" in names
    admits = [a for _, n, a in t.events if n == "req.admit"]
    assert len(admits) >= 2 and admits[-1]["resumed"]
    kinds = [s.kind for s in t.segments]
    assert "queued" in kinds[kinds.index("prefill"):], kinds


def test_snapshot_restored_request_timeline(model):
    tracer = Tracer(enabled=True)
    eng = _eng(model, tracer)
    for r in _reqs(2, max_new=4, seed=1):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    del eng
    eng2 = _eng(model, tracer)
    restored = snapmod.restore_engine(eng2, snap)
    _drain(eng2, restored)
    tls = timelines_from_tracer(tracer)
    check_timelines(tls)
    _partition(tls)
    assert set(tls) == {0, 1}
    for t in tls.values():
        assert t.state == "completed"
        queued = [a for _, n, a in t.events if n == "req.queued"]
        assert any(a.get("restored") for a in queued), t.events
        assert any(n == "fault.restore" for _, n, _ in t.events)


def test_quarantined_then_degraded_request_timeline(model):
    _, _, sparse = model
    tracer = Tracer(enabled=True)
    eng = _eng(model, tracer, max_len=64)
    reqs = _reqs(3, max_new=6, seed=0)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        if steps == 5:
            faults.inject_poisoned_decode(
                eng, faults.poison_values(sparse, np.random.default_rng(2)))
        eng.step()
        steps += 1
        assert steps < 2000
    assert eng.stats.quarantines >= 1 and eng.stats.requests_degraded >= 1
    tls = timelines_from_tracer(tracer)
    report = check_timelines(tls, {m.rid: m for m in eng.scheduler.completed})
    assert report["complete"] == report["requests"] == 3
    _partition(tls)
    degraded = [t for t in tls.values() if t.state == "degraded"]
    assert degraded and any(t.quarantines >= 1 for t in degraded)
    for t in degraded:
        assert t.t_first_ns is not None
        assert any(n == "fault.quarantine" for _, n, _ in t.events)


def test_engine_shed_cancel_and_deadline_timelines(model):
    """The terminal states that never emit a token, through the port's
    engine: shed at submit, cancelled in the queue and in a slot, and a
    deadline expired in the queue."""
    tracer = Tracer(enabled=True)
    eng = _eng(model, tracer, max_queue_depth=3, shed_policy="reject")
    reqs = _reqs(4, max_new=3)
    reqs[2].deadline_s = 0.0
    admitted = [eng.submit(r) for r in reqs]
    assert admitted == [True, True, True, False]
    assert eng.cancel(1)                       # in the queue
    eng.step()                                 # rid 2 expires, 0 admitted
    assert eng.slots[0].req.rid == 0
    assert eng.cancel(0)                       # in a slot
    _drain(eng, reqs)
    tls = timelines_from_tracer(tracer)
    report = check_timelines(tls)
    assert report["requests"] == report["complete"] == 4
    assert report["states"] == {"shed": 1, "cancelled": 2,
                                "deadline_expired": 1}
    _partition(tls)
    for rid, t in tls.items():
        assert t.segments[0].kind == "queued"
        # rid 0's one-chunk prefill gave its first token before the cancel
        assert (t.t_first_ns is not None) == (rid == 0)


# --------------------------------------------------------------------------
# the copy against the reference on the reference tests' inputs
# --------------------------------------------------------------------------
class _Req:
    def __init__(self, rid, plen, **kw):
        self.rid = rid
        self.prompt = list(range(plen))
        self.done = False
        for k, v in kw.items():
            setattr(self, k, v)


def _summary(tls):
    return {rid: (t.complete, t.state, t.n_out, t.preempts, t.quarantines,
                  [(s.kind, s.t0_ns, s.t1_ns) for s in t.segments])
            for rid, t in tls.items()}


def test_all_terminal_states_reconstruct():
    tracer = Tracer(enabled=True)
    s = Scheduler(max_queue_depth=1, shed_policy="reject", tracer=tracer,
                  flight=FlightRecorder(enabled=False))
    s.add(_Req(0, 4))
    assert s.add(_Req(1, 4)) is None
    assert s.cancel_pending(0)
    m = s.add(_Req(2, 4, deadline_s=0.0))
    assert s.expire_pending(m.t_submit + 1.0) == [2]
    s.finish(s.add(_Req(3, 4)), "failed")
    tls = timelines_from_tracer(tracer)
    report = check_timelines(tls)
    assert report["requests"] == report["complete"] == 4
    assert report["states"] == {"shed": 1, "cancelled": 1,
                                "deadline_expired": 1, "failed": 1}
    assert _summary(tls) == _summary(RT.timelines_from_tracer(tracer))


_PARTIAL = [
    {"type": "instant", "name": "req.queued", "cat": "request",
     "t_ns": 1000, "args": {"rid": 7, "prompt_len": 4}},
    {"type": "instant", "name": "req.admit", "cat": "request",
     "t_ns": 2000, "args": {"rid": 7, "slot": 0, "resumed": False}},
    {"type": "span", "name": "prefill.chunk", "cat": "prefill",
     "t0_ns": 2100, "t1_ns": 3000, "args": {"rid": 7, "slot": 0}},
]
_DUPLICATE = [
    {"type": "instant", "name": "req.queued", "cat": "request",
     "t_ns": 1000, "args": {"rid": 0, "prompt_len": 4}},
    {"type": "instant", "name": "req.terminal", "cat": "request",
     "t_ns": 5000, "args": {"rid": 0, "state": "failed", "n_out": 0}},
    {"type": "instant", "name": "req.queued", "cat": "request",
     "t_ns": 6000, "args": {"rid": 0, "prompt_len": 4, "restored": True}},
    {"type": "instant", "name": "req.first_token", "cat": "request",
     "t_ns": 7000, "args": {"rid": 0, "slot": 0}},
    {"type": "instant", "name": "req.terminal", "cat": "request",
     "t_ns": 9000, "args": {"rid": 0, "state": "completed", "n_out": 3}},
]


def test_partial_trace_stays_incomplete():
    t = PT.build_timelines(_PARTIAL)[7]
    assert not t.complete and t.state is None
    assert [s.kind for s in t.segments] == ["queued", "wait", "prefill"]
    assert _summary({7: t}) == _summary(RT.build_timelines(_PARTIAL))
    with pytest.raises(AssertionError):
        check_timelines({7: t})


def test_duplicate_marks_first_queued_last_terminal_win():
    t = PT.build_timelines(_DUPLICATE)[0]
    assert t.t_queued_ns == 1000 and t.t_terminal_ns == 9000
    assert t.state == "completed" and t.n_out == 3
    assert t.wall_s == pytest.approx(8e-6)
    assert t.segment_sum_s() == pytest.approx(t.wall_s)
    assert _summary({0: t}) == _summary(RT.build_timelines(_DUPLICATE))
