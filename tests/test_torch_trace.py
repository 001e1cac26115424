"""The port's tracer (``repro_torch.telemetry.trace``) and the spans and
counter the serving path emits: the clock is the device trace's, a
disabled tracer builds no span, the forward's layer-group spans account
for ``decode.launch`` and ``prefill.launch`` on both datapaths, the paged
cache counts its view rebuilds, and a ``prefill.chunk`` span carries its
token count.  CPU only (``device="cpu"``, the plain versions)."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import sparse_model as PSM
from repro_torch.models import factory
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.telemetry import trace as tt
from repro_torch.telemetry.flightrec import FlightRecorder

LAYER_GROUPS = {"embed", "layer.slice", "attn", "mlp", "cache.stack",
                "lm_head"}
DECODE_CHILDREN = LAYER_GROUPS | {"sample", "finite_check"}
ATTN_CHILDREN = {"attn.qkv", "attn.core", "attn.out"}
CHUNK = 8


@pytest.fixture(scope="module")
def model():
    cfg = get_config("llama7b-espim", reduced=True).replace(n_layers=2)
    params = factory.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    sparse = PSM.sparsify_model(cfg, params, 0.9, row_tile=32,
                                quant="int8", device="cpu")
    return cfg, params, sparse


def _eng(model, datapath: str, **kw):
    cfg, params, sparse = model
    return ServeEngine(cfg, params, batch_slots=2, max_len=48,
                       sparse=sparse if datapath == "espim" else None,
                       block_size=8, prefill_chunk=CHUNK,
                       flight=FlightRecorder(enabled=False), device="cpu",
                       **kw)


def _reqs(lens=(5, 11, 19), max_new=6):
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(1, 400, n).tolist(),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]


def _serve(eng, reqs, on_step=None):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(steps)
        assert steps < 500, "engine did not drain"


@pytest.fixture
def live():
    """A live process tracer, the previous one restored afterwards."""
    tracer = tt.Tracer()
    prev = tt.set_tracer(tracer)
    yield tracer
    tt.set_tracer(prev)


# ------------------------------------------------------------------ clock
def test_span_brackets_a_profiler_event(live, tmp_path):
    """The span's exported start and end bracket a ``record_function``
    event's own: one clock for the program's spans and the profiler's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with live.span("outer", cat="t"):
            with record_function("probe.event"):
                torch.ones(64).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe.event"]
    assert ev
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    (span,) = live.spans("outer")
    assert span.t0_ns <= start <= end <= span.t1_ns
    path = tmp_path / "t.jsonl"
    live.write_jsonl(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["clock"] == tt.CLOCK_NAME == "unix_epoch_ns"
    (rec,) = [x for x in lines if x.get("name") == "outer"]
    assert rec["t0_ns"] <= start and end <= rec["t1_ns"]
    doc = live.chrome_trace()
    (x,) = [e for e in doc["traceEvents"] if e["name"] == "outer"]
    origin = lines[0]["origin_ns"]
    assert origin + x["ts"] * 1e3 <= start + 1e3
    assert end <= origin + (x["ts"] + x["dur"]) * 1e3 + 1e3


def test_spans_and_instants_are_stamped_on_the_wall_clock(live):
    before = time.time_ns()
    with live.span("s"):
        live.instant("i")
    after = time.time_ns()
    (span,) = live.spans("s")
    assert before <= span.t0_ns <= live.instants[0][2] <= span.t1_ns <= after


def test_tracer_has_no_fence_nor_wrap():
    assert not hasattr(tt.Tracer, "fence")
    assert not hasattr(tt.Tracer, "wrap")


# ----------------------------------------------------------------- spans
def _children(spans, parent: str) -> set:
    ids = {s.sid for s in spans if s.name == parent}
    return {s.name for s in spans if s.parent_id in ids}


@pytest.mark.parametrize("datapath", ["espim", "dense"])
def test_forward_spans_account_for_the_launches(model, live, datapath):
    _serve(_eng(model, datapath), _reqs())
    spans = live.spans()
    assert _children(spans, "decode.launch") == DECODE_CHILDREN
    assert _children(spans, "prefill.launch") == LAYER_GROUPS
    assert _children(spans, "attn") == ATTN_CHILDREN
    n_layers = model[0].n_layers
    launches = live.spans("decode.launch")
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s.name)
    for p in launches:
        kids = by_parent[p.sid]
        assert kids.count("attn") == kids.count("mlp") == n_layers
    for parent in ("decode.launch", "prefill.launch"):
        cov = tt.span_coverage(spans, parent)
        assert cov["parents"] >= 1
        assert cov["coverage"] >= 0.9, (parent, cov)
        assert cov["overlap_errors"] == []


def test_disabled_tracer_builds_no_span(model, monkeypatch):
    assert not tt.get_tracer().enabled
    made = {"n": 0}
    init = tt.Span.__init__

    def counting(self, *a, **kw):
        made["n"] += 1
        init(self, *a, **kw)

    monkeypatch.setattr(tt.Span, "__init__", counting)
    eng = _eng(model, "espim")
    _serve(eng, _reqs())
    assert eng.stats.decode_steps > 0
    assert made["n"] == 0


def test_pack_build_spans(model, live):
    cfg, params, _ = model
    PSM.sparsify_model(cfg, params, 0.9, row_tile=32, quant="int8",
                       device="cpu")
    spans = live.spans()
    (build,) = live.spans("pack.build")
    assert _children(spans, "pack.build") == {
        "pack.prune", "pack.group", "pack.quantize", "pack.upload"}
    assert tt.span_coverage(spans, "pack.build")["overlap_errors"] == []
    groups = [s.args["group"] for s in live.spans("pack.group")]
    assert groups == [s.name for s in PSM._resolve_specs(cfg, "all").values()]
    assert all(build.t0_ns <= s.t0_ns and s.t1_ns <= build.t1_ns
               for s in spans if s.name.startswith("pack."))


# --------------------------------------------------------------- counter
@pytest.mark.parametrize("datapath", ["espim", "dense"])
def test_view_rebuilds_count_the_ticks_whose_pages_changed(model,
                                                           datapath):
    """The counter rises by one on exactly the decode ticks before whose
    gather a block was added, a prefill chunk scattered, a slot freed or
    the view invalidated; other decode ticks reuse the view."""
    eng = _eng(model, datapath)
    cache = eng.cache
    dirty = {"v": True}

    def marking(name, changed=lambda *a: True):
        orig = getattr(cache, name)

        def fn(*a, **kw):
            before = changed(*a)
            out = orig(*a, **kw)
            if before is True or before != changed(*a):
                dirty["v"] = True
            return out
        setattr(cache, name, fn)

    marking("ensure", lambda slot, n: int(cache.n_blocks[slot]))
    for name in ("scatter_chunk", "free_slot", "invalidate_view"):
        marking(name)
    counter = eng.metrics.counter("serve_cache_view_rebuilds_total")
    seen = {"counter": 0, "decode": 0}
    rises = []

    def gather(lens, _orig=cache.gather_view):
        rises.append(dirty["v"])
        dirty["v"] = False
        return _orig(lens)

    cache.gather_view = gather

    def check(step):
        if eng.stats.decode_steps > seen["decode"]:
            assert counter.value - seen["counter"] == int(rises[-1]), step
        else:
            assert counter.value == seen["counter"], step
        seen["counter"], seen["decode"] = counter.value, \
            eng.stats.decode_steps

    _serve(eng, _reqs(lens=(5, 11, 19), max_new=12), check)
    assert counter.value == sum(rises) == cache.view_rebuilds
    assert 0 < counter.value < len(rises)


# ---------------------------------------------------------------- prefill
def test_prefill_chunk_span_carries_its_tokens(model, live):
    reqs = _reqs(lens=(5, 11, 19))
    _serve(_eng(model, "espim"), reqs)
    by_rid: dict = {}
    for s in sorted(live.spans("prefill.chunk"), key=lambda s: s.t0_ns):
        by_rid.setdefault(s.args["rid"], []).append(s.args["tokens"])
    for r in reqs:
        n = len(r.prompt)
        assert by_rid[r.rid] == [CHUNK] * (n // CHUNK) + (
            [n % CHUNK] if n % CHUNK else [])
