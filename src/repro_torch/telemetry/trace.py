"""Structured span tracing for the serving stack (DESIGN.md §12).

ESPIM's argument is an accounting argument — bytes, cycles, bank
utilization — and the serving reproduction needs the software analogue:
where do a token's microseconds go?  The tracer records *nested spans*
(the engine's tick phases, the forward's layer groups, the pack build's
phases) and exports both Perfetto/Chrome ``trace_event`` JSON (open in
https://ui.perfetto.dev) and a plain JSONL event log whose header
carries the kernels' ``Provenance`` block.

Design constraints:

* **~no-op when disabled.**  ``Tracer(enabled=False).span(...)`` returns
  one shared ``_NullSpan`` singleton — no object allocation, no clock
  read, no lock — so the serving hot path can stay permanently
  instrumented (asserted by a counting shim in ``tests/test_telemetry.py``
  and ``tests/test_torch_trace.py``).
  The call signature takes an *explicit* ``args`` dict instead of
  ``**kwargs`` for the same reason: a disabled call must not even build
  an empty dict.
* **thread-safe.**  Span stacks are per-thread (``threading.local``);
  the finished-event list is guarded by one lock.  Span ids are globally
  unique so parent/child links survive interleaved threads.
* **the device trace's time base, no fence.**  Spans and instants are
  stamped with ``time.time_ns()``, Unix-epoch nanoseconds, the base
  ``torch.profiler`` stamps its host and device events in, so a span
  can be laid over a device trace of the same process and each idle gap
  of the card matched to what the host was doing.  The device events
  carry CUPTI's conversion of the card's clock, which drifts and steps
  against every host clock by up to milliseconds within a profile; a
  reader that needs microseconds moves the spans onto the device
  trace's clock through marks read on both (the benchmark's tick
  markers).  A span bills only the host's time: CUDA launches are
  asynchronous, and device work is read from the device trace, never
  by a synchronise at a span boundary, so tracing does not change the
  host/device overlap it observes.  Durations are end minus start.

This module is dependency-free (stdlib only).
"""
from __future__ import annotations

import itertools
import json
import threading
import time

__all__ = ["Span", "Tracer", "NULL_TRACER", "CLOCK", "CLOCK_NAME",
           "get_tracer", "set_tracer",
           "validate_chrome_trace", "span_coverage", "phase_breakdown",
           "BREAKDOWN_SCHEMA_KEYS"]


class _NullSpan:
    """The shared do-nothing span a disabled tracer hands out."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):        # parity with Span.set
        return self


_NULL_SPAN = _NullSpan()
_ids = itertools.count(1)
# Unix-epoch nanoseconds, the base torch.profiler's events are stamped in
CLOCK = time.time_ns
CLOCK_NAME = "unix_epoch_ns"


class Span:
    """One closed interval on one thread, stamped by ``CLOCK`` at enter
    and exit; ``parent_id`` links the enclosing span on the same thread
    at enter time."""
    __slots__ = ("name", "cat", "t0_ns", "t1_ns", "tid", "sid",
                 "parent_id", "depth", "args", "_tracer")

    def __init__(self, tracer, name, cat, tid, parent_id, depth, args):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.sid = next(_ids)
        self.parent_id = parent_id
        self.depth = depth
        self.args = args
        self.t0_ns = 0
        self.t1_ns = 0
        self._tracer = tracer

    def set(self, key, value):
        """Attach one attribute (rendered into trace_event ``args``)."""
        if self.args is None:
            self.args = {}
        self.args[key] = value
        return self

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    def __enter__(self):
        self._tracer._push(self)
        self.t0_ns = CLOCK()
        return self

    def __exit__(self, *exc):
        self.t1_ns = CLOCK()
        self._tracer._pop(self)
        return False


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list[Span] = []     # closed spans, completion order
        self.instants: list[tuple] = []  # (name, cat, t_ns, tid, args)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t_origin_ns = CLOCK()

    # ------------------------------------------------------------ recording
    def span(self, name: str, cat: str | None = None, args: dict | None = None):
        """Context manager for one nested span.  Disabled tracers return
        the shared null span: zero allocations on the hot path."""
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else None
        return Span(self, name, cat, threading.get_ident(),
                    parent.sid if parent else 0,
                    len(stack), args)

    def instant(self, name: str, cat: str | None = None,
                args: dict | None = None) -> None:
        """A point event (trace_event ``ph:"i"``) — quarantines, retries,
        watchdog flags: things with a moment but no duration."""
        if not self.enabled:
            return
        with self._lock:
            self.instants.append((name, cat, CLOCK(),
                                  threading.get_ident(), args))

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.instants.clear()
        self._t_origin_ns = CLOCK()

    # ------------------------------------------------------------- internal
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if not stack or stack[-1] is not span:
            raise RuntimeError(
                f"span {span.name!r} closed out of order (open stack: "
                f"{[s.name for s in stack]})")
        stack.pop()
        with self._lock:
            self.events.append(span)

    # ------------------------------------------------------------ analysis
    def spans(self, name: str | None = None) -> list[Span]:
        with self._lock:
            ev = list(self.events)
        if name is None:
            return ev
        return [s for s in ev if s.name == name]

    # ------------------------------------------------------------ exporters
    def _ts_us(self, t_ns: int) -> float:
        return (t_ns - self._t_origin_ns) / 1e3

    def chrome_trace(self, provenance: dict | None = None) -> dict:
        """Perfetto/Chrome ``trace_event`` JSON object format: complete
        ("X") events for spans, instant ("i") events for point marks."""
        events = []
        with self._lock:
            spans = list(self.events)
            instants = list(self.instants)
        for s in spans:
            ev = {"name": s.name, "ph": "X", "pid": 1, "tid": s.tid,
                  "ts": self._ts_us(s.t0_ns), "dur": s.dur_ns / 1e3,
                  "cat": s.cat or "default"}
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        for name, cat, t_ns, tid, args in instants:
            ev = {"name": name, "ph": "i", "pid": 1, "tid": tid,
                  "ts": self._ts_us(t_ns), "s": "t",
                  "cat": cat or "default"}
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        events.sort(key=lambda e: e["ts"])
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if provenance is not None:
            doc["otherData"] = {"provenance": provenance}
        return doc

    def write_chrome_trace(self, path: str,
                           provenance: dict | None = None) -> dict:
        doc = self.chrome_trace(provenance)
        validate_chrome_trace(doc)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

    def write_jsonl(self, path: str, provenance: dict | None = None) -> int:
        """Plain event log: one JSON object per line, header first.  The
        header's ``provenance`` is the same ``ops.Provenance.to_dict()``
        the benches embed — a trace is always tied to what actually ran."""
        with self._lock:
            spans = list(self.events)
            instants = list(self.instants)
        n = 0
        with open(path, "w") as f:
            f.write(json.dumps({"type": "header", "clock": CLOCK_NAME,
                                "origin_ns": self._t_origin_ns,
                                "provenance": provenance}) + "\n")
            for s in sorted(spans, key=lambda s: s.t0_ns):
                f.write(json.dumps({
                    "type": "span", "name": s.name, "cat": s.cat,
                    "t0_ns": s.t0_ns, "t1_ns": s.t1_ns, "tid": s.tid,
                    "sid": s.sid, "parent": s.parent_id, "depth": s.depth,
                    "args": s.args}) + "\n")
                n += 1
            for name, cat, t_ns, tid, args in instants:
                f.write(json.dumps({"type": "instant", "name": name,
                                    "cat": cat, "t_ns": t_ns, "tid": tid,
                                    "args": args}) + "\n")
                n += 1
        return n


NULL_TRACER = Tracer(enabled=False)
_default = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-default tracer — disabled unless a bench/example
    installed a live one.  Library code (``ops.pack_to_device``) traces
    through this so build-time work is captured without threading a
    tracer argument through every call chain."""
    return _default


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install (or, with None, reset) the process-default tracer;
    returns the previous one so callers can restore it."""
    global _default
    prev = _default
    _default = tracer if tracer is not None else NULL_TRACER
    return prev


# ---------------------------------------------------------------- validation
def validate_chrome_trace(doc: dict) -> None:
    """Schema check for the ``trace_event`` JSON object format (the
    subset Perfetto/chrome://tracing consume).  Raises ValueError with
    the first violation — CI runs this on every smoke trace so a code
    path that emits malformed events fails loudly."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace doc must be an object with 'traceEvents'")
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents must be a non-empty list")
    for i, ev in enumerate(evs):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}: {ev}")
        if ev["ph"] not in ("X", "B", "E", "i", "M", "C"):
            raise ValueError(f"traceEvents[{i}] unknown phase {ev['ph']!r}")
        if ev["ph"] == "X":
            if "dur" not in ev:
                raise ValueError(f"traceEvents[{i}] 'X' event missing dur")
            if ev["dur"] < 0:
                raise ValueError(f"traceEvents[{i}] negative dur {ev['dur']}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}] non-numeric ts")


def span_coverage(spans: list[Span], parent: str) -> dict:
    """How much of each ``parent`` span its direct children account for.

    Returns {"coverage": fraction of total parent time covered by direct
    children, "overlap_errors": sibling pairs that overlap in time,
    "parents": n, "uncovered_us": host time inside the parent no child
    claims}.  The engine test asserts coverage >= 0.95 and zero overlap
    errors — the guarantee that the breakdown's phases *are* the step,
    not a sample of it.
    """
    by_parent: dict[int, list[Span]] = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s)
    parents = [s for s in spans if s.name == parent]
    total_ns = covered_ns = 0
    overlaps = []
    for p in parents:
        kids = sorted(by_parent.get(p.sid, ()), key=lambda s: s.t0_ns)
        total_ns += p.dur_ns
        covered_ns += sum(k.dur_ns for k in kids)
        for a, b in zip(kids, kids[1:]):
            if b.t0_ns < a.t1_ns:
                overlaps.append((a.name, b.name,
                                 (a.t1_ns - b.t0_ns) / 1e3))
    return {
        "parents": len(parents),
        "coverage": covered_ns / total_ns if total_ns else 0.0,
        "uncovered_us": (total_ns - covered_ns) / 1e3,
        "overlap_errors": overlaps,
    }


# per-phase breakdown schema shared by serve_bench and kernels_bench —
# identical keys, whatever the bench (the acceptance criterion)
BREAKDOWN_SCHEMA_KEYS = ("wall_us", "coverage", "phases")
_PHASE_KEYS = ("total_us", "count", "frac")


def phase_breakdown(tracer: Tracer, parent: str | None = None) -> dict:
    """Aggregate spans into a per-phase breakdown keyed by category.

    With ``parent`` given (e.g. "engine.step"), only *direct children*
    of that span are aggregated and ``wall_us`` is the summed parent
    time — the serving shape: prefill vs decode vs scheduler vs
    host_sync as fractions of engine step wall.  Without it, root spans
    (parent_id == 0) are aggregated — the kernel-bench shape: warmup vs
    timed launches.  Both emit the same schema (BREAKDOWN_SCHEMA_KEYS).
    """
    spans = tracer.spans()
    if parent is None:
        sel = [s for s in spans if s.parent_id == 0]
        wall_ns = sum(s.dur_ns for s in sel)
    else:
        pids = {s.sid for s in spans if s.name == parent}
        sel = [s for s in spans if s.parent_id in pids]
        wall_ns = sum(s.dur_ns for s in spans if s.name == parent)
    phases: dict[str, dict] = {}
    for s in sel:
        ph = phases.setdefault(s.cat or "other",
                               {"total_us": 0.0, "count": 0, "frac": 0.0})
        ph["total_us"] += s.dur_ns / 1e3
        ph["count"] += 1
    for ph in phases.values():
        ph["total_us"] = round(ph["total_us"], 1)
        ph["frac"] = round(ph["total_us"] / max(wall_ns / 1e3, 1e-9), 4)
    return {
        "wall_us": round(wall_ns / 1e3, 1),
        "coverage": round(sum(p["total_us"] for p in phases.values())
                          / max(wall_ns / 1e3, 1e-9), 4),
        "phases": phases,
    }
