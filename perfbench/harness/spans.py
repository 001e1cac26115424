"""The program's own spans laid over the device trace of the same window.

The port's tracer (``repro_torch.telemetry.trace``) stamps its spans with
Unix-epoch nanoseconds, the unit ``torch.profiler`` stamps device ops in,
so each stretch in which the card ran nothing can be billed to what the
host was doing then: the innermost program span open over it, or the
harness where none was.  The device trace's clock is the host's only
piecewise: CUPTI's conversion of the card's timestamps drifts and steps
by up to milliseconds within a window, whatever host clock it is set
against.  So spans are first moved onto the device trace's clock
(``on_device_clock``) by the tick markers: the harness reads the host's
clock just before launching each marker on an idle card (the previous
tick ended in a synchronise), and the marker's device start is that
instant on the device trace's clock.  Between two markers the map is
linear.

Everything here works on plain records: a span is anything with
``name``, ``t0_ns``, ``t1_ns``, ``sid``, ``parent_id`` and ``tid`` (the
tracer's ``Span``), a device op a ``devtrace.DeviceOp``, a tick's ops a
``devtrace.TickOps``.

The readings (``None`` where the run holds nothing to read):

- ``idle_by_span``: idle device seconds by ``"<tick kind>: <span>"``, the
  tick kind being the kind of the tick whose first op ends the stretch,
  or ``between`` where the stretch ends at a tick's first op;
- ``launch_ms`` / ``readback_ms``: the mean host time of the window's
  ``decode.launch`` / decode ``host.sync`` spans;
- ``idle_launching_share``: the share of the idle device time that lies
  inside ``decode.launch`` or ``prefill.launch``;
- ``pack_seconds``: the set-up's ``pack.build`` span;
- ``clock_check``: the share of decode ticks whose device-to-host copy
  ends inside that tick's ``host.sync`` span, within ``CLOCK_SLACK_NS``.
"""
from __future__ import annotations

import bisect
import dataclasses

__all__ = ["HARNESS", "BETWEEN", "CLOCK_SLACK_NS", "STEP_NS", "LAUNCH_SPANS",
           "Moved", "on_device_clock", "idle_intervals", "innermost",
           "split_idle", "idle_by_span", "overlap_ns", "in_window",
           "launch_ms", "readback_ms", "idle_launching_share",
           "pack_seconds", "clock_check"]

HARNESS = "(harness)"
BETWEEN = "between"
CLOCK_SLACK_NS = 50_000
STEP_NS = 200_000
LAUNCH_SPANS = ("decode.launch", "prefill.launch")
_D2H = "Memcpy DtoH"


@dataclasses.dataclass(frozen=True)
class Moved:
    """A span moved onto the device trace's clock."""
    name: str
    t0_ns: int
    t1_ns: int
    sid: int
    parent_id: int
    tid: int


def on_device_clock(spans: list, host_marks: list, device_marks: list
                    ) -> list:
    """``spans`` moved onto the device trace's clock: ``host_marks[i]`` (the
    host's clock as tick ``i``'s marker was launched) is
    ``device_marks[i]`` (the marker's device start).  Between two marks
    the map is linear (the device clock's drift), unless the two clocks
    moved apart by more than ``STEP_NS`` there: the device clock stepped
    somewhere in between, and the earlier mark's offset holds up to the
    next.  Before the first mark and after the last the nearest mark's
    offset holds."""
    if len(host_marks) != len(device_marks) or not host_marks:
        raise ValueError(f"{len(host_marks)} host marks for "
                         f"{len(device_marks)} device marks")

    def move(t):
        i = bisect.bisect_right(host_marks, t) - 1
        if i < 0:
            return t + device_marks[0] - host_marks[0]
        if i + 1 >= len(host_marks):
            return t + device_marks[-1] - host_marks[-1]
        h0, h1 = host_marks[i], host_marks[i + 1]
        d0, d1 = device_marks[i], device_marks[i + 1]
        if h1 <= h0 or abs((d1 - d0) - (h1 - h0)) > STEP_NS:
            return t + d0 - h0
        return d0 + (t - h0) * (d1 - d0) // (h1 - h0)

    return [Moved(s.name, move(s.t0_ns), move(s.t1_ns), s.sid, s.parent_id,
                  s.tid) for s in spans]


def idle_intervals(ticks: list, kinds: list) -> list:
    """Idle stretches of the device between the window's ops, in time
    order -> [(start_ns, end_ns, kind)]: ``kind`` is ``BETWEEN`` for the
    stretch that ends at a tick's first op, else that tick's kind (the
    same cut as ``devtrace.idle_gaps``)."""
    out, reach = [], None
    for t in ticks:
        kind = kinds[t.index] if t.index < len(kinds) else "unknown"
        first = True
        for op in sorted(t.ops, key=lambda o: o.start_ns):
            if reach is not None and op.start_ns > reach:
                out.append((reach, op.start_ns, BETWEEN if first else kind))
            reach = op.end_ns if reach is None else max(reach, op.end_ns)
            first = False
    return out


def innermost(spans: list) -> list:
    """Properly nested spans of one thread -> [(t0_ns, t1_ns, name)]: the
    innermost span open over each stretch, in time order.  Stretches no
    span covers are left out."""
    out, stack, cursor = [], [], None

    def emit(t1, name):
        if t1 > cursor:
            out.append((cursor, t1, name))

    for s in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        while stack and stack[-1].t1_ns <= s.t0_ns:
            top = stack.pop()
            emit(top.t1_ns, top.name)
            cursor = top.t1_ns
        if stack:
            emit(s.t0_ns, stack[-1].name)
        cursor = s.t0_ns
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(top.t1_ns, top.name)
        cursor = top.t1_ns
    return out


def split_idle(intervals: list, segments: list) -> dict:
    """Each idle stretch split over the segments (``innermost``'s) that
    cover it -> {"<kind>: <name>": seconds}; a part no segment covers is
    ``"<kind>: (harness)"``.  The parts sum to the stretches exactly."""
    out: dict = {}

    def add(kind, name, ns):
        if ns > 0:
            key = f"{kind}: {name}"
            out[key] = out.get(key, 0.0) + ns / 1e9

    j = 0
    for a, b, kind in intervals:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        cur, k = a, j
        while cur < b and k < len(segments) and segments[k][0] < b:
            s0, s1, name = segments[k]
            add(kind, HARNESS, s0 - cur)
            lo, hi = max(s0, cur), min(s1, b)
            add(kind, name, hi - lo)
            cur = max(cur, hi)
            if s1 > b:
                break
            k += 1
        add(kind, HARNESS, b - cur)
    return out


def idle_by_span(ticks: list, kinds: list, spans: list) -> dict:
    """Idle device seconds of the window by ``"<kind>: <span>"``."""
    return split_idle(idle_intervals(ticks, kinds), innermost(spans))


def overlap_ns(intervals: list, spans: list) -> int:
    """Nanoseconds of ``intervals`` ((start, end, ...), disjoint) that lie
    inside any of ``spans`` (disjoint)."""
    spans = sorted(spans, key=lambda s: s.t0_ns)
    total, j = 0, 0
    for a, b, *_ in intervals:
        while j < len(spans) and spans[j].t1_ns <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k].t0_ns < b:
            total += min(b, spans[k].t1_ns) - max(a, spans[k].t0_ns)
            k += 1
    return total


def in_window(spans: list, t_open_ns: int, t_close_ns: int) -> list:
    """The spans that lie wholly inside the window."""
    return [s for s in spans if t_open_ns <= s.t0_ns and s.t1_ns <= t_close_ns]


def _mean_ms(spans: list):
    if not spans:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans) / len(spans) / 1e6


def launch_ms(spans: list):
    """Mean milliseconds of the ``decode.launch`` spans: the host issuing
    a decode step's work."""
    return _mean_ms([s for s in spans if s.name == "decode.launch"])


def _decode_syncs(spans: list) -> list:
    steps = {s.sid for s in spans if s.name == "decode.step"}
    return [s for s in spans if s.name == "host.sync" and s.parent_id in steps]


def readback_ms(spans: list):
    """Mean milliseconds of the decode ticks' ``host.sync`` spans: the
    host waiting on the card for the tick's tokens."""
    return _mean_ms(_decode_syncs(spans))


def idle_launching_share(ticks: list, kinds: list, spans: list):
    """% of the idle device time that lies inside ``decode.launch`` or
    ``prefill.launch``: the card waiting on the host's Python."""
    intervals = idle_intervals(ticks, kinds)
    idle = sum(b - a for a, b, _ in intervals)
    launches = [s for s in spans if s.name in LAUNCH_SPANS]
    if not idle or not launches:
        return None
    return 100.0 * overlap_ns(intervals, launches) / idle


def pack_seconds(spans: list):
    """Seconds of the ``pack.build`` spans (the ESPIM pack of set-up)."""
    packs = [s for s in spans if s.name == "pack.build"]
    if not packs:
        return None
    return sum(s.t1_ns - s.t0_ns for s in packs) / 1e9


def clock_check(ticks: list, kinds: list, spans: list,
                slack_ns: int = CLOCK_SLACK_NS) -> dict | None:
    """Whether the two clocks agree: for each decode tick (tick ``i`` is
    the window's ``i``-th ``engine.step`` span), does its last
    device-to-host copy end inside its ``host.sync`` span, within
    ``slack_ns``?  -> {"ticks", "inside", "share", "worst_us",
    "offsets_us", "lead_us"}: how far each tick's copy ended outside its
    span (negative: before it), the worst of them, and the most any
    tick's first device op started before its ``engine.step`` span did
    (work the host had not issued yet: a clock off by that much)."""
    steps = sorted((s for s in spans if s.name == "engine.step"),
                   key=lambda s: s.t0_ns)
    if not steps or len(steps) != len(ticks):
        return None
    syncs = sorted(_decode_syncs(spans), key=lambda s: s.t0_ns)
    offsets, lead, j = [], 0, 0
    for t, step in zip(ticks, steps):
        if t.ops:
            lead = max(lead, step.t0_ns - min(op.start_ns for op in t.ops))
        if kinds[t.index] != "decode":
            continue
        copies = [op for op in t.ops if op.name.startswith(_D2H)]
        while j < len(syncs) and syncs[j].t1_ns <= step.t0_ns:
            j += 1
        if not copies or j >= len(syncs) or syncs[j].t0_ns >= step.t1_ns:
            continue
        end, sync = max(op.end_ns for op in copies), syncs[j]
        offsets.append(min(end - sync.t0_ns, 0) + max(end - sync.t1_ns, 0))
    if not offsets:
        return None
    inside = sum(abs(o) <= slack_ns for o in offsets)
    return {"ticks": len(offsets), "inside": inside,
            "share": inside / len(offsets),
            "worst_us": max(abs(o) for o in offsets) / 1e3,
            "offsets_us": [o / 1e3 for o in offsets], "lead_us": lead / 1e3}
