"""Per-request timeline reconstruction from traces (DESIGN.md §14).

ESPIM's sparsity plan is static (SDDS), so every per-request cost is
attributable — but aggregate telemetry folded everything into
engine-level histograms.  This module closes the gap: the engine and
scheduler emit ``rid``-keyed lifecycle instants (``req.queued`` /
``req.admit`` / ``req.first_token`` / ``req.requeue`` / ``req.terminal``,
plus the existing ``fault.*`` marks) and tag the work spans that serve a
request (``prefill.chunk`` carries ``rid``, ``decode.step`` carries the
``rids`` of every slot it batched), and ``build_timelines`` folds them
back into one ``RequestTimeline`` per request: an exact partition of the
request's wall clock (queued → prefill chunks → decode ticks → terminal
state) whose segment sum IS the request's latency, with TTFT/TPOT
derivable from the same marks the engine's ``RequestMetrics`` record.

Timelines reconstruct from any of the tracer's three forms — the live
``Tracer``, an exported Perfetto/Chrome ``trace_event`` doc, or the
JSONL event log — so a post-mortem needs only the artifact, never the
process that wrote it.

Segment kinds (a partition of ``t_queued .. t_terminal``):

* ``queued``  — waiting for admission (initial queue, or re-queued after
  a preemption: the request holds no slot).
* ``prefill`` — inside a ``prefill.chunk`` span that fed this request.
* ``decode``  — inside a ``decode.step`` span whose batch included it.
* ``wait``    — resident in a slot but not inside its own work span
  (other slots' prefill ticks, scheduler/bookkeeping time).

Clock caveat: timeline timestamps are the tracer's ``time.time_ns()``
(Unix epoch, the device trace's time base); the engine's
``RequestMetrics`` use ``time.monotonic()``.  Durations (TTFT, TPOT,
segment sums) are comparable across the two while the wall clock is not
stepped; absolute values are not.  ``check_timelines`` asserts the
cross-clock agreement within tolerance.
"""
from __future__ import annotations

import dataclasses
import json

__all__ = ["Segment", "RequestTimeline", "build_timelines",
           "timelines_from_tracer", "timelines_from_chrome",
           "timelines_from_jsonl", "check_timelines", "format_timeline",
           "LIFECYCLE_INSTANTS"]

# the rid-keyed lifecycle marks the scheduler/engine emit (cat "request")
LIFECYCLE_INSTANTS = ("req.queued", "req.admit", "req.first_token",
                      "req.requeue", "req.terminal")
# fault-ladder instants that carry a rid and land in timeline.events
_FAULT_MARKS = ("fault.shed", "fault.preempt", "fault.resume",
                "fault.quarantine", "fault.restore")
_WORK_SPANS = ("prefill.chunk", "decode.step")


@dataclasses.dataclass
class Segment:
    kind: str          # "queued" | "prefill" | "decode" | "wait"
    t0_ns: int
    t1_ns: int

    @property
    def dur_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


@dataclasses.dataclass
class RequestTimeline:
    rid: int
    state: str | None = None          # terminal state, None if unfinished
    t_queued_ns: int | None = None
    t_admit_ns: int | None = None     # first admission
    t_first_ns: int | None = None     # first emitted token
    t_terminal_ns: int | None = None
    n_out: int = 0
    preempts: int = 0
    quarantines: int = 0
    segments: list = dataclasses.field(default_factory=list)
    # (t_ns, name, args) lifecycle + fault marks, time order
    events: list = dataclasses.field(default_factory=list)

    @property
    def complete(self) -> bool:
        """A reconstructable lifecycle: queued + terminal marks present,
        and — for states that delivered output — a first-token mark."""
        if self.t_queued_ns is None or self.state is None:
            return False
        if self.state in ("completed", "degraded"):
            return self.t_first_ns is not None
        return True

    @property
    def wall_s(self) -> float | None:
        if self.t_queued_ns is None or self.t_terminal_ns is None:
            return None
        return (self.t_terminal_ns - self.t_queued_ns) / 1e9

    @property
    def ttft_s(self) -> float | None:
        if self.t_queued_ns is None or self.t_first_ns is None:
            return None
        return (self.t_first_ns - self.t_queued_ns) / 1e9

    @property
    def tpot_s(self) -> float | None:
        """Mean time-per-output-token after the first — same definition
        as ``RequestMetrics.tpot``."""
        if (self.t_first_ns is None or self.t_terminal_ns is None
                or self.n_out < 2):
            return None
        return ((self.t_terminal_ns - self.t_first_ns) / 1e9
                / (self.n_out - 1))

    def segment_sum_s(self) -> float:
        return sum(s.dur_s for s in self.segments)

    def by_kind(self) -> dict:
        out: dict = {}
        for s in self.segments:
            out[s.kind] = out.get(s.kind, 0.0) + s.dur_s
        return out


# ------------------------------------------------------------ event sources
def _norm_span(name, cat, t0_ns, t1_ns, args):
    return {"type": "span", "name": name, "cat": cat,
            "t0_ns": int(t0_ns), "t1_ns": int(t1_ns), "args": args or {}}


def _norm_instant(name, cat, t_ns, args):
    return {"type": "instant", "name": name, "cat": cat,
            "t_ns": int(t_ns), "args": args or {}}


def timelines_from_tracer(tracer) -> dict:
    """Reconstruct straight from a live ``Tracer`` (absolute ns)."""
    events = [_norm_span(s.name, s.cat, s.t0_ns, s.t1_ns, s.args)
              for s in tracer.spans()]
    events += [_norm_instant(name, cat, t_ns, args)
               for name, cat, t_ns, _tid, args in list(tracer.instants)]
    return build_timelines(events)


def timelines_from_chrome(doc: dict) -> dict:
    """Reconstruct from an exported Perfetto/Chrome ``trace_event`` doc
    (timestamps are relative microseconds; converted to ns)."""
    events = []
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            t0 = round(ev["ts"] * 1e3)
            events.append(_norm_span(ev["name"], ev.get("cat"), t0,
                                     t0 + round(ev["dur"] * 1e3),
                                     ev.get("args")))
        elif ev["ph"] == "i":
            events.append(_norm_instant(ev["name"], ev.get("cat"),
                                        round(ev["ts"] * 1e3),
                                        ev.get("args")))
    return build_timelines(events)


def timelines_from_jsonl(path: str) -> dict:
    """Reconstruct from the tracer's JSONL event log (header skipped)."""
    events = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["type"] == "span":
                events.append(_norm_span(rec["name"], rec.get("cat"),
                                         rec["t0_ns"], rec["t1_ns"],
                                         rec.get("args")))
            elif rec["type"] == "instant":
                events.append(_norm_instant(rec["name"], rec.get("cat"),
                                            rec["t_ns"], rec.get("args")))
    return build_timelines(events)


# ------------------------------------------------------------ reconstruction
def build_timelines(events: list[dict]) -> dict:
    """Fold normalized events into ``{rid: RequestTimeline}``.

    Robust to partial traces (a killed engine's requests simply stay
    incomplete) and to duplicate lifecycle marks across engines sharing
    one tracer (crash drill: restore re-queues the same rid — the first
    ``req.queued`` and the last ``req.terminal`` win)."""
    tls: dict[int, RequestTimeline] = {}

    def tl(rid) -> RequestTimeline:
        rid = int(rid)
        if rid not in tls:
            tls[rid] = RequestTimeline(rid=rid)
        return tls[rid]

    work: dict[int, list] = {}       # rid -> [(t0, t1, kind)]
    resident: dict[int, list] = {}   # rid -> residency change marks

    for ev in events:
        args = ev["args"]
        if ev["type"] == "instant":
            name, t_ns = ev["name"], ev["t_ns"]
            rid = args.get("rid")
            if rid is None:
                continue
            t = tl(rid)
            if name in LIFECYCLE_INSTANTS or name in _FAULT_MARKS:
                t.events.append((t_ns, name, args))
            if name == "req.queued":
                if t.t_queued_ns is None or t_ns < t.t_queued_ns:
                    t.t_queued_ns = t_ns
            elif name == "req.admit":
                if t.t_admit_ns is None:
                    t.t_admit_ns = t_ns
                resident.setdefault(int(rid), []).append((t_ns, True))
            elif name == "req.first_token":
                if t.t_first_ns is None:
                    t.t_first_ns = t_ns
            elif name == "req.terminal":
                t.t_terminal_ns = t_ns
                t.state = args.get("state")
                t.n_out = int(args.get("n_out", t.n_out))
            elif name in ("fault.preempt", "req.requeue"):
                if name == "fault.preempt":
                    t.preempts += 1
                    resident.setdefault(int(rid), []).append((t_ns, False))
            elif name == "fault.quarantine":
                t.quarantines += 1
        else:  # span
            name = ev["name"]
            if name == "prefill.chunk" and "rid" in args:
                work.setdefault(int(args["rid"]), []).append(
                    (ev["t0_ns"], ev["t1_ns"], "prefill"))
            elif name == "decode.step":
                for rid in args.get("rids", ()):
                    work.setdefault(int(rid), []).append(
                        (ev["t0_ns"], ev["t1_ns"], "decode"))

    for rid, t in tls.items():
        t.events.sort(key=lambda e: e[0])
        t.segments = _segments(t, sorted(work.get(rid, ())),
                               sorted(resident.get(rid, ())))
    return tls


def _segments(t: RequestTimeline, work: list, resident: list) -> list:
    """Exact partition of [t_queued, t_terminal]: work spans clipped to
    the window, gaps classified queued/wait by slot residency."""
    if t.t_queued_ns is None:
        return []
    t1 = t.t_terminal_ns
    if t1 is None:
        t1 = max([t.t_queued_ns]
                 + [w[1] for w in work]
                 + [m[0] for m in resident])
    segs: list[Segment] = []

    def resident_at(ts: int) -> bool:
        on = False
        for m_ts, m_on in resident:
            if m_ts > ts:
                break
            on = m_on
        return on

    def fill_gap(a: int, b: int) -> None:
        if b <= a:
            return
        # split the gap at residency flips so queued vs wait is exact
        cuts = [a] + [m_ts for m_ts, _ in resident if a < m_ts < b] + [b]
        for lo, hi in zip(cuts, cuts[1:]):
            if hi <= lo:
                continue
            kind = "wait" if resident_at(lo) else "queued"
            if segs and segs[-1].kind == kind and segs[-1].t1_ns == lo:
                segs[-1].t1_ns = hi
            else:
                segs.append(Segment(kind, lo, hi))

    cursor = t.t_queued_ns
    for w0, w1, kind in work:
        w0, w1 = max(w0, t.t_queued_ns), min(w1, t1)
        if w1 <= cursor:
            continue
        w0 = max(w0, cursor)
        fill_gap(cursor, w0)
        segs.append(Segment(kind, w0, w1))
        cursor = w1
    fill_gap(cursor, t1)
    return segs


# -------------------------------------------------------------- validation
def check_timelines(timelines: dict, metrics_by_rid: dict | None = None,
                    tol_s: float = 0.05) -> dict:
    """Assert the reconstruction contract over a traced run:

    * every timeline is ``complete`` (queued + terminal, first token when
      output was delivered);
    * segments partition the request's wall exactly (sum == wall);
    * with ``metrics_by_rid`` (rid -> the engine's ``RequestMetrics``),
      the timeline's TTFT/TPOT agree with the engine's within ``tol_s``
      — a cross-clock, cross-codepath consistency check.

    Returns a summary report (requests / complete / states / max errors).
    """
    states: dict = {}
    max_ttft_err = max_tpot_err = 0.0
    n_complete = 0
    for rid, t in timelines.items():
        if t.complete:
            n_complete += 1
        else:
            raise AssertionError(
                f"rid {rid}: incomplete timeline (state={t.state}, "
                f"queued={t.t_queued_ns is not None}, "
                f"first={t.t_first_ns is not None}) — events: "
                f"{[(n, a) for _, n, a in t.events]}")
        states[t.state] = states.get(t.state, 0) + 1
        wall = t.wall_s
        if wall is not None and t.segments:
            gap = abs(t.segment_sum_s() - wall)
            assert gap < 1e-6, (
                f"rid {rid}: segments sum {t.segment_sum_s():.6f}s != "
                f"wall {wall:.6f}s — not a partition")
        if metrics_by_rid is None or rid not in metrics_by_rid:
            continue
        m = metrics_by_rid[rid]
        for label, mine, theirs in (("ttft", t.ttft_s, m.ttft),
                                    ("tpot", t.tpot_s, m.tpot)):
            if mine is None or theirs is None:
                continue
            err = abs(mine - theirs)
            assert err <= tol_s, (
                f"rid {rid}: timeline {label} {mine:.4f}s vs engine "
                f"{theirs:.4f}s (|err| {err:.4f}s > tol {tol_s}s)")
            if label == "ttft":
                max_ttft_err = max(max_ttft_err, err)
            else:
                max_tpot_err = max(max_tpot_err, err)
    return {"requests": len(timelines), "complete": n_complete,
            "states": states,
            "max_ttft_err_s": round(max_ttft_err, 6),
            "max_tpot_err_s": round(max_tpot_err, 6)}


# --------------------------------------------------------------- rendering
def format_timeline(t: RequestTimeline, width: int = 48) -> str:
    """One-request ASCII strip: lifecycle header plus a proportional
    segment bar (q=queued, p=prefill, d=decode, .=wait)."""
    glyph = {"queued": "q", "prefill": "p", "decode": "d", "wait": "."}
    wall = t.wall_s or 0.0
    bar = ""
    if wall > 0 and t.segments:
        for s in t.segments:
            bar += glyph[s.kind] * max(1, round(s.dur_s / wall * width))
    parts = [f"rid {t.rid}: {t.state or 'in_flight'}"]
    if wall:
        parts.append(f"{wall * 1e3:.1f}ms wall")
    if t.ttft_s is not None:
        parts.append(f"ttft {t.ttft_s * 1e3:.1f}ms")
    if t.tpot_s is not None:
        parts.append(f"tpot {t.tpot_s * 1e3:.2f}ms")
    if t.preempts:
        parts.append(f"preempts {t.preempts}")
    if t.quarantines:
        parts.append(f"quarantines {t.quarantines}")
    head = ", ".join(parts)
    kinds = t.by_kind()
    detail = " ".join(f"{k}={v * 1e3:.1f}ms"
                      for k, v in sorted(kinds.items()))
    return f"{head}\n  [{bar}]\n  {detail}" if bar else head
