"""Latency-aware request scheduling for the serving engine.

SparseP's lesson — static, balance-aware assignment of sparse work onto
fixed execution units — maps onto serving: requests of wildly different
prompt/output lengths must be assigned to a fixed set of decode slots
without letting one long prompt monopolize the engine.  The scheduler
owns three decisions:

* **admission** — which pending request takes a freed slot.  ``fcfs``
  (arrival order) or ``sjf`` (shortest-prompt-first, which minimizes mean
  TTFT under load, at the cost of tail latency for long prompts).
  Admission is gated on the paged cache's worst-case block reservation,
  so an admitted request can never deadlock the arena mid-flight.
* **overload policy** (DESIGN.md §13) — the wait queue is bounded
  (``max_queue_depth``); a submit past the bound is resolved by
  ``shed_policy``: ``reject`` (refuse the newcomer), ``shed-oldest``
  (drop the longest-waiting queued request) or ``shed-largest`` (drop
  whichever of queue+newcomer has the largest worst-case token
  footprint).  Shed requests end in the ``shed`` terminal state — "we
  dropped it under load" is never reported as latency.  Under arena
  pressure the scheduler also nominates a **preemption** victim
  (longest-remaining generation first): the engine releases the victim's
  KV blocks and ``requeue``-s it; because ESPIM's sparsity plan is
  static, the victim resumes later by re-prefilling its prompt +
  committed tokens and its remaining greedy tokens are bit-identical to
  a never-preempted run.
* **prefill/decode interleave** — each engine tick is either one prefill
  chunk (for one slot) or one batched decode step (for every decode-ready
  slot).  At most ``max_prefill_streak`` consecutive prefill ticks run
  while any slot is decode-ready, so decode (TPOT) is never starved by a
  long prompt; with no decode-ready slots, prefill runs back-to-back.
* **metrics** — per-request queue delay, TTFT (submit -> first generated
  token) and TPOT (mean inter-token time after the first), aggregated
  into p50/p95 summaries for the engine's ``EngineStats``.

Latency percentiles are served from the telemetry histograms' streaming
quantile estimate: ``finish`` observes each request's TTFT/TPOT/queue
delay into fixed log-bucket histograms once, and ``summary`` reads
p50/p95 in O(buckets) — the pre-PR 7 path re-sorted every sample on
every ``latency_summary()`` call, O(n log n) per report tick.  The
module-level ``percentiles``/``latency_summary(done)`` helpers keep the
exact-sort semantics for ad-hoc lists.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.telemetry import flightrec
from repro_torch.telemetry.metrics import Histogram, Registry
from repro_torch.telemetry.trace import NULL_TRACER

__all__ = ["RequestMetrics", "Scheduler", "percentiles",
           "latency_summary", "TERMINAL_STATES", "SHED_POLICIES"]

POLICIES = ("fcfs", "sjf")
SHED_POLICIES = ("reject", "shed-oldest", "shed-largest")

# every request ends in exactly one of these (the robustness contract:
# "fast" and "fast because we dropped it" are different states):
#   completed        — full output, healthy datapath throughout
#   degraded         — full output, but some tokens came from the dense
#                      fallback after a quarantine (still greedy-correct)
#   cancelled        — torn down by an explicit cancel()
#   deadline_expired — torn down by a TTFT / wall-clock deadline
#   failed           — torn down because no datapath could produce finite
#                      logits (or retries exhausted)
#   shed             — dropped by overload admission control before (or
#                      instead of) ever running (bounded wait queue)
TERMINAL_STATES = ("completed", "degraded", "cancelled",
                   "deadline_expired", "failed", "shed")


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    t_submit: float
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    n_out: int = 0
    state: str = "in_flight"
    preempts: int = 0       # times this request was preempted + requeued

    @property
    def queue_delay(self) -> float | None:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float | None:
        """Mean time-per-output-token after the first."""
        if self.t_done is None or self.t_first is None or self.n_out < 2:
            return None
        return (self.t_done - self.t_first) / (self.n_out - 1)


def percentiles(xs, qs=(50, 95)) -> dict:
    xs = [x for x in xs if x is not None]
    if not xs:
        return {f"p{q}": None for q in qs}
    return {f"p{q}": float(np.percentile(np.asarray(xs), q)) for q in qs}


LATENCY_HISTS = ("ttft_s", "tpot_s", "queue_delay_s")
_HIST_METRIC = {"ttft_s": "serve_ttft_seconds",
                "tpot_s": "serve_tpot_seconds",
                "queue_delay_s": "serve_queue_delay_seconds"}


def latency_summary(done: list[RequestMetrics],
                    hists: dict | None = None) -> dict:
    """p50/p95 report over finished requests (shared by the scheduler's
    summary and the engine's EngineStats).  ``states`` counts the
    terminal state of every finished request, so the latency percentiles
    can never silently mix dropped requests into "fast".

    With ``hists`` (the scheduler's streaming histograms, one per
    LATENCY_HISTS key) the percentiles are the histograms' O(buckets)
    quantile estimates; without, the exact full-sort path runs — kept
    for ad-hoc metric lists, but NOT the engine report path."""
    states: dict = {}
    for m in done:
        states[m.state] = states.get(m.state, 0) + 1
    if hists is not None:
        lat = {k: hists[k].percentile_summary() for k in LATENCY_HISTS}
    else:
        lat = {
            "ttft_s": percentiles([m.ttft for m in done]),
            "tpot_s": percentiles([m.tpot for m in done]),
            "queue_delay_s": percentiles([m.queue_delay for m in done]),
        }
    return {"requests": len(done), **lat, "states": states}


class Scheduler:
    def __init__(self, policy: str = "fcfs", max_prefill_streak: int = 2,
                 metrics: Registry | None = None,
                 max_queue_depth: int | None = None,
                 shed_policy: str = "reject",
                 tracer=None, flight=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; use {POLICIES}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             f"use {SHED_POLICIES}")
        self.policy = policy
        self.max_prefill_streak = max(1, max_prefill_streak)
        self.max_queue_depth = max_queue_depth
        self.shed_policy = shed_policy
        self.on_shed = None           # callback(request) — engine hook
        # request-scoped lifecycle marks (DESIGN.md §14) go to both the
        # opt-in tracer and the always-on flight recorder
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.flight = (flight if flight is not None
                       else flightrec.get_recorder())
        self.pending: list = []       # [(request, RequestMetrics)]
        self.completed: list[RequestMetrics] = []
        self._streak = 0
        # streaming latency histograms: observed once per finished
        # request, read in O(buckets) by every summary — registered in
        # the engine's registry when one is supplied, private otherwise
        if metrics is not None:
            self.hists = {k: metrics.histogram(_HIST_METRIC[k])
                          for k in LATENCY_HISTS}
            self._c_requests = {
                s: metrics.counter("serve_requests_total", state=s)
                for s in TERMINAL_STATES}
        else:
            self.hists = {k: Histogram(_HIST_METRIC[k], {})
                          for k in LATENCY_HISTS}
            self._c_requests = None

    def reset_metrics(self) -> None:
        """Zero the streaming latency histograms (per-repeat benches)."""
        for h in self.hists.values():
            h.reset()

    def _mark(self, name: str, args: dict) -> None:
        """One rid-keyed lifecycle mark, mirrored to tracer + flight."""
        self.tracer.instant(name, cat="request", args=args)
        self.flight.record("request", name, args)

    # ----------------------------------------------------------- admission
    @staticmethod
    def _footprint(req) -> int:
        """Worst-case token footprint — the shed-largest ordering key."""
        return len(req.prompt) + getattr(req, "max_new_tokens", 0)

    def _shed(self, req, m) -> None:
        req.done = True
        self.finish(m, "shed")
        if self.on_shed is not None:
            self.on_shed(req)

    def add(self, request) -> RequestMetrics | None:
        """Enqueue a request, or shed per ``shed_policy`` when the wait
        queue is at ``max_queue_depth``.  Returns the new request's
        metrics, or None when the newcomer itself was shed.  Preempted
        requests waiting to resume are never shed — their committed
        tokens were already delivered, so dropping them would turn a
        partial stream into a lie."""
        m = RequestMetrics(rid=request.rid, prompt_len=len(request.prompt),
                           t_submit=time.monotonic())
        # queued mark BEFORE the shed decision: even a request shed at
        # the door gets a reconstructable queued -> terminal lifecycle
        self._mark("req.queued", {"rid": request.rid,
                                  "prompt_len": m.prompt_len})
        if (self.max_queue_depth is not None
                and len(self.pending) >= self.max_queue_depth):
            sheddable = [i for i, (r, pm) in enumerate(self.pending)
                         if pm.preempts == 0]
            if self.shed_policy == "reject" or not sheddable:
                self._shed(request, m)
                return None
            if self.shed_policy == "shed-oldest":
                victim = sheddable[0]
            else:                       # shed-largest: biggest worst-case
                victim = max(sheddable,  # footprint of queue + newcomer
                             key=lambda i: self._footprint(
                                 self.pending[i][0]))
                if (self._footprint(request)
                        > self._footprint(self.pending[victim][0])):
                    self._shed(request, m)
                    return None
            vreq, vm = self.pending.pop(victim)
            self._shed(vreq, vm)
        self.pending.append((request, m))
        return m

    def requeue(self, request, m: RequestMetrics) -> None:
        """Put a preempted request back at the head of the wait queue: it
        is the oldest admitted work (FCFS order preserved; SJF re-sorts
        at pick time anyway).  Requeueing bypasses the queue bound — the
        request already held a slot, so this is not new load."""
        m.preempts += 1
        m.t_admit = None
        self._mark("req.requeue", {"rid": request.rid,
                                   "preempts": m.preempts})
        self.pending.insert(0, (request, m))

    @property
    def has_pending(self) -> bool:
        return bool(self.pending)

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    def peek(self) -> tuple | None:
        """The (request, metrics) admission would try next per policy —
        the preemption candidate when its reservation is what's blocked."""
        if not self.pending:
            return None
        if self.policy == "sjf":
            i = min(range(len(self.pending)),
                    key=lambda i: (len(self.pending[i][0].prompt), i))
            return self.pending[i]
        return self.pending[0]

    def pick(self, can_admit) -> tuple | None:
        """Choose the next request for a free slot per policy; ``can_admit``
        (request -> bool) is the cache's reservation gate.  FCFS respects
        head-of-line order (a blocked head blocks the queue — its
        reservation will succeed as slots drain); SJF scans by prompt
        length."""
        if not self.pending:
            return None
        if self.policy == "sjf":
            order = sorted(range(len(self.pending)),
                           key=lambda i: (len(self.pending[i][0].prompt), i))
        else:
            order = range(len(self.pending))
        for i in order:
            req, m = self.pending[i]
            if can_admit(req):
                self.pending.pop(i)
                m.t_admit = time.monotonic()
                return req, m
            if self.policy == "fcfs":
                return None     # head-of-line blocking by design
        return None

    # ---------------------------------------------------------- interleave
    def next_action(self, prefilling: list[int],
                    decoding: list[int]) -> tuple[str, int | None]:
        """One engine tick: ('prefill', slot) | ('decode', None) |
        ('idle', None).  Decode is forced after ``max_prefill_streak``
        consecutive prefill ticks whenever any slot is decode-ready."""
        if not prefilling and not decoding:
            return "idle", None
        if prefilling and (not decoding
                           or self._streak < self.max_prefill_streak):
            self._streak += 1
            return "prefill", prefilling[0]
        self._streak = 0
        return "decode", None

    # ------------------------------------------------------------- metrics
    def finish(self, metrics: RequestMetrics,
               state: str = "completed") -> None:
        if state not in TERMINAL_STATES:
            raise ValueError(f"unknown terminal state {state!r}; "
                             f"use {TERMINAL_STATES}")
        metrics.t_done = time.monotonic()
        metrics.state = state
        # single choke point for ALL terminal transitions (teardown,
        # shed, cancel, expire) — the timeline's terminal mark
        self._mark("req.terminal", {"rid": metrics.rid, "state": state,
                                    "n_out": metrics.n_out})
        self.completed.append(metrics)
        for key, value in (("ttft_s", metrics.ttft),
                           ("tpot_s", metrics.tpot),
                           ("queue_delay_s", metrics.queue_delay)):
            if value is not None:
                self.hists[key].observe(value)
        if self._c_requests is not None:
            self._c_requests[state].inc()

    def cancel_pending(self, rid: int) -> bool:
        """Cancel a not-yet-admitted request; returns True if found."""
        for i, (req, m) in enumerate(self.pending):
            if req.rid == rid:
                self.pending.pop(i)
                req.done = True
                self.finish(m, "cancelled")
                return True
        return False

    def expire_pending(self, now: float) -> list:
        """Retire queued requests whose deadline passed while waiting for
        admission; returns their rids."""
        out = []
        keep = []
        for req, m in self.pending:
            dl = getattr(req, "deadline_s", None)
            tdl = getattr(req, "ttft_deadline_s", None)
            limit = min(x for x in (dl, tdl, float("inf")) if x is not None)
            if now - m.t_submit > limit:
                req.done = True
                self.finish(m, "deadline_expired")
                out.append(req.rid)
            else:
                keep.append((req, m))
        self.pending = keep
        return out

    def summary(self) -> dict:
        return latency_summary(self.completed, hists=self.hists)
