"""What every loop that drives the serving engine shares: the request and
tick records, and the tick itself.  The loops are modules of their own,
``traffic/loops/<loop>.py``, named by a mix's ``loop`` key.

The harness calls the engine's ``submit`` and ``step`` itself.  After each
step it reads every in-flight request's output and stamps each new token
with the clock after the step that emitted it.  A tick that emits a token
has read it on the host, which waits for the device.  Which work a tick
did is read from the engine's public step counters
(``stats.decode_steps``, ``stats.prefill_chunks``).
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["ReqRecord", "Tick", "EngineLoop"]


@dataclasses.dataclass
class ReqRecord:
    k: int                    # index in the run's request stream
    prompt: list
    max_new: int
    req: object               # the engine's Request
    t_send: float             # sent (closed loop) or due (open loop)
    t_first: float | None = None
    t_last: float | None = None
    t_done: float | None = None
    n_out: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def ok(self) -> bool:
        return self.n_out == self.max_new


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    kind: str                 # "decode" | "prefill" | "idle"
    tokens: int               # output tokens emitted by the tick
    contexts: tuple = ()      # a decode tick: each decoding request's
                              # attended positions (prompt + outputs)
    prompts: tuple = ()       # prompt lengths whose prefill ended here


class EngineLoop:
    """Requests of ``stream`` (a ``RequestStream``) on engine ``eng``;
    ``make_request(rid, prompt, max_new)`` builds the engine's request
    object.  A loop module subclasses it as ``Loop``: ``start()`` sends
    the first requests, ``_before_step()`` runs before each engine step
    and ``_on_done(n)`` after a step that finished n requests."""

    def __init__(self, eng, make_request, stream, mix: dict, seed: int,
                 clock=time.perf_counter):
        self.eng = eng
        self.make_request = make_request
        self.stream = stream
        self.mix = mix
        self.seed = seed
        self.clock = clock
        self.sent = 0
        self.inflight: dict = {}
        self.finished: list = []
        self.refused: list = []      # requests the engine would not take
        self.ticks: list = []

    def send(self, t_send: float | None = None) -> bool:
        """Submit the stream's next request, stamped ``t_send`` (now by
        default) -> whether the engine took it."""
        k = self.sent
        prompt, max_new = self.stream.spec(k)
        req = self.make_request(k, prompt, max_new)
        t = self.clock() if t_send is None else t_send
        self.sent += 1
        rec = ReqRecord(k, prompt, max_new, req, t)
        if not self.eng.submit(req):
            self.refused.append(rec)
            return False
        self.inflight[k] = rec
        return True

    def start(self) -> None:
        raise NotImplementedError

    def _before_step(self) -> None:
        pass

    def _on_done(self, n: int) -> None:
        pass

    def tick(self, before=None, after=None) -> Tick:
        """One engine step.  ``before()`` runs just before it (the traced
        run's tick marker), ``after()`` just after it, inside the
        tick's time (the traced run's synchronise)."""
        self._before_step()
        stats = self.eng.stats
        d0, p0 = stats.decode_steps, stats.prefill_chunks
        decoding = tuple(r.prompt_len + r.n_out
                         for r in self.inflight.values()
                         if r.n_out >= 1 and r.t_done is None)
        if before is not None:
            before()
        t0 = self.clock()
        self.eng.step()
        if after is not None:
            after()
        t1 = self.clock()
        kind = ("decode" if stats.decode_steps > d0
                else "prefill" if stats.prefill_chunks > p0 else "idle")
        emitted, prompts, done = 0, [], []
        for r in self.inflight.values():
            n = len(r.req.output)
            if n > r.n_out:
                if r.n_out == 0:
                    r.t_first = t1
                    prompts.append(r.prompt_len)
                emitted += n - r.n_out
                r.n_out = n
                r.t_last = t1
            if r.req.done:
                r.t_done = t1
                done.append(r.k)
        for k in done:
            self.finished.append(self.inflight.pop(k))
        self._on_done(len(done))
        t = Tick(t0, t1, kind, emitted,
                 decoding if kind == "decode" else (), tuple(prompts))
        self.ticks.append(t)
        return t

    def run_ticks(self, n: int, **kw) -> None:
        for _ in range(n):
            self.tick(**kw)

    def open_window(self, t_open: float) -> None:
        """Called as the window opens, before its first tick."""

    def run_for(self, seconds: float, **kw) -> tuple:
        """Ticks until ``seconds`` have passed -> (t_open, t_close, first
        tick index of the window)."""
        first = len(self.ticks)
        t_open = self.clock()
        self.open_window(t_open)
        end = t_open + seconds
        while self.clock() < end:
            self.tick(**kw)
        return t_open, self.clock(), first
