"""The open loop: requests arrive at fixed gaps, whoever is waiting.

Mix key ``arrivals``: ``{"rate_per_s", "cv", "pool"}``: the gaps are a
fixed pool of ``pool`` draws (from the mix's ``pool_seed``) of a gamma
distribution with mean 1 / rate and coefficient of variation ``cv``
(1: Poisson arrivals; above 1: bursts).  Every run seed sends that same
set of gaps, pass p in its own order drawn from (seed, p).

Before the window the loop sends ``clients`` requests at once and runs
``ramp_ticks`` ticks, which warms the window's shapes.  From the window's
opening, request j of the window is due at the opening plus the sum of
the first j gaps; before each tick every request that is due is
submitted, stamped with its due time, so a time to first token counts
the wait in the queue.  A request the engine refuses is kept in
``refused``.  When nothing is in flight the loop waits for the next due
time.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness.loop import EngineLoop
from perfbench.traffic.generator import seed_words

_GAPS, _GAP_PASS = 4, 5     # seed-sequence tags


def gap_pool(arrivals: dict, pool_seed: int) -> list:
    """The mix's fixed pool of gaps between arrivals, in seconds."""
    rate, cv = float(arrivals["rate_per_s"]), float(arrivals["cv"])
    shape = 1.0 / (cv * cv)
    rng = np.random.default_rng([int(pool_seed), _GAPS])
    return rng.gamma(shape, 1.0 / (rate * shape),
                     size=int(arrivals["pool"])).tolist()


class Loop(EngineLoop):

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gaps = gap_pool(self.mix["arrivals"], self.mix["pool_seed"])
        self.due = None
        self.j = 0                    # arrivals of the window so far
        self._order: dict = {}

    def _gap(self, j: int) -> float:
        n = len(self.gaps)
        p, i = divmod(j, n)
        order = self._order.get(p)
        if order is None:
            rng = np.random.default_rng(seed_words(self.seed)
                                        + [_GAP_PASS, p])
            order = self._order[p] = rng.permutation(n).tolist()
        return self.gaps[order[i]]

    def start(self) -> None:
        for _ in range(int(self.mix["clients"])):
            self.send()

    def open_window(self, t_open: float) -> None:
        self.due = t_open + self._gap(0)

    def _before_step(self) -> None:
        if self.due is None:
            return
        if not self.inflight:
            while self.clock() < self.due:
                time.sleep(min(1e-3, max(0.0, self.due - self.clock())))
        now = self.clock()
        while self.due <= now:
            self.send(self.due)
            self.j += 1
            self.due += self._gap(self.j)
