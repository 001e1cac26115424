"""Helpers the readers share: exact percentiles and the window's parts."""
from __future__ import annotations

__all__ = ["percentile", "ticks_of", "tick_ms"]


def percentile(values, q: float):
    """The q-th percentile (0-100) of ``values``, linear between the two
    nearest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ticks_of(run, kind: str) -> list:
    return [t for t in run.ticks if t.kind == kind]


def tick_ms(run, kind: str):
    """Mean milliseconds of the window's ticks of one kind: their summed
    time on the host's clock over their number."""
    ticks = ticks_of(run, kind)
    if not ticks:
        return None
    return 1e3 * sum(t.t1 - t.t0 for t in ticks) / len(ticks)
