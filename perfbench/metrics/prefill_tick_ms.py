"""prefill_tick_ms: the window's time in prefill ticks over their number."""
from perfbench.metrics._common import tick_ms


def read(run):
    return tick_ms(run, "prefill")
