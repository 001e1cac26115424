"""decode_tick_ms: the window's time in decode ticks over their number
(the harness's clock around the engine's step; the traced run
synchronises after each tick)."""
from perfbench.metrics._common import tick_ms


def read(run):
    return tick_ms(run, "decode")
