"""decode_mfu: the decode ticks' share of the chip's peak, in %: each
tick's least time (the larger of its operations at the bf16 tensor peak
and its bytes at the memory bandwidth, ``_work.WorkModel.decode_tick``),
summed over the window's decode ticks, over their summed time."""
from perfbench.metrics._common import ticks_of
from perfbench.metrics._work import bound_seconds


def read(run):
    ticks = ticks_of(run, "decode")
    if not ticks or run.peaks is None:
        return None
    bound = sum(bound_seconds(*run.work.decode_tick(t.contexts), run.peaks)
                for t in ticks)
    return 100.0 * bound / sum(t.t1 - t.t0 for t in ticks)
