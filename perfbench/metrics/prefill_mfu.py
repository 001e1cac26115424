"""prefill_mfu: the prefill ticks' share of the chip's peak, in %: the
least time of every prompt whose prefill ended in the window
(``_work.WorkModel.prefill``), over the window's time in prefill ticks."""
from perfbench.metrics._common import ticks_of
from perfbench.metrics._work import bound_seconds


def read(run):
    ticks = ticks_of(run, "prefill")
    prompts = [p for t in run.ticks for p in t.prompts]
    if not ticks or not prompts or run.peaks is None:
        return None
    bound = sum(bound_seconds(*run.work.prefill(p), run.peaks)
                for p in prompts)
    return 100.0 * bound / sum(t.t1 - t.t0 for t in ticks)
