"""kernels_per_decode_tick: device kernels (copies left out) a decode tick,
from the device trace, over the window's decode ticks."""


def read(run):
    if run.trace is None:
        return None
    kinds = run.trace["kinds"]
    counts = [sum(1 for op in t.ops if op.kernel)
              for t in run.trace["ticks"] if kinds[t.index] == "decode"]
    return sum(counts) / len(counts) if counts else None
