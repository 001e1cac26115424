"""tpot_p95_ms.chat: the 95th percentile, over the requests completed in
the window, of each request's mean gap between output tokens after the
first, in ms."""
from perfbench.metrics._common import percentile


def read(run):
    gaps = [(r.t_last - r.t_first) / (r.n_out - 1) for r in run.finished
            if run.in_window(r.t_done) and r.ok and r.n_out > 1]
    p = percentile(gaps, 95)
    return None if p is None else 1e3 * p
