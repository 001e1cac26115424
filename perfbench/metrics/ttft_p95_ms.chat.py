"""ttft_p95_ms.chat: the 95th percentile, over the requests whose first
token came in the window, of the time from the request's send to its
first token, in ms."""
from perfbench.metrics._common import percentile


def _records(run):
    yield from run.finished
    yield from run.inflight


def read(run):
    waits = [r.t_first - r.t_send for r in _records(run)
             if run.in_window(r.t_first)]
    p = percentile(waits, 95)
    return None if p is None else 1e3 * p
