"""device_idle_share.chat: the share of the traced window in which no
operation ran on the card, in %: 1 - the union of the device ops' spans
(the tick markers left out) over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
