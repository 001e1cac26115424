"""setup_s: seconds from the process's start until the window opens
(weights, the pack, the engine and its pack check, the ramp that warms
the window's shapes)."""


def read(run):
    return run.setup_s
