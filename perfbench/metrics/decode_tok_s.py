"""decode_tok_s: every output token the engine emitted in the window, over
the window's seconds."""


def read(run):
    return sum(t.tokens for t in run.ticks) / run.window_s
