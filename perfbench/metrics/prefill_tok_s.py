"""prefill_tok_s: the prompt tokens of every request whose prefill ended in
the window (its first token came in the window), over the window's
seconds."""


def read(run):
    return sum(sum(t.prompts) for t in run.ticks) / run.window_s
