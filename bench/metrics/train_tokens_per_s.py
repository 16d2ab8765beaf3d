"""train_tokens_per_s: every token of every step finished in the window,
over the window (host clock; each step ends in the loss read)."""


def read(run):
    return run.tokens / run.window_s if run.entry == "train" and run.window_s > 0 else None
