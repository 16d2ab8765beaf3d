"""serve_tokens_per_s: the prompt and generated tokens of every request
finished in the window, over the window (host clock)."""


def read(run):
    return run.tokens / run.window_s if run.entry == "serve" and run.window_s > 0 else None
