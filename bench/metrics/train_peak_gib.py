"""train_peak_gib: torch.cuda.max_memory_allocated over the window, reset
at its start, in GiB: the memory a training step needs."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.entry == "train" and run.window_peak_bytes else None
