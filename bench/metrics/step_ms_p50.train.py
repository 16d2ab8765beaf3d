"""step_ms_p50.train: the median of the window's train_step times, each
ending in the loss read (host clock)."""

import numpy as np


def read(run):
    return float(np.median(run.step_s)) * 1e3 if run.entry == "train" and run.step_s else None
