"""forward_ms.train: the device ms of a training step's forward passes (the
program's ``train.forward`` spans, summed over its micro-batches), the
median over the steps of the last traced pass, the device-only one
(``run.profiled["steps"]`` ``train.step`` roots from the end of the
program's span buffer).  A span's device interval is the card's time
between the CUDA events the program records at its ends; None where the
program keeps no spans or no device times (a CPU run)."""

import numpy as np


def read(run):
    if run.entry != "train" or run.trace is None:
        return None
    try:
        from repro_torch.obs.profile import phase_ms
    except ImportError:  # a program without spans
        return None
    ms = phase_ms("train.step", "train.forward", run.profiled["steps"])
    return float(np.median(ms)) if ms else None
