"""decode_ms.serve: the device ms of a generate call's decode steps (the
program's ``serve.decode_step`` spans, summed; 0.0 for a call that ran
none), the median over the batches of the last traced pass, the device-only
one (as many ``serve.generate`` roots from the end of the program's span
buffer as the pass served batches).  A span's device interval is the card's
time between the CUDA events the program records at its ends; None where
the program keeps no spans or no device times (a CPU run)."""

import numpy as np


def read(run):
    if run.entry != "serve" or run.trace is None:
        return None
    try:
        from repro_torch.obs.profile import phase_ms
    except ImportError:  # a program without spans
        return None
    ms = phase_ms("serve.generate", "serve.decode_step", len(run.profiled["lengths"]))
    return float(np.median(ms)) if ms else None
