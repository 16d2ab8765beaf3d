"""prefill_ms_p50.serve: the median over the window's generate calls of
the engine's own prefill_s (its host clock, ending in a synchronise)."""

import numpy as np


def read(run):
    return float(np.median(run.prefill_s)) * 1e3 if run.prefill_s else None
