"""ttft_p90_ms: the 90th percentile over every request of the window of
its time to first token: the wall time of the generate call that served
it, the request admitted when the call began (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.ttft_s, 90)) * 1e3 if run.ttft_s else None
