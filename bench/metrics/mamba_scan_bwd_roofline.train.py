"""mamba_scan_bwd_roofline.train: the least time the card could take for
the traced steps' selective-scan backwards (``yardstick.mamba_scan_backward``
at the step's shape, every layer: bytes or exponentials) over the time
their kernels (``mamba_bwd_pass1``, ``mamba_bwd_pass2``, ``sum_rows``) ran
in the trace, in percent."""

from bench.yardstick import bound_s, mamba_scan_backward

KERNELS = ("mamba_bwd_pass1", "mamba_bwd_pass2", "sum_rows_kernel")


def read(run):
    if run.entry != "train" or run.trace is None:
        return None
    spent = run.trace.seconds_of(KERNELS)
    if spent <= 0:
        return None
    mc, tr = run.config["model_config"], run.traffic
    ssm = mc["ssm"]
    w = mamba_scan_backward(tr["batch"], tr["seq"], ssm["expand"] * mc["d_model"],
                            ssm["d_state"])
    least = run.profiled["steps"] * mc["n_layers"] * bound_s(w["bytes"], w["flops"],
                                                              exps=w["exps"])
    return 100.0 * least / spent
