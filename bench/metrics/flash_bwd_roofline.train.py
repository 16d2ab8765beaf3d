"""flash_bwd_roofline.train: the least time the card could take for the
traced steps' flash attention backwards (``yardstick.flash_backward`` at
the step's shape, every attention layer) over the time their kernels
(``bwd_prep_sm90``, ``bwd_dkdv_sm90``, ``bwd_dq_sm90``, ``bwd_reduce_sm90``)
ran in the trace, in percent."""

from bench.yardstick import bound_s, flash_backward

KERNELS = ("bwd_prep_sm90", "bwd_dkdv_sm90", "bwd_dq_sm90", "bwd_reduce_sm90")


def read(run):
    if run.entry != "train" or run.trace is None:
        return None
    spent = run.trace.seconds_of(KERNELS)
    if spent <= 0:
        return None
    mc, tr = run.config["model_config"], run.traffic
    hd = mc.get("head_dim") or mc["d_model"] // mc["n_heads"]
    w = flash_backward(tr["batch"], mc["n_heads"], mc["n_kv_heads"], tr["seq"], hd)
    least = run.profiled["steps"] * mc["n_layers"] * bound_s(w["bytes"], w["flops"])
    return 100.0 * least / spent
