"""flash_fwd_roofline.serve: the least time the card could take for the
traced batches' flash attention forwards (``yardstick.flash_forward`` at
each batch's shape, every attention layer) over the time the kernel
(``flash_fwd_sm90``) ran in the trace, in percent."""

from bench.yardstick import bound_s, flash_forward

KERNELS = ("flash_fwd_sm90",)


def read(run):
    if run.entry != "serve" or run.trace is None:
        return None
    spent = run.trace.seconds_of(KERNELS)
    if spent <= 0:
        return None
    mc = run.config["model_config"]
    hd = mc.get("head_dim") or mc["d_model"] // mc["n_heads"]
    least = 0.0
    for s in run.profiled["lengths"]:
        w = flash_forward(run.profiled["batch"], mc["n_heads"], mc["n_kv_heads"], s, hd)
        least += mc["n_layers"] * bound_s(w["bytes"], w["flops"])
    return 100.0 * least / spent
