"""train_mfu: the benchmark's count of the window's training operations
(``yardstick.train_step_flops``) over the window, as a share of the
card's bf16 peak, in percent."""

from bench.yardstick import PEAK_FLOPS


def read(run):
    if run.entry != "train" or run.window_s <= 0:
        return None
    return 100.0 * run.model_flops / run.window_s / PEAK_FLOPS["bfloat16"]
