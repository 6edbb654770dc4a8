"""The whole step's share of the chip's peak: the model FLOPs of the
tokens the traced steps trained (``flops.train_flops_per_token``) over
the traced window, over the peak at the configuration's precision."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.tokens <= 0 or not run.peak_flops:
        return None
    return 100.0 * t.tokens * run.flops_per_token / t.window_s / run.peak_flops
