"""The model FLOPs of those tokens (``flops.train_flops_per_token``) per
second of the window, as a share of the chip's peak at the
configuration's precision (``peaks.json``)."""


def read(w):
    if w.tokens <= 0:
        return None
    return 100.0 * w.flops / w.seconds / w.peak_flops
