"""The matrix products' share of their roofline: the least time of every
traced ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` (the larger of 2 M N K
over the peak at its dtype and its bytes over HBM's rate, from the
recorded shapes; ``flops.gemm_bound_s``) over those products' device
time."""


def read(run):
    t = run.trace
    if t is None or t.gemm_device_s <= 0:
        return None
    return 100.0 * t.gemm_bound_s / t.gemm_device_s
