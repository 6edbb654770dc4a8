"""The matrix products' share of their roofline over one profiled step:
the least time of every product the step launched, over those launches'
device time (``devtrace.attribute``). Counted: each cuBLAS ``mm`` /
``addmm`` / ``bmm`` / ``baddbmm`` (attention's scores, the SSD's einsums)
and each launch of the program's hand-written ``gemm_3xtf32_kernel``,
found by name, three a ``linear`` (its forward, and dX and dW in its
backward, each at the forward's M, N, K; remat's recomputed forward
too). A product's least time is the larger of 2 M N K over the peak at
its dtype (float32: 165 TFLOP/s, the 3xTF32 rate) and its bytes over
HBM's rate (``flops.product_bound_s``)."""


def read(run):
    t = run.trace
    if t is None or t.gemm_device_s <= 0:
        return None
    return 100.0 * t.gemm_bound_s / t.gemm_device_s
