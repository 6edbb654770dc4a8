from repro_torch.kernels.gemm_3xtf32.ops import (  # noqa: F401
    LAUNCHES, fit, gemm, linear, route)
from repro_torch.kernels.gemm_3xtf32.ref import (  # noqa: F401
    gemm_3xtf32_ref, gemm_tf32_ref, split_3xtf32, tf32_rna)
