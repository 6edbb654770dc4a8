from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    COUNTER, flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
