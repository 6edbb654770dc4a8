from repro_torch.kernels.flash_decode.ops import COUNTER, flash_decode  # noqa: F401
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: F401
