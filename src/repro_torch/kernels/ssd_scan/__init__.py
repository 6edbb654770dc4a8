from repro_torch.kernels.ssd_scan.ops import COUNTER, ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_chunked_ref, ssd_ref, ssd_scan_ref)
