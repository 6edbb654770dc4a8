from repro_torch.kernels.topk_compress.ops import (  # noqa: F401
    BLOCK_TOPK_COUNTER, COUNTER, block_topk, fused_block_topk,
    fused_block_topk_batched)
from repro_torch.kernels.topk_compress.ref import (  # noqa: F401
    block_topk_ref)
