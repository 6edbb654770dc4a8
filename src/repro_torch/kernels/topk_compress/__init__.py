from repro_torch.kernels.topk_compress.ops import (  # noqa: F401
    COUNTER, fused_block_topk, fused_block_topk_batched)
