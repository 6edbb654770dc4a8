"""Hand-written Hopper kernels of the port, one package each, with the
JAX package's public kernel API (``repro.kernels``):

  flash_attention/  blockwise online-softmax attention (GQA, windows)
  flash_decode/     paged ragged decode attention over the serving KV pool
  ssd_scan/         Mamba2 chunked state-space scan
  topk_compress/    block top-1 sparsification and the fused
                    error-feedback block-top-k compressor (paper §5.1)

Importing builds nothing: each kernel is compiled by nvcc at its first
launch on the card (``build.py``).
"""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.flash_decode import flash_decode  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels.topk_compress import block_topk  # noqa: F401
