"""PyTorch/CUDA port of the MLitB reproduction (``repro``), for NVIDIA
Hopper (sm_90a).

The package mirrors ``repro``'s layout and names; it imports ``torch``
and ``numpy`` and never ``jax`` or anything of ``repro``. Every entry
point takes a ``device`` that defaults to ``"cuda"`` and raises when CUDA
is absent, unless the caller asks for ``"cpu"`` (the plain PyTorch path
the CPU tests compare against the JAX package).
"""
from repro_torch.kernels.runtime import (  # noqa: F401
    require_hopper,
    resolve_device,
)
