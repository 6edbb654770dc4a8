"""Device resolution and the kernel launch counters.

The counterpart of ``repro.kernels.runtime``. The JAX package resolves an
``interpret`` flag (run the Pallas body in the interpreter unless on a
TPU); the port has no interpret mode and no fallback: a kernel wrapper
takes its plain PyTorch version only for tensors that lie on the CPU,
and on a CUDA tensor it launches the hand-written kernel or raises.

``resolve_device`` is what every entry point calls with its ``device``
argument (default ``"cuda"``): asking for CUDA on a machine without it
raises instead of quietly running on the CPU, and on the card it turns
TF32 off so float32 matrix products and convolutions stay float32.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    but absent. The CPU runs only when the caller names it. ``"meta"``
    is taken as well: it allocates nothing (the dry-runs' shape-only
    trees and caches)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not "
                f"available; pass device='cpu' to run the plain PyTorch "
                f"path on the CPU")
        # f32 must stay f32 on the card: the JAX reference computes in
        # full float32, and TF32 keeps only ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device={str(device)!r}: expected 'cuda', 'cpu' "
                         f"or 'meta'")
    return dev


def require_hopper(device: DeviceLike = "cuda") -> str:
    """Raise unless ``device`` is a CUDA card of compute capability 9.0
    (H100/H200, the ``sm_90a`` target the kernels are built for).
    Returns the card's name."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"require_hopper: {dev} is not a CUDA device")
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}")
    return torch.cuda.get_device_name(dev)


class LaunchCounter:
    """Counts launches of one hand-written kernel. The wrapper adds one
    exactly where it launches the kernel (never on the plain path), so a
    run can prove its main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


# every kernel's counter, by kernel name (filled as kernel modules import)
COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    if name not in COUNTERS:
        COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()
