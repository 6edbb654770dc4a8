"""Public wrappers of the fused error-feedback block-top-k kernel.

``fused_block_topk_batched`` dispatches on the tensors' device: CPU
tensors take the plain PyTorch version (``ref.py``); CUDA tensors launch
the hand-written ``sm_90a`` kernel (``topk_compress.cu``), built with nvcc
at first use. A build or launch failure raises; nothing falls back to the
plain version on the card. ``COUNTER`` counts kernel launches (and only
those). The kernel does the JAX wrapper's tail padding and global-index
arithmetic itself (it reads the (n_workers, n) buffers in place and
treats columns past n as zeros), so the card path copies nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import launch_counter
from repro_torch.kernels.topk_compress.ref import fused_block_topk_batched_ref

SOURCE = Path(__file__).with_name("topk_compress.cu")
COUNTER = launch_counter("fused_compress")
MAX_BLOCK_W = 1024           # 32 lanes x 32 registers per lane


def _declare(lib: ctypes.CDLL) -> None:
    lib.fused_compress_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.fused_compress_launch.restype = ctypes.c_int


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("fused_compress", [SOURCE], configure=_declare)


def _check(g: torch.Tensor, r: torch.Tensor, k: int, block_w: int) -> None:
    if g.dim() != 2 or tuple(r.shape) != tuple(g.shape):
        raise ValueError(f"fused_block_topk_batched: g {tuple(g.shape)} and "
                         f"r {tuple(r.shape)} must both be (n_workers, n)")
    if g.device != r.device:
        raise ValueError(f"fused_block_topk_batched: g on {g.device}, r on "
                         f"{r.device}")
    if not 1 <= block_w <= MAX_BLOCK_W:
        raise ValueError(f"fused_block_topk_batched: block_w={block_w} must "
                         f"lie in [1, {MAX_BLOCK_W}]")
    if k < 1:
        raise ValueError(f"fused_block_topk_batched: k={k} must be >= 1")


def fused_block_topk_batched(g: torch.Tensor, r: torch.Tensor, *, k: int,
                             block_w: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Batched fused channel: g, r are (W, n) stacks of per-worker flat
    buffers; ALL workers are compressed by ONE kernel launch. Returns
    (values (W, R, k) f32, global indices (W, R, k) int32 — each worker's
    indices address its own (n,) buffer — and residuals (W, n) f32), with
    R = ceil(n / block_w) and k clamped to block_w."""
    _check(g, r, k, block_w)
    k = min(k, block_w)
    if g.device.type == "cpu":
        return fused_block_topk_batched_ref(g, r, k=k, block_w=block_w)
    if g.device.type != "cuda":
        raise ValueError(f"fused_block_topk_batched: unsupported device "
                         f"{g.device}")
    Wk, n = g.shape
    R = -(-n // block_w)
    if Wk * R * block_w >= 2 ** 31:
        raise ValueError(f"fused_block_topk_batched: {Wk} x {R} rows of "
                         f"{block_w} overflow the int32 index space")
    g = g.float().contiguous()
    r = r.float().contiguous()
    vals = torch.empty((Wk, R, k), dtype=torch.float32, device=g.device)
    idx = torch.empty((Wk, R, k), dtype=torch.int32, device=g.device)
    res = torch.empty((Wk, n), dtype=torch.float32, device=g.device)
    lib = library().lib
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = lib.fused_compress_launch(
            g.data_ptr(), r.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            res.data_ptr(), n, Wk, block_w, k, g.device.index, stream)
    check_launch("fused_compress", code)
    COUNTER.count += 1
    return vals, idx, res


def fused_block_topk(g: torch.Tensor, r: torch.Tensor, *, k: int,
                     block_w: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-worker form over flat (n,) buffers -> (values (R, k),
    global indices (R, k) int32, residual (n,))."""
    vals, idx, res = fused_block_topk_batched(
        g.reshape(1, -1), r.reshape(1, -1), k=k, block_w=block_w)
    return vals[0], idx[0], res[0]
