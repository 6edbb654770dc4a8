"""Public wrappers of the block-top-k kernels.

``block_topk`` (top-1 per block, the Pallas ``_topk_kernel``) and
``fused_block_topk_batched`` (the fused error-feedback channel, the
Pallas ``_fused_kernel``) dispatch on the tensors' device: CPU tensors
take the plain PyTorch versions (``ref.py``); CUDA tensors launch the
hand-written ``sm_90a`` kernels (``block_topk.cu``, ``topk_compress.cu``),
built with nvcc at first use. A build or launch failure raises; nothing
falls back to the plain version on the card. ``BLOCK_TOPK_COUNTER`` and
``COUNTER`` count kernel launches (and only those). Both kernels do the
JAX wrappers' tail padding themselves (they read the buffers in place
and treat columns past n as zeros), so the card path copies nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import launch_counter
from repro_torch.kernels.topk_compress.ref import (
    block_topk_flat_ref, fused_block_topk_batched_ref)

SOURCE = Path(__file__).with_name("topk_compress.cu")
BLOCK_TOPK_SOURCE = Path(__file__).with_name("block_topk.cu")
COUNTER = launch_counter("fused_compress")
BLOCK_TOPK_COUNTER = launch_counter("block_topk")
# the CUDA kernel's widest block: 32 lanes x 32 registers per lane. The
# plain version takes any width; no config uses more than 128
# (``GradientCompressor.block_w``), so the card refuses wider blocks
# rather than carrying a second kernel path
MAX_BLOCK_W = 1024


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
    if block_w < 1:
        raise ValueError(f"fused_block_topk_batched: block_w={block_w} must "
                         f"be >= 1")
    if g.device.type != "cpu" and block_w > MAX_BLOCK_W:
        raise ValueError(f"fused_block_topk_batched: block_w={block_w} must "
                         f"lie in [1, {MAX_BLOCK_W}] for the CUDA kernel "
                         f"(the CPU's plain version takes any width)")
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


# ---------------------------------------------------------------------------
# top-1 per block, no residual
# ---------------------------------------------------------------------------
def _declare_block_topk(lib: ctypes.CDLL) -> None:
    lib.block_topk_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.block_topk_launch.restype = ctypes.c_int


def block_topk_library() -> BuiltLibrary:
    """Build (first call only) and load the top-1 kernel's library."""
    return build("block_topk", [BLOCK_TOPK_SOURCE],
                 configure=_declare_block_topk)


def block_topk(x: torch.Tensor, *, block_w: int = 128) -> torch.Tensor:
    """Keep the first max-|.| entry of every contiguous ``block_w`` run
    of x (any shape, the tail padded with zeros) and zero the rest;
    same shape and dtype. A run holding a NaN comes out all zeros."""
    if block_w < 1:
        raise ValueError(f"block_topk: block_w={block_w} must be >= 1")
    if x.device.type == "cpu":
        return block_topk_flat_ref(x, block_w=block_w)
    if x.device.type != "cuda":
        raise ValueError(f"block_topk: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_topk: dtype {x.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = block_topk_library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.block_topk_launch(
            x.data_ptr(), y.data_ptr(), x.numel(), block_w,
            int(x.dtype == torch.bfloat16), x.device.index, stream)
    check_launch("block_topk", code)
    BLOCK_TOPK_COUNTER.count += 1
    return y
