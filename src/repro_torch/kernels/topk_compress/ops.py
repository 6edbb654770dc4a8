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
The fused kernel takes rows of any width; ``route`` names which of its
three kernels a (block_w, k) runs: ``warp`` (one warp per row, k rounds
in registers) up to ``WARP_BLOCK_W``; past it ``select`` (one block per
row: radix select of the threshold and one ordered emission, the row in
shared memory), ``select_in_place`` (the same with the row read back
from the residual, for rows past shared memory) or, when the k picks'
sort buffer does not fit beside the row, ``rounds`` (one block per row,
k barrier-bound rounds). ``ROUTE_COUNTERS`` count launches by route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Tuple

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import LaunchCounter, launch_counter
from repro_torch.kernels.topk_compress.ref import (
    block_topk_flat_ref, fused_block_topk_batched_ref)

SOURCE = Path(__file__).with_name("topk_compress.cu")
BLOCK_TOPK_SOURCE = Path(__file__).with_name("block_topk.cu")
COUNTER = launch_counter("fused_compress")
BLOCK_TOPK_COUNTER = launch_counter("block_topk")
# rows up to this width run one warp each (32 lanes x 16 registers); a
# wider row runs one block of threads (``topk_compress.cu``): past 512 the
# select kernel is the faster (``scripts/time_fused_compress.py``)
WARP_BLOCK_W = 512
_INDEX_LIMIT = 2 ** 31         # a worker's global indices are int32
# the kernel's routes, in the order of its ``Route`` codes
ROUTES = ("warp", "select", "select_in_place", "rounds")
ROUTE_COUNTERS = {name: LaunchCounter(f"fused_compress.{name}")
                  for name in ROUTES}
_SMEM_LIMIT = 232_448 - 1024   # a Hopper block's, less the static arrays
_HIST_BYTES = 4 * 4 * 256      # the select kernel's four 256-bin histograms


def smem_bytes(W: int, k: int, staged: bool) -> int:
    """The select kernel's dynamic shared memory (a copy of
    ``topk_compress.cu``'s ``select_smem_bytes``, checked against it when
    the library loads): staged, the row, W + 3 floats rounded up to 16
    bytes (none in place); 8 bytes per sort slot, min(k, W) rounded up to
    a power of two of at least 32; one histogram per digit pass."""
    slots = 32
    while slots < min(k, W):
        slots *= 2
    row = -(-4 * (W + 3) // 16) * 16 if staged else 0
    return row + 8 * slots + _HIST_BYTES


def route(W: int, k: int) -> str:
    """The kernel that runs rows of W with k picks (k <= W)."""
    if W <= WARP_BLOCK_W:
        return "warp"
    if smem_bytes(W, k, True) <= _SMEM_LIMIT:
        return "select"
    if smem_bytes(W, k, False) <= _SMEM_LIMIT:
        return "select_in_place"
    return "rounds"


def _declare(lib: ctypes.CDLL) -> None:
    lib.fused_compress_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.fused_compress_launch.restype = ctypes.c_int
    lib.fused_compress_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_compress_smem_bytes.restype = ctypes.c_longlong
    for W, k, staged in ((1025, 1, True), (2048, 16, True), (8192, 64, True),
                         (8192, 8192, True), (57_856, 3, False),
                         (1 << 20, 16_384, False)):
        got = lib.fused_compress_smem_bytes(W, k, int(staged))
        if got != smem_bytes(W, k, staged):
            raise RuntimeError(f"fused_compress: the select kernel needs "
                               f"{got} B of shared memory at W={W}, k={k}, "
                               f"staged={staged}; the wrapper reckons "
                               f"{smem_bytes(W, k, staged)}")


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
    if g.device.type == "cpu":
        return fused_block_topk_batched_ref(g, r, k=min(k, block_w),
                                            block_w=block_w)
    if g.device.type != "cuda":
        raise ValueError(f"fused_block_topk_batched: unsupported device "
                         f"{g.device}")
    return plan(_launch, g, r, k, block_w)


def plan(launch: Callable, g: torch.Tensor, r: torch.Tensor, k: int,
         block_w: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shape plan around ``launch(g, r, k, block_w, route)``: k
    clamped to the row, the route by (block_w, k) (``route``), and the one
    refusal, a worker's indices past int32. Rows of any width are one
    launch; the CPU tests drive it with the plain version."""
    n = g.shape[1]
    if -(-n // block_w) * block_w > _INDEX_LIMIT:
        raise ValueError(f"fused_block_topk_batched: {-(-n // block_w)} "
                         f"rows of {block_w} overflow a worker's int32 "
                         f"index space")
    k = min(k, block_w)
    return launch(g, r, k, block_w, route(block_w, k))


def _launch(g: torch.Tensor, r: torch.Tensor, k: int, block_w: int,
            route: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``route``'s kernel over every worker (the kernel
    refuses a route that does not take this (block_w, k))."""
    Wk, n = g.shape
    R = -(-n // block_w)
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
            res.data_ptr(), n, Wk, block_w, k, ROUTES.index(route),
            g.device.index, stream)
    check_launch("fused_compress", code)
    COUNTER.count += 1
    ROUTE_COUNTERS[route].count += 1
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
