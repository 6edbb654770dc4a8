"""Public wrapper of the 3xTF32 matrix-product kernel, and ``linear``, the
model step's float32 linear products.

``gemm(a, b)`` is ``a @ b`` for 2-D operands. ``route`` says how a
product runs, from its operands' device and dtype:

  "plain"     on the CPU (or the meta device): ``a @ b``, PyTorch's own
              product, so every CPU number stays what it was;
  "library"   CUDA tensors of another dtype (bf16 / f16 serving, MoE):
              ``torch.matmul``, already on the tensor cores;
  "kernel"    float32 CUDA tensors: one launch of ``gemm_3xtf32.cu``,
              built with nvcc at first use.

The kernel reads each operand in place where its rows or its columns are
contiguous with a 16-byte-aligned leading stride and base (``layout``);
any other float32 CUDA operand (a view 4 bytes off, an odd row length, a
broadcast gradient) is first copied into rows padded to 16 bytes
(``fit``), so every float32 product on the card runs the kernel. The
output is row-major. K is split across CTAs where the output tiles are
too few to fill the card (``plan``); the partials live in a workspace
from PyTorch's caching allocator and are summed in a fixed order, and a
per-device int32 ticket array (zeroed once, left zeroed by every launch)
finds each tile's last split. A build or launch failure raises.

``linear(x, w)``: x (..., K) @ w (K, N), w possibly a transposed view (the
tied head's ``table.t()``). Routed as the kernel, it is an autograd
function: the forward is one launch and finds both operands' layouts
once; the backward reuses them for dX = dY w^T and dW = x^T dY (written
in w's own layout), one launch each, only where a gradient is asked for.
Counter (``repro_torch.tracing``): ``gemm_3xtf32.launches`` per launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import launch_counter

SOURCE = Path(__file__).with_name("gemm_3xtf32.cu")
LAUNCHES = launch_counter("gemm_3xtf32.launches")
TILE_M = TILE_N = 128
TILE_K = 32
MAX_SPLITS = 16

Layout = Tuple[bool, int]          # (rows contiguous, leading stride)


def _declare(lib: ctypes.CDLL) -> None:
    lib.gemm_3xtf32_launch.argtypes = [ctypes.c_void_p] * 7
    lib.gemm_3xtf32_launch.restype = ctypes.c_int


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("gemm_3xtf32", [SOURCE], configure=_declare)


def layout(t: torch.Tensor) -> Optional[Layout]:
    """(rows contiguous, leading stride in elements) of a 2-D operand the
    kernel reads in place, or None: one of its strides must be 1 and the
    other a positive multiple of 4 (16-byte rows), its base 16-byte
    aligned. A dimension of size 1 takes whichever stride fits."""
    r, c = t.shape
    sr, sc = t.stride()
    if r == 1:
        sr = -(-c // 4) * 4 if sc == 1 else 1
    if c == 1:
        sc = -(-r // 4) * 4 if sr == 1 else 1
    if sc == 1:
        rows, ld = True, sr
    elif sr == 1:
        rows, ld = False, sc
    else:
        return None
    if ld <= 0 or ld % 4 or t.data_ptr() % 16:
        return None
    return rows, ld


def fit(t: torch.Tensor) -> Tuple[torch.Tensor, Layout]:
    """``t`` and its ``layout`` where the kernel reads it in place, else a
    row-major copy whose rows are padded to a multiple of 4 elements."""
    lt = layout(t)
    if lt is not None:
        return t, lt
    r, c = t.shape
    ld = max(4, -(-c // 4) * 4)
    out = t.new_empty((r, ld))[:, :c]
    out.copy_(t)
    return out, (True, ld)


def _flip(lt: Layout) -> Layout:
    """The layout of a transposed view of an operand laid out as ``lt``."""
    return not lt[0], lt[1]


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """How ``gemm(a, b)`` runs (module docstring): "plain", "library" or
    "kernel"."""
    if a.device.type != "cuda" or b.device.type != "cuda":
        return "plain"
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return "library"
    return "kernel"


def plan(M: int, N: int, K: int, sms: int) -> int:
    """Split-K depth for an M x N x K product on ``sms`` SMs: the depth
    whose waves of (tile, split) units take the least k-blocks, counting
    a unit's prologue and epilogue as 2 k-blocks and a split tile's
    partials written and summed as 1 + depth (the last CTA's trips to L2,
    one a split); every split non-empty."""
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    nk = -(-K // TILE_K)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, nk) + 1):
        kper = -(-nk // s)
        if (s - 1) * kper >= nk:
            continue
        cost = -(-tiles * s // sms) * (kper + 2) \
            + (1 + s if s > 1 else 0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=4096)
def _config(M: int, N: int, K: int, lda: int, ldb: int, trans: bool,
            a_rows: bool, b_rows: bool, dev: int):
    """(split depth, output tiles, the C entry point, the address of its
    integer arguments, kept alive here) of an M x N x K launch on card
    ``dev``: one CTA per SM at most."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = plan(M, N, K, sms)
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    args = (ctypes.c_longlong * 12)(
        M, N, K, lda, ldb, M if trans else N, int(trans), int(a_rows),
        int(not b_rows), S, min(tiles * S, sms), dev)
    return (S, tiles, library().lib.gemm_3xtf32_launch,
            ctypes.addressof(args), args)


_TICKETS: Dict[int, torch.Tensor] = {}


def _tickets(device: torch.device, dev: int, n: int) -> torch.Tensor:
    """The device's ticket array, at least n ints, zero between launches."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[dev] = t
    return t


def _product(like: torch.Tensor, M: int, N: int, K: int, pa: int,
             la: Layout, pb: int, lb: Layout) -> torch.Tensor:
    """One launch: C (M, N) = A (M, K) B (K, N), row-major, where A's data
    starts at ``pa`` laid out as ``la`` and B's at ``pb`` as ``lb`` (their
    ``layout``), on ``like``'s card. Where both operands' rows are
    contiguous, the kernel computes C^T = B^T A^T (both operands then
    K-contiguous as B, the cheaper split) and writes it transposed into
    C."""
    c = like.new_empty((M, N))
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    (a_rows, lda), (b_rows, ldb) = la, lb
    trans = a_rows and b_rows
    if trans:                      # A' = B^T (columns), B' = A^T (columns)
        pa, pb, M, N = pb, pa, N, M
        a_rows, b_rows, lda, ldb = False, False, ldb, lda
    dev = like.get_device()
    S, tiles, entry, args, _ = _config(M, N, K, lda, ldb, trans, a_rows,
                                       b_rows, dev)
    ws = tk = None
    if S > 1:
        ws = like.new_empty((tiles * S * TILE_M * TILE_N,))
        tk = _tickets(like.device, dev, tiles)
    code = entry(pa, pb, c.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if tk is None else tk.data_ptr(),
                 torch._C._cuda_getCurrentRawStream(dev), args)
    check_launch("gemm_3xtf32", code)
    LAUNCHES.count += 1
    return c


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), routed as ``route`` says; no autograd of its
    own (``linear`` is the differentiable entry point)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"are not (M, K) and (K, N)")
    if route(a, b) != "kernel":
        return a @ b
    (a, la), (b, lb) = fit(a), fit(b)
    (M, K), N = a.shape, b.shape[1]
    return _product(a, M, N, K, a.data_ptr(), la, b.data_ptr(), lb)


class _Linear(torch.autograd.Function):
    """x (M, K) @ w (K, N), x's leading dimensions flattened; the forward
    keeps both operands' layouts for the backward's two products."""

    @staticmethod
    def forward(ctx, x, w):
        x2, la = fit(x if x.dim() == 2 else x.reshape(-1, x.shape[-1]))
        w2, lb = fit(w)
        ctx.save_for_backward(x2, w2)
        ctx.layouts = la, lb
        ctx.lead = x.shape[:-1]
        (M, K), N = x2.shape, w2.shape[1]
        y = _product(x2, M, N, K, x2.data_ptr(), la, w2.data_ptr(), lb)
        return y if x.dim() == 2 else y.view(*ctx.lead, N)

    @staticmethod
    def backward(ctx, dy):
        x2, w2 = ctx.saved_tensors
        la, lb = ctx.layouts
        dy2, ld = fit(dy if dy.dim() == 2 else dy.reshape(-1, dy.shape[-1]))
        (M, K), N = x2.shape, w2.shape[1]
        px, pw, pd = x2.data_ptr(), w2.data_ptr(), dy2.data_ptr()
        dx = dw = None
        if ctx.needs_input_grad[0]:          # dY (M, N) w^T (N, K)
            dx = _product(dy2, M, K, N, pd, ld, pw, _flip(lb))
            if len(ctx.lead) != 1:
                dx = dx.view(*ctx.lead, K)
        if ctx.needs_input_grad[1]:
            # in w's layout: a transposed view (the tied head's table.t())
            # gets its gradient as the table's rows, dY^T x
            if lb[0]:
                dw = _product(x2, K, N, M, px, _flip(la), pd, ld)
            else:
                dw = _product(x2, N, K, M, pd, _flip(ld), px, la).t()
        return dx, dw


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N): the model step's linear product (module
    docstring); on the CPU exactly ``x @ w``."""
    if w.dim() != 2 or route(x, w) != "kernel":
        return x @ w
    return _Linear.apply(x, w)
