"""Full-sequence attention for the training forward, with its backward
pass: ``attention_train`` is one ``torch.autograd.Function``.

q (B, S, H, D), k / v (B, T, K, D) -> (B, S, H, D), the model's own
layouts (``models/attention.py``), read and written in place by strides.
Scale ``D**-0.5``; causal (key t <= query s) and sliding-window (t > s -
window) masks by index, both aligned at 0; GQA h -> h // (H // K).

The tensors must be on CUDA: the forward launches ``flash_attention.cu``'s
training entry point, built with nvcc at first use into a library of its
own (the float32 forward and the two backward kernels only, so the build
stays short), which writes each query row's log-sum-exp L besides O; the
backward launches a dQ kernel (which first writes Delta = rowsum(dO O))
and a dK/dV kernel, which recompute P = exp(scale S - L) tile by tile, so
no S x T tensor reaches device memory, and sum in a fixed order (no
atomics): a seed repeats bit for bit. A build or launch failure raises.
A query row with no valid key gives zeros (``grouped_attend`` attends
uniformly there); ``route`` takes no such call.

``route`` decides from what a call shows which path ``models.attention``
takes. Counters (``repro_torch.tracing``): the forward's launches on
``flash_attention`` (``ops.COUNTER``), the backward's two launches a call
on ``flash_attention.backward``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.flash_attention.ops import COUNTER, SOURCE
from repro_torch.kernels.runtime import launch_counter

BACKWARD = launch_counter("flash_attention.backward")
# widths the training kernels are built for (float32); others stay plain
TRAIN_HEAD_DIMS = (64,)


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_train_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.flash_attention_train_forward.restype = ctypes.c_int
    lib.flash_attention_train_backward.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
    lib.flash_attention_train_backward.restype = ctypes.c_int


def library() -> BuiltLibrary:
    """Build (first call only) and load the training kernels' library."""
    return build("flash_attention_train", [SOURCE], configure=_declare,
                 defines=("FLASH_ATTENTION_TRAIN_ONLY",))


def route(device: str, dtype: torch.dtype, head_dim: int, cross: bool,
          by_index: bool) -> str:
    """"fused" (``attention_train``) or "plain" (``grouped_attend``) for a
    training attention call: fused only for CUDA tensors in float32 at a
    built width, in self-attention (``cross`` False) whose positions are
    the forward's own index (``by_index``), so the kernels' masks by index
    are the call's."""
    ok = (device == "cuda" and dtype == torch.float32
          and head_dim in TRAIN_HEAD_DIMS and not cross and by_index)
    return "fused" if ok else "plain"


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: contiguous in its (B, S, H, D) layout
    (the model's tensors already are: no copy) with a 16-byte-aligned
    base."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _layout(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, position) element strides of a (B, S, H, D) tensor."""
    sb, ss, sh, _ = t.stride()
    return sb, sh, ss


@functools.lru_cache(maxsize=1024)
def _args(B: int, H: int, K: int, S: int, T: int, D: int, causal: bool,
          window: int, lq: Tuple[int, int, int],
          lkv: Tuple[int, int, int]):
    """The entry points' integer arguments (``flash_attention.cu``), kept
    alive here: their address is passed, not eight conversions a call."""
    return (ctypes.c_longlong * 14)(B, H, K, S, T, D, int(causal),
                                    int(window), *lq, *lkv)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check(q, k, v) -> None:
    if not (_on_card(q) and k.device == q.device and v.device == q.device):
        raise ValueError(f"attention_train: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}: the kernels need them "
                         f"on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention_train: q {tuple(q.shape)} must be "
                         f"(B,S,H,D) and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} the same (B,T,K,D)")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"attention_train: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree (need the same B "
                         f"and D, H % K == 0)")


def _forward_kernel(q, k, v, causal: bool, window: int):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if D not in TRAIN_HEAD_DIMS or q.dtype != torch.float32 \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_train: {q.dtype} at D={D}; the kernels "
                         f"are built for float32 at D in {TRAIN_HEAD_DIMS}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if min(B, S, H, T) == 0:
        return q, k, v, o.zero_(), lse.fill_(float("inf"))
    dev = q.get_device()
    code = library().lib.flash_attention_train_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), ctypes.addressof(_args(
            B, H, K, S, T, D, causal, window, _layout(q), _layout(k))),
        D ** -0.5, dev, torch._C._cuda_getCurrentRawStream(dev))
    check_launch("flash_attention_train_forward", code)
    COUNTER.count += 1
    return q, k, v, o, lse


def _backward_kernel(q, k, v, o, do, lse, causal: bool, window: int):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    do = _operand(do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    if min(B, S, H, T) == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dev = q.get_device()
    code = library().lib.flash_attention_train_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ctypes.addressof(_args(
            B, H, K, S, T, D, causal, window, _layout(q), _layout(k))),
        D ** -0.5, dev, torch._C._cuda_getCurrentRawStream(dev))
    check_launch("flash_attention_train_backward", code)
    BACKWARD.count += 2
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v, o, lse = _forward_kernel(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward_kernel(q, k, v, o, do, lse, *ctx.mask)
        return dq, dk, dv, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D), k / v (B, T, K, D) -> (B, S, H, D) (module
    docstring), differentiable in q, k and v."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"attention_train: window={window} must be >= 0")
    return _AttentionTrain.apply(q, k, v, bool(causal), int(window))
