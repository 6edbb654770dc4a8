"""Public wrapper of the paged flash-decode kernel.

``flash_decode`` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``ref.py``); CUDA tensors launch the hand-written
``sm_90a`` kernel (``flash_decode.cu``), built with nvcc at first use. A
build or launch failure raises; nothing falls back to the plain version
on the card. ``COUNTER`` counts kernel launches (and only those).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.runtime import launch_counter

SOURCE = Path(__file__).with_name("flash_decode.cu")
COUNTER = launch_counter("flash_decode")
# a launch gets 48 KB of shared memory without opting in to more
_SMEM_LIMIT = 48 * 1024


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("flash_decode", [SOURCE], configure=_declare)


def _check(q, kpool, vpool, page_map, pos, live) -> None:
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be (B,H,D) "
                         f"and kpool {tuple(kpool.shape)} (N,ps,K,D)")
    B, H, D = q.shape
    N, ps, K, Dk = kpool.shape
    if vpool.shape != kpool.shape or Dk != D or H % K:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, kpool "
                         f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)} "
                         f"do not agree (need H % K == 0, same D)")
    if page_map.dim() != 2 or page_map.shape[0] != B \
            or tuple(pos.shape) != (B,) or tuple(live.shape) != (B,):
        raise ValueError(f"flash_decode: page_map {tuple(page_map.shape)}, "
                         f"pos {tuple(pos.shape)}, live {tuple(live.shape)} "
                         f"must be (B,P), (B,), (B,) with B={B}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes q={q.dtype} kpool="
                        f"{kpool.dtype} vpool={vpool.dtype}; the kernel "
                        f"takes float32 or bfloat16, all the same")
    devs = {t.device for t in (q, kpool, vpool, page_map, pos, live)}
    if len(devs) != 1:
        raise ValueError(f"flash_decode: tensors on several devices "
                         f"{sorted(str(d) for d in devs)}")
    if not (kpool.is_contiguous() and vpool.is_contiguous()):
        raise ValueError("flash_decode: kpool/vpool must be contiguous "
                         "(one layer of the pool)")
    # the kernel reads K/V rows as 4-element vectors
    align = 4 * kpool.element_size()
    if D % 4 or D > 128 or kpool.data_ptr() % align \
            or vpool.data_ptr() % align:
        raise ValueError(f"flash_decode: head_dim D={D} must be a multiple "
                         f"of 4 and <= 128, and the pools {align}-byte "
                         f"aligned")


def flash_decode(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                 page_map: torch.Tensor, pos: torch.Tensor,
                 live: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); kpool/vpool: (N,ps,K,D); page_map: (B,P) int with
    entries >= N meaning 'no page'; pos: (B,) last valid position per
    row; live: (B,) row mask -> (B,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, kpool, vpool, page_map, pos, live)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check(q, kpool, vpool, page_map, pos, live)
    B, H, D = q.shape
    N, ps, K, _ = kpool.shape
    P = page_map.shape[1]
    lib = library().lib
    smem = lib.flash_decode_smem_bytes(H, K, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"flash_decode: G={H // K}, D={D} needs {smem} B "
                         f"of shared memory, over {_SMEM_LIMIT}")
    q = q.contiguous()
    page_map = page_map.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    live = live.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_decode_launch(
            q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            page_map.data_ptr(), pos.data_ptr(), live.data_ptr(),
            out.data_ptr(), B, H, K, D, N, ps, P, float(D ** -0.5),
            int(q.dtype == torch.bfloat16), q.device.index, stream)
    check_launch("flash_decode", code)
    COUNTER.count += 1
    return out
