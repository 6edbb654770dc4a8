"""Public wrapper of the Mamba2 SSD chunked-scan kernel.

``ssd_scan`` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``ref.py::ssd_scan_ref``, the tail padded with
dt = 0 steps as the JAX wrapper pads it); CUDA tensors launch the
hand-written ``sm_90a`` kernel (``ssd_scan.cu``), built with nvcc at
first use, which reads the ragged tail in place. A build or launch
failure raises; nothing falls back to the plain version on the card.
One call is three kernels in stream order (chunk states and C B^T, the
state pass, the chunk scan); their intermediates live in one float32
workspace from PyTorch's caching allocator. ``COUNTER`` counts calls that
launched them (and only those).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import launch_counter
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SOURCE = Path(__file__).with_name("ssd_scan.cu")
COUNTER = launch_counter("ssd_scan")
HEAD_DIMS = (32, 64, 128)
MAX_CHUNK = 128
_SMEM_LIMIT = 232_448          # a Hopper block's dynamic shared memory
_GRID_LIMIT = 65535            # grid z (batch rows)


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_workspace_floats.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_scan_ctas.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.ssd_scan_ctas.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("ssd_scan", [SOURCE], configure=_declare)


def launch_ctas(B: int, S: int, nh: int, hd: int, N: int, chunk: int,
                device: int = 0) -> dict:
    """CTAs of the three kernels in a call's first window (chunk states
    with C B^T, state pass, chunk scan) and the number of windows, as the
    launch plans them on card ``device``."""
    ctas = (ctypes.c_longlong * 3)()
    windows = library().lib.ssd_scan_ctas(B, S, nh, hd, N, min(chunk, S),
                                          device, ctas)
    return {"chunk_state": ctas[0], "state_pass": ctas[1],
            "chunk_scan": ctas[2], "windows": windows}


def _check(x, dt, A, Bm, Cm, chunk) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} must be "
                         f"(B,S,nh,hd)")
    B, S, nh, hd = x.shape
    if tuple(dt.shape) != (B, S, nh) or tuple(A.shape) != (nh,) \
            or Bm.dim() != 3 or tuple(Bm.shape[:2]) != (B, S) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"agree (need (B,S,nh), (nh,), (B,S,N) twice)")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk={chunk} must be >= 1")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_scan: tensors on several devices")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> torch.Tensor:
    """x: (B,S,nh,hd), dt: (B,S,nh) post-softplus, A: (nh,) negative,
    Bm/Cm: (B,S,N) -> y (B,S,nh,hd) in x's dtype, in chunks of
    ``min(chunk, S)`` steps."""
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"ssd_scan: dtypes x={x.dtype} dt={dt.dtype} Bm="
                        f"{Bm.dtype} Cm={Cm.dtype}; the kernel takes float32 "
                        f"or bfloat16, all the same (A is float32)")
    if hd not in HEAD_DIMS or N % 4 or N < 4 or Q > MAX_CHUNK \
            or B > _GRID_LIMIT:
        raise ValueError(f"ssd_scan: hd={hd}, N={N}, chunk {Q}, B={B}; the "
                         f"kernel takes hd in {HEAD_DIMS}, N a multiple of "
                         f"4, a chunk of at most {MAX_CHUNK} and B <= "
                         f"{_GRID_LIMIT}")
    x, dt, Bm, Cm = (t.contiguous() for t in (x, dt, Bm, Cm))
    A = A.float().contiguous()
    align = 4 * x.element_size()       # rows are read 4 elements at a time
    if any(t.data_ptr() % align for t in (x, Bm, Cm)):
        raise ValueError(f"ssd_scan: x, Bm, Cm must be {align}-byte "
                         f"aligned")
    lib = library().lib
    smem = lib.ssd_scan_smem_bytes(Q, N, hd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {Q}, N={N}, hd={hd} need {smem} B "
                         f"of shared memory, over {_SMEM_LIMIT}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    ws = torch.empty(lib.ssd_scan_workspace_floats(B, S, nh, hd, N, Q),
                     dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), ws.data_ptr(), B, S, nh, hd, N, Q,
        int(x.dtype == torch.bfloat16), x.device.index, stream)
    check_launch("ssd_scan", code)
    COUNTER.count += 1
    return y
