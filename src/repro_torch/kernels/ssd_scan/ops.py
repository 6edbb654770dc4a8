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

A launch takes hd in ``HEAD_DIMS``, N a multiple of 4, a chunk of at
most ``MAX_CHUNK`` whose kernels fit in a block's shared memory, and B
<= 65535 (grid z). ``plan`` brings every other shape the reference
computes into that range by exact steps: hd up to 128 is zero-padded to
the next built width and a wider hd cut into slices of 128 columns (a
column of y reads only its own column of x, beside the shared dt, B and
C); N is zero-padded to a multiple of 4 (zero B and C columns add
nothing); the chunk is the largest at most ``min(chunk, S, 128)`` that
fits (the chunked scan is the same function at any chunk length, as the
reference's dt = 0 padding relies on, so only rounding moves); where no
chunk of 16 or more fits the whole N, N is cut into slices of 256 whose
outputs add up (y is a sum over the state's columns); B past the grid
is cut into pieces. Nothing is refused.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.runtime import launch_counter
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SOURCE = Path(__file__).with_name("ssd_scan.cu")
COUNTER = launch_counter("ssd_scan")
HEAD_DIMS = (32, 64, 128)
MAX_CHUNK = 128
_SMEM_LIMIT = 232_448          # a Hopper block's dynamic shared memory
_GRID_LIMIT = 65535            # grid z (batch rows)
_N_SLICE = 256                 # fits at chunk 64 for every built hd
_MAX_GROUP = 8                 # the kernels' kMaxGroup and kWarps
_WARPS = 8


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
    for Q, N, hd in ((128, 128, 64), (128, 256, 32), (64, 256, 128),
                     (7, 4, 32), (100, 12, 128)):
        if lib.ssd_scan_smem_bytes(Q, N, hd) != smem_bytes(Q, N, hd):
            raise RuntimeError(f"ssd_scan: the kernels need "
                               f"{lib.ssd_scan_smem_bytes(Q, N, hd)} B of "
                               f"shared memory at chunk {Q}, N={N}, hd={hd}"
                               f"; the wrapper reckons {smem_bytes(Q, N, hd)}")


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("ssd_scan", [SOURCE], configure=_declare)


def smem_bytes(Q: int, N: int, hd: int) -> int:
    """Shared memory the largest of the kernels needs at chunk Q, state
    N and head dim hd: a copy of ``ssd_scan.cu``'s
    ``ssd_scan_smem_bytes`` (its ``geometry``, ``state_smem_bytes`` with
    x single-buffered and ``scan_smem_bytes`` unstaged), checked against
    it when the library loads."""
    Q16, N8 = -(-Q // 16) * 16, -(-N // 8) * 8
    pc = min(hd, 64)
    nbj = -(-Q16 // 32)
    slack = (-(-N8 // 64) * 64 - N8) * 128
    nbk = -(-max(N8, Q16) // 32)
    cbs = 8 * Q16 * (N8 + 4)
    heads = 1024 + 2 * nbj * N8 * 128 + slack + 4 * Q16 * (hd + 8) \
        + 4 * (3 * _MAX_GROUP * Q16 + _WARPS)
    nrt = Q16 // 16
    scan = 1024 + 2 * nbk * pc * 128 + 512 * nrt * (nrt + 1) + 8 * Q16
    return max(cbs, heads, scan)


def internal_chunk(Q: int, N: int, hd: int) -> Optional[int]:
    """The largest chunk at most ``min(Q, MAX_CHUNK)`` whose kernels fit
    in shared memory, going down by whole 16-row tiles; None where none
    of 16 rows or more (or Q itself, if smaller) fits."""
    q = min(Q, MAX_CHUNK)
    while smem_bytes(q, N, hd) > _SMEM_LIMIT:
        if q <= 16:
            return None
        q = (q - 1) // 16 * 16
    return q


def plan(launch: Callable, x: torch.Tensor, dt: torch.Tensor,
         A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
         limit: int = _GRID_LIMIT) -> torch.Tensor:
    """The shape plan (module docstring) around ``launch(x, dt, A, Bm,
    Cm, chunk)``, which computes one piece; ``limit`` is the grid's. The
    CPU tests drive it with the plain version."""
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if x.numel() == 0:
        return torch.empty_like(x)
    wide = HEAD_DIMS[-1]
    cols = [(c0, min(c0 + wide, hd)) for c0 in range(0, hd, wide)]
    widths = [next(w for w in HEAD_DIMS if w >= c1 - c0) for c0, c1 in cols]
    Np = max(4, N + (-N) % 4)
    nsl = Np
    q = internal_chunk(min(chunk, S), Np, max(widths))
    if q is None:
        nsl = _N_SLICE
        q = internal_chunk(min(chunk, S), nsl, max(widths))
    if Np != N:
        Bm, Cm = (F.pad(t, (0, Np - N)) for t in (Bm, Cm))
    if widths == [hd] and nsl == Np and B <= limit:
        return launch(x, dt, A, Bm, Cm, q)
    out = x.new_empty(B, S, nh, hd)
    for b0 in range(0, B, limit):
        b = slice(b0, b0 + limit)
        for (c0, c1), w in zip(cols, widths):
            xs = x[b, :, :, c0:c1]
            if w != c1 - c0:
                xs = F.pad(xs, (0, w - (c1 - c0)))
            y = sum(launch(xs, dt[b], A, Bm[b, :, n0:n0 + nsl],
                           Cm[b, :, n0:n0 + nsl], q).float()
                    for n0 in range(0, Np, nsl))
            out[b, :, :, c0:c1] = y[..., :c1 - c0]
    return out


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
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"ssd_scan: dtypes x={x.dtype} dt={dt.dtype} Bm="
                        f"{Bm.dtype} Cm={Cm.dtype}; the kernel takes float32 "
                        f"or bfloat16, all the same (A is float32)")
    return plan(_launch, x, dt, A, Bm, Cm, chunk)


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """One launch of the three kernels over a piece ``plan`` made, in
    chunks of ``min(chunk, S)`` steps."""
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if hd not in HEAD_DIMS or N % 4 or N < 4 or Q > MAX_CHUNK \
            or B > _GRID_LIMIT or smem_bytes(Q, N, hd) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: hd={hd}, N={N}, chunk {Q}, B={B}; a "
                         f"launch takes hd in {HEAD_DIMS}, N a multiple of "
                         f"4, a chunk of at most {MAX_CHUNK} within shared "
                         f"memory and B <= {_GRID_LIMIT}")
    x, dt, Bm, Cm = (t.contiguous() for t in (x, dt, Bm, Cm))
    A = A.float().contiguous()
    align = 4 * x.element_size()       # rows are read 4 elements at a time
    if any(t.data_ptr() % align for t in (x, Bm, Cm)):
        raise ValueError(f"ssd_scan: x, Bm, Cm must be {align}-byte "
                         f"aligned")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = library().lib
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
