"""Public wrapper of the flash attention kernel.

``flash_attention`` dispatches on the tensors' device: CPU tensors take
the plain PyTorch version (``ref.py``); CUDA tensors launch the
hand-written ``sm_90a`` kernel (``flash_attention.cu``), built with nvcc
at first use. A build or launch failure raises; nothing falls back to
the plain version on the card. ``COUNTER`` counts kernel launches (and
only those).

The JAX wrapper pads S and T to block multiples; here the kernel masks
the ragged edges itself, so nothing is copied, and keys past T never
enter the softmax (the JAX kernel lets zero-padded keys in when
``causal`` is off; ROADMAP D). ``block_q`` and ``block_k`` are the JAX
signature's tile sizes: the result does not depend on them, the plain
version has no tiles and the kernel picks its own. bfloat16 at D = 64
and 128 runs on wgmma: 128 query rows per CTA (a 64-row warpgroup
product each for two warpgroups) and key tiles of 128, loaded by TMA
into as many shared-memory stages as fit beside Q (3 at D = 128, 4 at
D = 64). The rest runs on mma.sync: 64 query rows per CTA (16 per warp,
the height of an mma tile) and key tiles of 64 keys for bf16 at D = 32,
32 keys for float32 and for D = 256, in a 2-stage cp.async ring. Both
products run on the tensor cores with float32 accumulation; float32
runs them in 3xTF32 (each operand split into two TF32 halves, three
products), which keeps float32 accuracy.

The kernel is built for D in ``HEAD_DIMS``, at most 65535 query heads
and batch rows (grid y and z). ``plan`` brings every other shape the
reference computes into that range by exact steps: a D below 256 is
zero-padded to the next built width (zero columns add nothing to Q K^T
or to P V; the scale stays the true D's and the padded output columns
are sliced off), and B or H past the grid are cut into pieces, each one
launch (a piece of query heads takes the KV heads its heads read). Only
D > 256 is refused.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.runtime import launch_counter

SOURCE = Path(__file__).with_name("flash_attention.cu")
COUNTER = launch_counter("flash_attention")
HEAD_DIMS = (32, 64, 128, 256)
_GRID_LIMIT = 65535            # grid y (heads) and z (batch rows)
_INDEX_LIMIT = 2 ** 31 - 1     # the kernel's (b * H + h) is an int


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("flash_attention", [SOURCE], configure=_declare)


def _check(q, k, v, window, block_q, block_k) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"(B,H,S,D) and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} the same (B,K,T,D)")
    B, H, S, D = q.shape
    Bk, K, T, Dk = k.shape
    if Bk != B or Dk != D or K < 1 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree (need the same B "
                         f"and D, H % K == 0)")
    if window < 0 or block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention: window={window}, block_q="
                         f"{block_q}, block_k={block_k} must be >= 0, >= 1, "
                         f">= 1")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")


def head_pieces(H: int, K: int, limit: int
                ) -> List[Tuple[int, int, int, int]]:
    """(h0, h1, kv0, kv1): query heads ``h0 .. h1-1`` of at most ``limit``
    per piece, each piece reading KV heads ``kv0 .. kv1-1`` with its
    head ``h0 + i`` on KV head ``kv0 + i // G'`` (G' = its heads over its
    KV heads), as the kernel maps them. Whole groups of G = H // K query
    heads where ``limit`` holds one, else slices of one group."""
    G = H // K
    if G <= limit:
        step = limit // G * G
        return [(h0, min(h0 + step, H), h0 // G, min(h0 + step, H) // G)
                for h0 in range(0, H, step)]
    return [(h0, min(h0 + limit, (kv + 1) * G), kv, kv + 1)
            for kv in range(K) for h0 in range(kv * G, (kv + 1) * G, limit)]


def plan(launch: Callable, q: torch.Tensor, k: torch.Tensor,
         v: torch.Tensor, causal: bool, window: int,
         limit: int = _GRID_LIMIT) -> torch.Tensor:
    """The shape plan (module docstring) around ``launch(q, k, v, causal,
    window, scale)``, which computes one piece at a built D; ``limit``
    is the grid's. The CPU tests drive it with the plain version."""
    B, H, S, D = q.shape
    K = k.shape[1]
    if min(B, H, S) == 0:
        return torch.empty_like(q)
    if D > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim D={D} is over "
                         f"{HEAD_DIMS[-1]}, the widest the kernel holds in "
                         f"registers; no config of the repo has one")
    scale = D ** -0.5
    width = next(w for w in HEAD_DIMS if w >= D)
    if width != D:
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    pieces = head_pieces(H, K, limit)
    bstep = max(1, min(limit, _INDEX_LIMIT // max(H, 1)))
    if len(pieces) == 1 and B <= bstep:
        out = launch(q, k, v, causal, window, scale)
    else:
        out = torch.cat([torch.cat([
            launch(q[b0:b0 + bstep, h0:h1], k[b0:b0 + bstep, kv0:kv1],
                   v[b0:b0 + bstep, kv0:kv1], causal, window, scale)
            for h0, h1, kv0, kv1 in pieces], dim=1)
            for b0 in range(0, B, bstep)])
    return out[..., :D] if width != D else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B,H,S,D), k/v: (B,K,T,D) -> (B,H,S,D) in q's dtype. Scale
    ``D**-0.5``; causal (key t <= query s) and sliding-window
    (t > s - window) masks by absolute positions; GQA h -> h // (H//K);
    rows with no valid key are exact zeros."""
    _check(q, k, v, window, block_q, block_k)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; the kernel takes float32 or bfloat16, "
                        f"all the same")
    return plan(_launch, q, k, v, causal, window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: float) -> torch.Tensor:
    """One kernel launch over a piece ``plan`` made."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or H > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"flash_attention: D={D}, H={H}, B={B}; a launch "
                         f"takes D in {HEAD_DIMS} and H, B <= {_GRID_LIMIT}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # rows are copied to shared memory in 16-byte pieces
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if S == 0 or B == 0 or H == 0:
        return out
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            K, S, T, D, int(bool(causal)), int(window), float(scale),
            int(q.dtype == torch.bfloat16), q.device.index, stream)
    check_launch("flash_attention", code)
    COUNTER.count += 1
    return out
