"""Public wrapper of the paged flash-decode kernel.

``flash_decode`` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``ref.py``); CUDA tensors launch the hand-written
``sm_90a`` kernel (``flash_decode.cu``), built with nvcc at first use. A
build or launch failure raises; nothing falls back to the plain version
on the card. ``COUNTER`` counts kernel launches (and only those): one per
call, which runs the split pass and the combine.

How the work is cut: the kernel walks each row's key positions in tiles
of ``TILE_KEYS`` = 32, and a tile may span pages. The
positions ``0 .. P*ps-1`` of a row are split into runs of ``R`` keys, one
CTA per (split, kv head, row). ``R`` is the longest power-of-two multiple
of the tile for which ``B * K * ceil(P*ps / R)`` still reaches twice the
card's SM count (at the served shapes, B 16, K 4, P*ps 512 on 132 SMs:
R = 64, 8 splits, 512 CTAs), and the tile itself where none does. Each
split writes its (m, l, acc) partial to float32 scratch allocated here;
the combine merges a row's splits in split order. The wrapper runs once
per layer of every decode step on the host's clock, so the split length
is worked out once per shape and card (``_plan``), int32 inputs pass
through untouched, and the launch passes the card to C instead of
switching the current device around it.

A launch takes D a multiple of 4 up to 256 (a lane holds 2, 4 or 8 of
a row's values), at most ``_MAX_G`` query heads per KV head, whose split
pass fits in a block's shared memory, and B, K <= 65535 (grid y and z).
``plan`` brings every other shape the reference computes into that
range by exact steps: a D that is not a multiple of 4 is zero-padded
(the scale stays the true D's; the padded columns are sliced off); the
G query heads of each group are cut into pieces (``g_piece``) on a
``(B, K, G, D)`` view, each piece mapping its head h' to KV head h' //
g'; B and K past the grid are cut into pieces. Only D > 256 is refused.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import BuiltLibrary, build, check_launch
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.runtime import launch_counter

SOURCE = Path(__file__).with_name("flash_decode.cu")
COUNTER = launch_counter("flash_decode")
_MAX_G = 32                    # query heads per kv head the kernel takes
MAX_D = 256                    # 8 values a lane
TILE_KEYS = 32                 # the kernel's kTK; checked when it loads
_GRID_LIMIT = 65535            # grid y (kv heads) and z (batch rows)
_SMEM_LIMIT = 232_448          # a Hopper block's dynamic shared memory


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    for G, D, esize in ((1, 4, 4), (8, 256, 4), (27, 256, 4), (32, 128, 2)):
        if lib.flash_decode_smem_bytes(G, D, esize) != smem_bytes(G, D,
                                                                  esize):
            raise RuntimeError(f"flash_decode: the kernel's split pass "
                               f"needs {lib.flash_decode_smem_bytes(G, D, esize)}"
                               f" B of shared memory at G={G}, D={D}, the "
                               f"wrapper reckons {smem_bytes(G, D, esize)}")
    lib.flash_decode_tile_keys.argtypes = []
    lib.flash_decode_tile_keys.restype = ctypes.c_int
    if lib.flash_decode_tile_keys() != TILE_KEYS:
        raise RuntimeError(f"flash_decode: the kernel's tile is "
                           f"{lib.flash_decode_tile_keys()} keys, the "
                           f"wrapper's {TILE_KEYS}")


def library() -> BuiltLibrary:
    """Build (first call only) and load the kernel's shared library."""
    return build("flash_decode", [SOURCE], configure=_declare)


def split_keys(B: int, K: int, n_keys: int, sms: int, tile: int) -> int:
    """Keys per split: the longest power-of-two multiple of ``tile`` that
    still gives ``B*K*splits >= 2*sms`` CTAs over ``n_keys`` positions,
    else ``tile``."""
    R = tile
    while R < n_keys and B * K * -(-n_keys // (2 * R)) >= 2 * sms:
        R *= 2
    return R


def smem_bytes(G: int, D: int, esize: int) -> int:
    """The split pass's shared memory at G query heads per KV head (a
    copy of ``flash_decode.cu``'s ``smem_bytes``, checked against it when
    the library loads): q in f32, the 3-stage K/V ring of 32 rows padded
    by 16 bytes, the warps' scores and the keys' valid flags."""
    gw = next(w for w in (1, 2, 4, 8) if G <= 4 * w)
    return 4 * G * D + 3 * 2 * TILE_KEYS * (D * esize + 16) \
        + 4 * 4 * gw * TILE_KEYS + 3 * TILE_KEYS


@functools.lru_cache(maxsize=None)
def g_piece(G: int, D: int, esize: int) -> int:
    """Query heads per KV head in one launch: G cut into the fewest
    equal pieces of at most ``_MAX_G`` whose split pass fits."""
    most = min(G, _MAX_G)
    while most > 1 and smem_bytes(most, D, esize) > _SMEM_LIMIT:
        most -= 1
    n = -(-G // most)
    return -(-G // n)


def plan(launch: Callable, q: torch.Tensor, kpool: torch.Tensor,
         vpool: torch.Tensor, page_map: torch.Tensor, pos: torch.Tensor,
         live: torch.Tensor, limit: int = _GRID_LIMIT,
         max_g: Optional[int] = None) -> torch.Tensor:
    """The shape plan (module docstring) around ``launch(q, kpool, vpool,
    page_map, pos, live, scale)``, which computes one piece; ``limit``
    is the grid's and ``max_g`` the query heads per KV head of a piece
    (default ``g_piece``'s). The CPU tests drive it with the plain
    version."""
    B, H, D = q.shape
    K = kpool.shape[2]
    if D > MAX_D:
        raise ValueError(f"flash_decode: head_dim D={D} is over {MAX_D}, "
                         f"the most a warp's lanes hold (8 values each); no "
                         f"config of the repo has one")
    scale = D ** -0.5
    G = H // K if K else 0
    gp = max_g or (g_piece(G, D + (-D) % 4, q.element_size()) if G else 1)
    if D % 4 == 0 and G <= gp and B <= limit and K <= limit:
        return launch(q, kpool, vpool, page_map, pos, live, scale)
    if D % 4:
        q, kpool, vpool = (F.pad(t, (0, (-D) % 4))
                           for t in (q, kpool, vpool))
    Dp = q.shape[-1]
    out = q.new_empty(B, K, G, Dp)
    qg = q.reshape(B, K, G, Dp)
    for k0 in range(0, K, limit):
        k1 = min(k0 + limit, K)
        kp, vp = kpool, vpool
        if (k0, k1) != (0, K):
            kp, vp = (t[:, :, k0:k1].contiguous() for t in (kpool, vpool))
        for b0 in range(0, B, limit):
            b1 = min(b0 + limit, B)
            for g0 in range(0, G, gp):
                g1 = min(g0 + gp, G)
                piece = qg[b0:b1, k0:k1, g0:g1].reshape(b1 - b0, -1, Dp)
                out[b0:b1, k0:k1, g0:g1] = launch(
                    piece, kp, vp, page_map[b0:b1], pos[b0:b1],
                    live[b0:b1], scale).reshape(b1 - b0, k1 - k0, g1 - g0,
                                                Dp)
    return out.reshape(B, H, Dp)[..., :D]


@functools.lru_cache(maxsize=None)
def _plan(B: int, K: int, n_keys: int, index: int) -> int:
    """Keys per split for this shape on card ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return split_keys(B, K, n_keys, sms, TILE_KEYS)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous int32; no dispatch when it already is (the
    engine's page maps and positions are)."""
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


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
    return plan(_launch, q, kpool, vpool, page_map, pos, live)


def _launch(q, kpool, vpool, page_map, pos, live,
            scale: Optional[float] = None,
            split: Optional[int] = None) -> torch.Tensor:
    """One kernel launch over a piece ``plan`` made (``scale`` defaults
    to ``D**-0.5``). ``split`` forces the keys per split (a multiple of
    the tile); ``chip_smoke.py`` uses it to hold one split and many
    splits against the plain version."""
    B, H, D = q.shape
    N, ps, K, _ = kpool.shape
    P = page_map.shape[1]
    # the kernel copies K/V rows in 8- or 16-byte pieces
    if D % 4 or D > MAX_D or kpool.data_ptr() % 8 or vpool.data_ptr() % 8:
        raise ValueError(f"flash_decode: a launch takes head_dim D={D} a "
                         f"multiple of 4 and <= {MAX_D}, and the pools "
                         f"8-byte aligned")
    if smem_bytes(H // K, D, q.element_size()) > _SMEM_LIMIT \
            or H // K > _MAX_G or B > _GRID_LIMIT or K > _GRID_LIMIT:
        raise ValueError(f"flash_decode: a launch takes G={H // K} query "
                         f"heads per kv head (at most {_MAX_G}, and its "
                         f"split pass within shared memory), B={B}, K={K} "
                         f"(at most {_GRID_LIMIT})")
    lib = library().lib
    dev = q.device.index
    R = split if split is not None else _plan(B, K, P * ps, dev)
    if R < TILE_KEYS or R % TILE_KEYS:
        raise ValueError(f"flash_decode: split={R} must be a positive "
                         f"multiple of the {TILE_KEYS}-key tile")
    S = -(-(P * ps) // R)
    q = q.contiguous()
    page_map, pos, live = _int32(page_map), _int32(pos), _int32(live)
    out = torch.empty_like(q)
    # float32 scratch for the splits' (m, l, acc) partials
    part = torch.empty(max(1, B * K * S * (H // K) * (D + 2)),
                       dtype=torch.float32, device=q.device)
    code = lib.flash_decode_launch(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_map.data_ptr(), pos.data_ptr(), live.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, H, K, D, N, ps, P, R,
        float(D ** -0.5 if scale is None else scale),
        int(q.dtype == torch.bfloat16), dev,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("flash_decode", code)
    COUNTER.count += 1
    return out
