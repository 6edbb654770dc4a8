"""Plain PyTorch versions of the block-top-k kernels.

``block_topk_ref`` follows the Pallas body ``_topk_kernel`` (the top-1,
no-residual kernel): per (R, W) row, in fp32,

    best  = max |x|              (NaN if the row holds a NaN)
    first = lowest column with |x| >= best, else W (nothing kept)
    y     = x at column ``first``, +0.0 elsewhere, in x's dtype

So the first max wins, a row holding a NaN comes out all zeros, the kept
entry keeps its sign bit (an all-zero row keeps ``x[0]``, -0.0 included)
and ±inf is kept. The JAX package's numpy-style oracle
``block_topk_ref`` keeps the NaN instead; the port follows the kernel.
``block_topk_flat_ref`` adds the JAX wrapper's flattening and zero tail
padding.

The rest of this module is the fused error-feedback kernel's version.

``fused_compress_ref`` follows the Pallas body ``_fused_kernel``
(``repro/kernels/topk_compress/topk_compress.py``) step for step, not the
JAX package's numpy oracle ``fused_compress_ref``: the two differ on NaN.
Per (R, W) row, with ``c = g + r`` in fp32, ``k`` rounds of:

    best  = max |rem|            (NaN if the row holds a NaN)
    first = lowest column with |rem| >= best, else W (nothing selected)
    value = rem[first] (0.0 when nothing is selected), offset = first or 0
    rem[first] = 0

So ties go to the lowest index whatever the sign, an exhausted (all-zero)
row emits ``(0.0, 0)``, and a row holding a NaN selects nothing in every
round and keeps its whole ``c``, NaN included, as its residual.

``fused_block_topk_batched_ref`` adds the JAX wrapper's arithmetic
(``repro/kernels/topk_compress/ops.py``): zero tail padding to a multiple
of ``block_w``, the worker axis folded into the row axis, global indices
``row * block_w + offset`` and the residual cut back to ``n``. It is the
CPU path of ``ops.fused_block_topk_batched`` and the comparison
``chip_smoke.py`` holds the CUDA kernel against, on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def block_topk_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (R, W) -> keep the first max-|.| entry of each row, zeros
    elsewhere, in x's dtype; a row holding a NaN is all zeros."""
    R, W = x.shape
    mag = x.float().abs()
    best = torch.amax(mag, dim=1, keepdim=True)             # NaN propagates
    col = torch.arange(W, dtype=torch.int32, device=x.device)[None, :]
    first = torch.where(mag >= best, col,
                        torch.full_like(col, W)).amin(dim=1, keepdim=True)
    return torch.where(col == first, x, torch.zeros_like(x))


def block_topk_flat_ref(x: torch.Tensor, *, block_w: int) -> torch.Tensor:
    """Any shape: flatten, zero-pad to a multiple of ``block_w``, keep
    one entry per ``block_w`` run, cut back and restore the shape."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % block_w
    if pad:
        flat = F.pad(flat, (0, pad))
    y = block_topk_ref(flat.reshape(-1, block_w))
    return y.reshape(-1)[:n].reshape(x.shape)


def fused_compress_ref(g: torch.Tensor, r: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g, r: (R, W) -> (values (R, k) f32, offsets (R, k) int32,
    residual (R, W) f32); ``k >= 1`` is clamped to W."""
    R, W = g.shape
    k = min(k, W)
    c = g.float() + r.float()
    col = torch.arange(W, dtype=torch.int32, device=c.device)[None, :]
    rem = c
    vals, offs = [], []
    for _ in range(k):
        mag = rem.abs()
        best = torch.amax(mag, dim=1, keepdim=True)         # NaN propagates
        first = torch.where(mag >= best, col,
                            torch.full_like(col, W)).amin(dim=1,
                                                          keepdim=True)
        keep = col == first
        vals.append(torch.where(keep, rem, torch.zeros_like(rem)).sum(dim=1))
        offs.append(torch.where(first[:, 0] >= W, torch.zeros_like(first[:, 0]),
                                first[:, 0]))
        rem = torch.where(keep, torch.zeros_like(rem), rem)
    return torch.stack(vals, dim=1), torch.stack(offs, dim=1), rem


def fused_block_topk_batched_ref(g: torch.Tensor, r: torch.Tensor, *, k: int,
                                 block_w: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """g, r: (Wk, n) per-worker flat buffers -> (values (Wk, R, k) f32,
    global indices (Wk, R, k) int32, residuals (Wk, n) f32), with
    R = ceil(n / block_w) and k clamped to block_w."""
    Wk, n = g.shape
    k = min(k, block_w)
    pad = (-n) % block_w
    g = g.float()
    r = r.float()
    if pad:
        g = F.pad(g, (0, pad))
        r = F.pad(r, (0, pad))
    R = (n + pad) // block_w
    vals, offs, res = fused_compress_ref(g.reshape(Wk * R, block_w),
                                         r.reshape(Wk * R, block_w), k)
    idx = (offs.reshape(Wk, R, k)
           + torch.arange(R, dtype=torch.int32,
                          device=g.device)[None, :, None] * block_w)
    return (vals.reshape(Wk, R, k), idx,
            res.reshape(Wk, R * block_w)[:, :n].contiguous())
