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

``fused_compress_select_ref`` computes the same function by the method
of the select kernel (``topk_compress.cu``, rows past the warp path):
integer keys, a radix select of the threshold, ties to the lowest
columns, one ordered emission. The tests hold it against the rounds; no
path of the port calls it.

``fused_block_topk_batched_ref`` adds the JAX wrapper's arithmetic
(``repro/kernels/topk_compress/ops.py``): zero tail padding to a multiple
of ``block_w``, the worker axis folded into the row axis, global indices
``row * block_w + offset`` and the residual cut back to ``n``. It is the
CPU path of ``ops.fused_block_topk_batched`` and the comparison
``chip_smoke.py`` holds the CUDA kernel against, on any device.
"""
from __future__ import annotations

from typing import Callable, Tuple

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


# the select kernel's digits, from the key's top bit down: (shift, bits)
SELECT_DIGITS = ((23, 8), (15, 8), (7, 8), (0, 7))


def fused_compress_select_ref(g: torch.Tensor, r: torch.Tensor, k: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``fused_compress_ref``'s function by the select kernel's method.
    Per row, with key = bits(c) & 0x7fffffff (monotone in |c|):
    m = #(key > 0), k' = min(k, m) (0 in a row holding a NaN); the
    threshold T = the k'-th largest key by at most four radix digit
    passes over the nonzero keys, a pass ending the select when its
    bucket is taken whole; picks = key > T, then the lowest columns with
    key == T; the picks sorted by (key << 32 | ~column) descending and
    emitted as (c + 0.0, column); k - k' pads (+0.0, 0), and with a pad
    the residual's column 0 becomes +0.0."""
    R, W = g.shape
    k = min(k, W)
    c = g.float() + r.float()
    key = (c.view(torch.int32) & 0x7FFFFFFF).long()
    nan = torch.isnan(c).any(dim=1)
    m = (key != 0).sum(dim=1)
    kk = torch.where(nan, torch.zeros_like(m), m.clamp(max=k))
    # rows that select: 0 < k' < m; the rest take every nonzero (or none)
    done = (kk == 0) | (kk == m)
    thr = torch.zeros_like(m)
    need_eq = torch.zeros_like(m)
    prefix = torch.zeros_like(m)
    needed = kk.clone()
    hi_shift = 31
    for shift, bits in SELECT_DIGITS:
        match = ((key >> hi_shift) == prefix[:, None]) & (key != 0)
        digit = (key >> shift) & ((1 << bits) - 1)
        counts = torch.zeros(R, 256, dtype=torch.long,
                             device=c.device).scatter_add_(1, digit,
                                                           match.long())
        incl = counts.flip(1).cumsum(1).flip(1)       # keys in bins >= b
        lo = incl - counts                             # keys in bins > b
        want = needed[:, None]
        chosen = ((lo < want) & (want <= incl)).long().argmax(dim=1)
        above = lo.gather(1, chosen[:, None])[:, 0]
        cnt = counts.gather(1, chosen[:, None])[:, 0]
        live = ~done
        needed = torch.where(live, needed - above, needed)
        prefix = torch.where(live, (prefix << bits) | chosen, prefix)
        whole = live & (cnt == needed)
        thr = torch.where(whole, ((prefix << shift) - 1).clamp(min=0), thr)
        done = done | whole
        hi_shift = shift
    tied = ~done                        # all four passes: T = prefix
    thr = torch.where(tied, prefix, thr)
    need_eq = torch.where(tied, needed, need_eq)
    tie = (key == thr[:, None]) & tied[:, None]
    rank = tie.long().cumsum(dim=1) - 1               # lowest columns first
    pick = (key > thr[:, None]) | (tie & (rank < need_eq[:, None]))
    pick &= (kk > 0)[:, None]
    col = torch.arange(W, dtype=torch.long, device=c.device)[None, :]
    packed = torch.where(pick, (key << 32) | (0xFFFFFFFF - col),
                         torch.full_like(key, -1))
    order = packed.sort(dim=1, descending=True).values[:, :k]
    t = torch.arange(k, dtype=torch.long, device=c.device)[None, :]
    real = t < kk[:, None]
    pcol = torch.where(real, 0xFFFFFFFF - (order & 0xFFFFFFFF),
                       torch.zeros_like(order))
    vals = torch.where(real, c.gather(1, pcol) + 0.0,
                       torch.zeros(R, k, dtype=torch.float32, device=c.device))
    res = torch.where(pick, torch.zeros_like(c), c)
    pad0 = (kk < k) & ~nan
    res[:, 0] = torch.where(pad0, torch.zeros_like(res[:, 0]), res[:, 0])
    return vals, pcol.int(), res


def fused_block_topk_batched_ref(g: torch.Tensor, r: torch.Tensor, *, k: int,
                                 block_w: int,
                                 rows: Callable = fused_compress_ref
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """g, r: (Wk, n) per-worker flat buffers -> (values (Wk, R, k) f32,
    global indices (Wk, R, k) int32, residuals (Wk, n) f32), with
    R = ceil(n / block_w) and k clamped to block_w. ``rows`` computes the
    (R, W) rows: the rounds, or ``fused_compress_select_ref``."""
    Wk, n = g.shape
    k = min(k, block_w)
    pad = (-n) % block_w
    g = g.float()
    r = r.float()
    if pad:
        g = F.pad(g, (0, pad))
        r = F.pad(r, (0, pad))
    R = (n + pad) // block_w
    vals, offs, res = rows(g.reshape(Wk * R, block_w),
                           r.reshape(Wk * R, block_w), k)
    idx = (offs.reshape(Wk, R, k)
           + torch.arange(R, dtype=torch.int32,
                          device=g.device)[None, :, None] * block_w)
    return (vals.reshape(Wk, R, k), idx,
            res.reshape(Wk, R * block_w)[:, :n].contiguous())
