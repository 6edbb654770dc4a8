"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_chunked_ref`` is the chunked form the Pallas body ``_ssd_kernel``
(``repro/kernels/ssd_scan/ssd_scan.py``) computes, one chunk of Q steps
at a time, all in float32: with ``cum`` the cumulative sum of
``dt * A[h]`` within the chunk,

    seg   = min(cum_i - cum_j, 0)            (clamped BEFORE exp)
    L     = exp(seg) where j <= i, else 0
    y     = (C B^T * L * dt_j) x + (C * exp(cum_i)) h^T
    h    <- h * exp(cum_Q) + sum_j dt_j exp(cum_Q - cum_j) x_j B_j^T

with the (hd, N) state h carried from chunk to chunk. ``ssd_scan_ref``
adds the JAX wrapper's arithmetic: chunks of ``min(chunk, S)`` steps, the
tail padded with dt = 0 steps (no decay, no input) and y cut back to S.
It is the CPU path of ``ops.ssd_scan`` and the comparison
``chip_smoke.py`` holds the CUDA kernel against. ``ssd_ref`` is the
sequential recurrence, a copy of ``repro.kernels.ssd_scan.ref.ssd_ref``:
the oracle both are tested against. ``ssd_scan_split_ref`` is the CUDA
kernel's partition (chunk states from zero, the state pass, then the scan
with C B^T shared by all heads), for the tests only.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x: (B,S,nh,hd), dt: (B,S,nh), A: (nh,), Bm/Cm: (B,S,N) ->
    (B,S,nh,hd) in x's dtype; one step at a time."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                       # (B, nh)
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                    ) -> torch.Tensor:
    """The Pallas body's chunked form; S % chunk == 0 (``ops.py``
    pads). Same shapes as ``ssd_ref``."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = chunk
    xf = x.float().reshape(Bsz, S // Q, Q, nh, hd)
    dtf = dt.float().reshape(Bsz, S // Q, Q, nh)
    Bf = Bm.float().reshape(Bsz, S // Q, Q, N)
    Cf = Cm.float().reshape(Bsz, S // Q, Q, N)
    Af = A.float()
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    h = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af, dim=1)                     # (B, Q, nh)
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)               # (B, Q, Q)
        seg = torch.clamp(cum[:, :, None, :] - cum[:, None, :, :], max=0.0)
        L = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
        M = CB[..., None] * L * dtc[:, None, :, :]              # (B,i,j,nh)
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        y = y + torch.einsum("bihn,bhpn->bihp",
                             Cc[:, :, None, :] * torch.exp(cum)[..., None], h)
        ys.append(y)
        last = cum[:, -1]                                       # (B, nh)
        w = dtc * torch.exp(last[:, None, :] - cum)             # (B, Q, nh)
        h = h * torch.exp(last)[:, :, None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xc * w[..., None], Bc)
    return torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd).to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                 ) -> torch.Tensor:
    """Any S: chunks of ``min(chunk, S)`` steps, the tail padded with
    dt = 0 steps, y cut back to S."""
    S = x.shape[1]
    if S == 0:
        return x.clone()
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=Q)[:, :S]


def ssd_scan_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                       mm: Callable = torch.matmul) -> torch.Tensor:
    """The CUDA kernel's partition in plain PyTorch (for the tests): per
    (b, chunk, head) the chunk state from zero, S_c = (x w)^T B with w_j =
    dt_j exp(cum_Q - cum_j); the state pass h_c = h_{c-1} exp(cum_Q) +
    S_{c-1} over chunks; then per (b, chunk) C B^T once for all heads
    and y = G x + exp(cum_i) (C h_c^T), G = C B^T * exp(min(cum_i -
    cum_j, 0)) * dt_j for j <= i. The four products go through ``mm``
    (the tests pass an emulation of the kernel's 3xTF32). Chunks of
    ``min(chunk, S)`` steps, the tail read as dt = 0 steps."""
    Bsz, S, nh, hd = x.shape
    if S == 0:
        return x.clone()
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    xc = xf.reshape(Bsz, nc, Q, nh, hd).permute(0, 1, 3, 2, 4)  # b c h Q hd
    dtc = dtf.reshape(Bsz, nc, Q, nh).permute(0, 1, 3, 2)       # b c h Q
    cum = torch.cumsum(dtc * A.float()[None, None, :, None], dim=-1)
    last = cum[..., -1:]                                        # b c h 1
    # (a) chunk states from zero: (b, c, h, hd, N)
    w = dtc * torch.exp(last - cum)
    Sc = mm((xc * w[..., None]).transpose(-1, -2), Bc[:, :, None])
    # (b) the state pass: the state entering each chunk
    h = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    hin = []
    for c in range(nc):
        hin.append(h)
        h = h * torch.exp(last[:, c])[..., None] + Sc[:, c]
    hin = torch.stack(hin, dim=1)
    # (c) the scan, C B^T once per (b, chunk)
    CB = mm(Cc, Bc.transpose(-1, -2))                           # b c Q Q
    seg = torch.clamp(cum[..., :, None] - cum[..., None, :], max=0.0)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    G = torch.where(causal, CB[:, :, None] * torch.exp(seg)
                    * dtc[..., None, :], torch.zeros_like(seg))
    y = torch.exp(cum)[..., None] * mm(Cc[:, :, None],
                                       hin.transpose(-1, -2)) + mm(G, xc)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * Q, nh, hd)[:, :S]
    return y.to(x.dtype)
