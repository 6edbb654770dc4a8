"""Plain PyTorch version of the paged flash-decode kernel.

A port of ``repro.kernels.flash_decode.ref.flash_decode_ref``: it
materializes the gather the kernel avoids — clamp the page map, gather
pages into a ``(B, P*ps, K, D)`` linear view — and runs masked softmax
attention in float32. Rows with no valid key (dead rows) return exact
zeros, as the kernel's ``max(l, 1e-30)`` denominator gives them. The CPU
path of ``ops.flash_decode`` and the comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, kpool: torch.Tensor,
                     vpool: torch.Tensor, page_map: torch.Tensor,
                     pos: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); kpool/vpool: (N,ps,K,D); page_map: (B,P) int with
    entries >= N meaning 'no page'; pos: (B,) last valid position per
    row; live: (B,) int/bool row mask -> (B,H,D) in q's dtype."""
    B, H, D = q.shape
    N, ps, K, _ = kpool.shape
    P = page_map.shape[1]
    G = H // K
    page_map = page_map.long()
    pm = page_map.clamp(0, N - 1)
    k = kpool[pm].reshape(B, P * ps, K, D).float()
    v = vpool[pm].reshape(B, P * ps, K, D).float()
    t = torch.arange(P * ps, device=q.device)
    page_ok = (page_map < N).repeat_interleave(ps, dim=1)       # (B, P*ps)
    valid = (t[None, :] <= pos.long()[:, None]) & page_ok \
        & (live.long() != 0)[:, None]
    qf = q.float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k) * (D ** -0.5)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    any_valid = valid.any(dim=-1)                                # (B,)
    o = torch.where(any_valid[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, H, D).to(q.dtype)
