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


def flash_decode_split_ref(q: torch.Tensor, kpool: torch.Tensor,
                           vpool: torch.Tensor, page_map: torch.Tensor,
                           pos: torch.Tensor, live: torch.Tensor,
                           split: int) -> torch.Tensor:
    """The CUDA kernel's partition and merge in plain PyTorch (for the
    tests): row b's key positions are cut into runs of ``split`` keys;
    each run that starts at or before ``pos[b]`` (of a live row) gives a
    partial (m, l, acc) of its valid keys, m = NEG_INF and l = 0 where it
    has none; the partials are merged in run order with the alpha guard,
    and ``max(l, 1e-30)`` makes a row with no key exact zeros."""
    B, H, D = q.shape
    N, ps, K, _ = kpool.shape
    P = page_map.shape[1]
    G = H // K
    L = P * ps
    S = -(-L // split)
    page_map = page_map.long()
    pm = page_map.clamp(0, N - 1)
    k = kpool[pm].reshape(B, L, K, D).float()
    v = vpool[pm].reshape(B, L, K, D).float()
    t = torch.arange(L, device=q.device)
    page_ok = (page_map < N).repeat_interleave(ps, dim=1)       # (B, L)
    valid = (t[None, :] <= pos.long()[:, None]) & page_ok \
        & (live.long() != 0)[:, None]
    s_all = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, K, G, D),
                         k) * (D ** -0.5)
    M = torch.full((B, K, G), NEG_INF, device=q.device)
    parts = []
    for sp in range(S):
        lo, hi = sp * split, min(L, (sp + 1) * split)
        ok = valid[:, lo:hi][:, None, None, :]                  # (B,1,1,n)
        s = torch.where(ok, s_all[..., lo:hi], torch.full_like(
            s_all[..., lo:hi], NEG_INF))
        m = s.max(dim=-1).values                                # (B,K,G)
        p = torch.where(ok, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        acc = torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi])
        run = (live.long() != 0) & (pos.long() >= lo)           # (B,)
        m = torch.where(run[:, None, None], m, torch.full_like(m, NEG_INF))
        parts.append((m, p.sum(dim=-1), acc))
        M = torch.maximum(M, m)
    Lsum = torch.zeros_like(M)
    o = torch.zeros(B, K, G, D, device=q.device)
    for m, l_s, acc in parts:                                   # run order
        w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                        torch.exp(m - M))
        Lsum = Lsum + w * l_s
        o = o + w[..., None] * acc
    o = o / Lsum.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, D).to(q.dtype)
