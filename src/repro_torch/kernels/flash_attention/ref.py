"""Plain PyTorch version of the flash attention kernel.

A port of ``repro.kernels.flash_attention.ref.attention_ref``: scores in
float32 for every (query, key) pair, scale ``D**-0.5``, the causal and
sliding-window masks by absolute positions (both aligned at position 0,
also when S != T), ``softmax`` over the keys and a second product with V.
GQA maps query head h to kv head ``h // (H // K)``. Rows with no valid
key return exact zeros, as the kernel's ``max(l, 1e-30)`` denominator
gives them. The CPU path of ``ops.flash_attention`` and the comparison
``chip_smoke.py`` holds the CUDA kernel against.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,D), k/v: (B,K,T,D) -> (B,H,S,D) in q's dtype; f32 math.
    ``scale`` (default ``D**-0.5``): the wrapper's shape plan passes the
    true D's when it has zero-padded D."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) * (
        D ** -0.5 if scale is None else scale)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    o = torch.where(mask.any(dim=-1)[:, None], o, torch.zeros_like(o))
    return o.reshape(B, H, S, D).to(q.dtype)
