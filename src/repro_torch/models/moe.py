"""Mixture-of-Experts: GShard-style dispatch-combine MoE.

The PyTorch counterpart of ``repro.models.moe``. Expert weights are
stacked: w_gate/w_up (E, d, ff), w_down (E, ff, d); the router (d, E)
stays float32 in every model. Capacity is per batch row,
C = ceil(S * k / E * capacity_factor), from the row's PADDED length;
tokens past an expert's capacity are dropped (their combine weight is
zero, so the residual stream passes them through).

Exactness: the dispatch and combine tensors hold 0/1 and the gates, and
every (token, expert, slot) entry gets at most one term (a token's k
picks are distinct experts), so they are exact in any dtype and any
contraction order; the drop set is a function of the picks alone. The
router's top-k breaks ties by the lower expert index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order).

Inside a sharded step (``distributed/tensor_parallel.py``) the experts
are split over ``model``: the router and the dispatch / combine tensors
are computed whole on every rank, each rank runs its ``E/m`` experts
(its slice of the E axis), and the partial outputs are summed over
``model``; the gates go through ``copy_to_model``, so the router gets
its whole gradient on every rank. Under a batch split the load-balance
loss is global over the batch axes (``tensor_parallel.global_aux``).
Capacity is per row, so the drop set never depends on another rank's
rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import Init, f32

Params = Dict[str, Any]


def init_moe(init: Init, path: str, d: int, cfg: MoEConfig, dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    E, ff = cfg.n_experts, cfg.d_ff_expert
    s = d ** -0.5
    return {
        "router": init.normal(f"{path}/router", lead + (d, E), s,
                              torch.float32),
        "w_gate": init.normal(f"{path}/w_gate", lead + (E, d, ff), s, dtype),
        "w_up": init.normal(f"{path}/w_up", lead + (E, d, ff), s, dtype),
        "w_down": init.normal(f"{path}/w_down", lead + (E, ff, d),
                              ff ** -0.5, dtype),
    }


def capacity(seq: int, cfg: MoEConfig) -> int:
    return max(1, math.ceil(seq * cfg.experts_per_token * cfg.capacity_factor
                            / cfg.n_experts))


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (B,S,k) f32, expert_idx (B,S,k) int64, aux_loss
    scalar). The top-k is a stable descending sort: ties go to the lower
    expert index."""
    logits = f32(x) @ router_w
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.experts_per_token]
    gates = torch.gather(probs, -1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss over the top-1 assignment
    E = cfg.n_experts
    top1 = F.one_hot(idx[..., 0], E).float()
    if tp.batch_split():
        return gates, idx, tp.global_aux(probs, top1)
    me = probs.mean(dim=(0, 1))
    ce = top1.mean(dim=(0, 1))
    return gates, idx, E * torch.sum(me * ce)


def dispatch_combine(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                     cfg: MoEConfig, cap: int, dtype=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch (B,S,E,C) one-hot and combine (B,S,E,C) gate-weighted
    tensors, in the activation dtype. A (token, choice)'s slot is its
    place in its expert's queue, counted over the row's S*k choices in
    choice-major order; slots >= ``cap`` are dropped."""
    B, S, k = gates.shape
    E = cfg.n_experts
    dtype = dtype or x.dtype
    sel = F.one_hot(idx, E)                                 # (B,S,k,E) int
    flat = sel.reshape(B, S * k, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)
    pos = pos.reshape(B, S, k)
    keep = (pos < cap).to(dtype)
    # one-hot of the slot; a dropped choice's row is all zeros
    posc = (pos[..., None] == torch.arange(cap, device=x.device)).to(dtype)
    sel = sel.to(dtype)
    disp = torch.einsum("bske,bskc->bsec", sel * keep[..., None], posc)
    comb = torch.einsum("bske,bskc->bsec",
                        sel * (keep * gates.to(dtype))[..., None], posc)
    return disp, comb


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (B,E,C,d) -> (B,E,C,d), per-expert SwiGLU as three batched
    products over the expert axis."""
    B, E, C, d = xe.shape
    xs = xe.transpose(0, 1).reshape(E, B * C, d)
    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    return torch.bmm(h, p["w_down"]).reshape(E, B, C, d).transpose(0, 1)


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig,
            split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch-combine MoE layer. x: (B,S,d). Returns (y, aux).
    ``split``: ``p``'s experts are this rank's (module docstring)."""
    dt = x.dtype
    gates, idx, aux = route(p["router"], x, cfg)
    if split:
        gates, x = tp.copy_to_model(gates), tp.copy_to_model(x)
    disp, comb = dispatch_combine(x, gates, idx, cfg,
                                  capacity(x.shape[1], cfg))
    if split:
        e0, e1 = tp.local_experts(p["w_up"].shape[-3])
        disp, comb = disp[:, :, e0:e1], comb[:, :, e0:e1]
    xe = torch.einsum("bsec,bsd->becd", disp.to(dt), x)
    ye = expert_ffn(p, xe)
    y = torch.einsum("bsec,becd->bsd", comb.to(dt), ye)
    if split:
        y = tp.reduce_from_model(y)
    return y.to(dt), aux


def moe_ffn_sorted(p: Params, x: torch.Tensor, cfg: MoEConfig,
                   split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch with the same drop set as ``moe_ffn``: each
    row's choices are stably sorted by expert (a stable sort keeps the
    arrival order the einsum's cumsum counts) and scattered into (E, C)
    buckets; row ``E*cap`` of the bucket buffer takes every dropped
    choice and is never read, so which of them lands last there does
    not matter. The combine gathers each token's k weighted outputs
    back into choice order and sums them: the reference scatter-adds
    the same terms into zeros, which for k <= 2 is the same sum in
    either order, and this gather-sum stays deterministic for any k.
    ``split``: ``p``'s experts are this rank's; it runs their buckets
    and reads zeros for the other experts' choices."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    gates, idx, aux = route(p["router"], x, cfg)
    if split:
        gates, x = tp.copy_to_model(gates), tp.copy_to_model(x)
    cap = capacity(S, cfg)

    eidx = idx.reshape(B, S * k)                        # expert per choice
    gat = gates.reshape(B, S * k).to(dt)
    order = torch.sort(eidx, dim=1, stable=True).indices
    sorted_e = torch.gather(eidx, 1, order)
    counts = F.one_hot(eidx, E).sum(1)                  # (B,E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = torch.arange(S * k, device=x.device)[None, :] \
        - torch.gather(starts, 1, sorted_e)
    valid = pos_in_e < cap
    slot = torch.where(valid, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, E * cap))

    tok_idx = order // k                                # source token
    xs = torch.gather(x, 1, tok_idx[..., None].expand(-1, -1, d))
    buf = x.new_zeros(B, E * cap + 1, d)
    rows = torch.arange(B, device=x.device)[:, None]
    buf[rows, slot] = xs
    xe = buf[:, :E * cap].reshape(B, E, cap, d)
    if split:
        e0, e1 = tp.local_experts(p["w_up"].shape[-3])
        xe = xe[:, e0:e1]
        slot = slot - e0 * cap
        valid = valid & (sorted_e >= e0) & (sorted_e < e1)
    n = xe.shape[1] * cap
    ye = expert_ffn(p, xe).reshape(B, n, d)

    safe = slot.clamp(0, n - 1)
    y_sorted = torch.gather(ye, 1, safe[..., None].expand(-1, -1, d))
    y_sorted = torch.where(valid[..., None], y_sorted,
                           torch.zeros((), dtype=dt, device=x.device))
    contrib = y_sorted * torch.gather(gat, 1, order)[..., None]
    back = torch.argsort(order, dim=1)                  # choice -> sorted
    y = torch.gather(contrib, 1, back[..., None].expand(-1, -1, d))
    y = y.reshape(B, S, k, d).sum(2)
    return (tp.reduce_from_model(y) if split else y), aux


def moe_ffn_dense_ref(p: Params, x: torch.Tensor, cfg: MoEConfig
                      ) -> torch.Tensor:
    """Oracle: every expert on every token, combined by the gates; no
    capacity drops (tests at small shapes with generous capacity)."""
    gates, idx, _ = route(p["router"], x, cfg)
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    y_all = torch.einsum("bsef,efd->bsed", F.silu(g) * u, p["w_down"])
    sel = F.one_hot(idx, cfg.n_experts).to(x.dtype)         # (B,S,k,E)
    w = torch.einsum("bsk,bske->bse", gates.to(x.dtype), sel)
    return torch.einsum("bse,bsed->bsd", w, y_all)
