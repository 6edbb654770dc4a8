"""The reference's fleet: MLitB's reduce step (§3.3 c, §3.6) with a top-k
channel and error feedback, replayed over the iterations of a run.

Which workers replied, which rows each one computed, and which replies
missed the deadline are the program's own scheduling (its simulated
clock), so the reference follows them as recorded (``Iteration``); every
number is its own: each worker's gradient SUM and loss sum over its rows
at the reference's parameters, then, per reduce step, for each replying
worker w (in name order) c = g_w + r_w; an on-time worker sends the k
entries of c largest in magnitude (ties to the lower flat index; k =
frac x n), and keeps r_w = c with them zeroed; a late worker sends
nothing and keeps r_w = c. The step's gradient is the sum of what was
sent over the number of on-time rows (counted from the rows themselves,
not from the program's replies), and AdaGrad takes it. An iteration
whose every reply was late adds each gradient to its worker's residual
and takes no step.

The flat buffer holds the leaves in sorted key-path order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence

import torch

from perfbench import weights
from perfbench.reference.models import nll_sum
from perfbench.reference.numerics import Numerics
from perfbench.reference.train import Trace, change_norms, leaf_norms


@dataclass
class Iteration:
    kind: str                                   # "reduce" | "defer"
    rows: Dict[str, tuple] = field(default_factory=dict)  # w -> (X, y)
    late: FrozenSet[str] = frozenset()


def _order(p: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(p, key=lambda k: tuple(k.split("/")))


def follow_fleet(cfg: dict, seed: int, device: torch.device,
                 iterations: Sequence[Iteration], *, lr: float, eps: float,
                 frac: float, mode: str = "f32",
                 drop_half: bool = False) -> Trace:
    """Replays ``iterations``; ``drop_half`` leaves the second half of
    each reduce's on-time replies out (a fault: the mean over the rest)."""
    num = Numerics(mode, device)
    p0 = weights.make(cfg, seed, device)
    names = _order(p0)
    shapes = [p0[k].shape for k in names]
    sizes = [p0[k].numel() for k in names]
    flat = torch.cat([p0[k].reshape(-1) for k in names])
    start = flat.clone()
    n = flat.numel()
    k_keep = min(n, max(1, int(frac * n)))
    accum = torch.zeros_like(flat)
    residual: Dict[str, torch.Tensor] = {}
    out = Trace()

    def unflat(x):
        return {k: v.view(s) for k, v, s in
                zip(names, torch.split(x, sizes), shapes)}

    with num.active():
        for it in iterations:
            params = unflat(flat)
            grads, losses = {}, {}
            for w, (X, y) in sorted(it.rows.items()):
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}
                mask = torch.ones(X.shape, dtype=torch.float32,
                                  device=device)
                with torch.enable_grad():
                    loss = nll_sum(leaves, cfg, X.to(device), y.to(device),
                                   mask, num)
                    gs = torch.autograd.grad(loss.objective(),
                                             [leaves[k] for k in names])
                grads[w] = torch.cat([g.reshape(-1) for g in gs])
                losses[w] = float(loss.nll.detach())
            if it.kind == "defer":
                for w, g in grads.items():
                    residual[w] = residual.get(w, 0) + g
                continue
            on_time = [w for w in sorted(grads) if w not in it.late]
            if drop_half and len(on_time) > 1:
                on_time = on_time[:(len(on_time) + 1) // 2]
            total = torch.zeros_like(flat)
            for w in sorted(grads):
                c = grads[w] + residual[w] if w in residual else grads[w]
                if w in on_time:
                    idx = torch.sort(c.abs(), descending=True,
                                     stable=True).indices[:k_keep]
                    total.index_add_(0, idx, c[idx])
                    c = c.clone()
                    c[idx] = 0.0
                if w in on_time or w in it.late:
                    residual[w] = c
            count = float(sum(it.rows[w][0].shape[0] for w in on_time))
            g_bar = total / count
            out.losses.append(sum(losses[w] for w in on_time) / count)
            if len(out.losses) == 1:
                out.grad_norms = leaf_norms(unflat(g_bar))
            accum += g_bar * g_bar
            flat = flat - lr * g_bar / (torch.sqrt(accum) + eps)
    out.change_norms = change_norms(unflat(flat), unflat(start))
    return out
