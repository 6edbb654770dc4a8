"""The reference's training: the masked weighted reduce and AdaGrad, step
by step, and what a run's check compares.

A step's gradient is the sum of every worker's gradient SUM over its
masked-in tokens, divided by the global masked-in count (MLitB's
weighted average); AdaGrad (Duchi et al.) then takes

    G_t = G_{t-1} + g_t^2,   w_t = w_{t-1} - lr g_t / (sqrt(G_t) + eps).

``follow_mesh`` runs the first steps of a mesh cell from the seed's
weights on the batches the program was fed, a block of rows at a time.
``Trace`` is what both sides report: each step's loss, each leaf's norm
of the first gradient, and each leaf's norm of the parameters' change
after the last step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from perfbench import weights
from perfbench.reference.models import nll_sum
from perfbench.reference.numerics import Numerics


@dataclass
class Trace:
    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def change_norms(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm((now[k] - start[k]).double()))
            for k in start}


def adagrad(params: Dict[str, torch.Tensor], accum: Dict[str, torch.Tensor],
            grads: Dict[str, torch.Tensor], lr: float, eps: float) -> None:
    for k, g in grads.items():
        accum[k] += g * g
        params[k] -= lr * g / (torch.sqrt(accum[k]) + eps)


def grad_sums(params: Dict[str, torch.Tensor], cfg: dict,
              tokens: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              rows: int, num: Numerics):
    """(gradient sums, loss sum, count) over the batch, ``rows`` rows at
    a time."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    nll = torch.zeros((), dtype=torch.float64, device=tokens.device)
    count = torch.zeros((), dtype=torch.float64, device=tokens.device)
    names = list(leaves)
    for r in range(0, tokens.shape[0], rows):
        sl = slice(r, r + rows)
        if not bool(mask[sl].any()):
            continue
        with torch.enable_grad():
            loss = nll_sum(leaves, cfg, tokens[sl], labels[sl], mask[sl],
                           num)
            gs = torch.autograd.grad(loss.objective(),
                                     [leaves[k] for k in names],
                                     allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                total[k] += g
        nll += loss.nll.detach().double()
        count += loss.count.double()
    return total, nll, count


def follow_mesh(cfg: dict, seed: int, device: torch.device,
                batches: Sequence[Dict[str, torch.Tensor]], *, lr: float,
                eps: float, rows: int, mode: str = "f32",
                drop_half: bool = False) -> Trace:
    """The reference's first ``len(batches)`` steps. Every row is masked
    in (every worker live at its full budget); ``drop_half`` masks out
    the second half of the rows (a fault: the mean over the rest)."""
    num = Numerics(mode, device)
    p0 = weights.make(cfg, seed, device)
    params = {k: v.clone() for k, v in p0.items()}
    accum = {k: torch.zeros_like(v) for k, v in params.items()}
    out = Trace()
    with num.active():
        for t, b in enumerate(batches):
            tokens = b["tokens"].to(device)
            labels = b["labels"].to(device)
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=device)
            if drop_half:
                mask[tokens.shape[0] // 2:] = 0.0
            gsum, nll, count = grad_sums(params, cfg, tokens, labels, mask,
                                         rows, num)
            count = max(float(count), 1.0)
            grads = {k: g / count for k, g in gsum.items()}
            out.losses.append(float(nll) / count)
            if t == 0:
                out.grad_norms = leaf_norms(grads)
            adagrad(params, accum, grads, lr, eps)
            del gsum, grads
    out.change_norms = change_norms(params, p0)
    return out


def still_leaves(ref: Trace) -> set:
    """Leaves whose first gradient is under a thousandth of the median
    leaf's: nought to rounding, so AdaGrad moves them by round-off alone.
    They are left out of the change."""
    med = _median(list(ref.grad_norms.values()))
    return {k for k, v in ref.grad_norms.items() if v < 1e-3 * med}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leave_out: Optional[set] = None) -> List[float]:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    if set(prog) != set(ref) or not ref:
        return [float("inf")]
    med = _median(list(ref.values()))
    out = []
    for k in ref:
        if leave_out and k in leave_out:
            continue
        den = max(ref[k], med)
        g = abs(prog[k] - ref[k]) / den if den > 0 else \
            (0.0 if prog[k] == ref[k] else float("inf"))
        out.append(g if g == g else float("inf"))
    return out


def compare(prog: Trace, ref: Trace) -> Dict[str, float]:
    """Every number a training cell can be held to (its limits file
    names those it is): the worst step's loss gap and the first step's,
    the worst leaf's gap of the first gradient's norm and of the change's
    norm; and how many leaves the change leaves out (``still_leaves``)."""
    if len(prog.losses) != len(ref.losses) or not ref.losses:
        losses = [float("inf")]
    else:
        losses = [abs(a - b) / abs(b) if a == a else float("inf")
                  for a, b in zip(prog.losses, ref.losses)]
    still = still_leaves(ref)
    change = leaf_gaps(prog.change_norms, ref.change_norms, still)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(leaf_gaps(prog.grad_norms, ref.grad_norms)),
            "change_gap": max(change),
            "leaves_left_out": float(len(still))}


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
