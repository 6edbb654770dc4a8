#!/usr/bin/env python3
"""How far two runs of the two-tier hierarchy part when their gradients
differ only in the last bits, on the CPU.

    PYTHONPATH=src python3 scripts/hier_flip_drift.py [--noise 1e-6]

Runs ``build_training``'s two-tier hierarchy at
``mlitb-lm-100m.reduced()`` (4 regions, H 4, top-k 0.25 gossip, AdaGrad
lr 0.003, region r1 parked before outer step 2 and rejoined before 3 —
``chip_smoke.py``'s ``[hier-small]`` schedule) twice on the CPU: once
as is, once with every worker gradient multiplied by ``1 + noise * z``
(z standard normal, seeded), the size of the card's rounding against the
CPU's. A top-k pick that such a difference flips moves its entry by a
whole AdaGrad step and changes the error feedback from then on, so the
params part much further than the losses. Prints, per region,
||a - b|| / ||b|| of the flat params, the largest entry difference and
how many entries differ by more than 1e-4, then the largest relative
loss difference of any iteration.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import get_config
from repro_torch.core import HierarchyConfig, TrainingConfig
from repro_torch.core.config import DeadlineConfig
from repro_torch.core.flatbuf import tree_map
from repro_torch.launch.train_serve import build_training

CHURN = {1: "leave", 2: "join"}


def run(cfg, outer: int, noise: float, seed: int):
    master, cluster, _ = build_training(
        cfg, training=TrainingConfig(
            T=0.5, deadline=DeadlineConfig(quantile=0.5),
            hierarchy=HierarchyConfig(n_regions=4, inner_steps=4,
                                      gossip=True, gossip_frac=0.25)),
        seed=0, lr=0.003, device="cpu")
    if noise:
        grad_fn = cluster.grad_fn
        gen = torch.Generator().manual_seed(seed)

        def perturbed(params, X, y):
            g, loss = grad_fn(params, X, y)
            return tree_map(lambda x: x * (1 + noise * torch.randn(
                x.shape, generator=gen)), g), loss

        cluster.grad_fn = perturbed
    while master.outer_step < outer:
        ev = CHURN.get(master.outer_step)
        if ev == "leave":
            master.leave_region("r1")
        elif ev == "join":
            master.join_region("r1")
        master.iteration()
    return master


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--outer", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = get_config("mlitb-lm-100m").reduced()
    a = run(cfg, args.outer, 0.0, args.seed)
    b = run(cfg, args.outer, args.noise, args.seed)
    for r in sorted(a.regions):
        x = a.regions[r].reducer.flat_params.double()
        y = b.regions[r].reducer.flat_params.double()
        d = (x - y).abs()
        print(f"{r}: ||a - b|| / ||b|| {float((x - y).norm() / y.norm()):.3e}"
              f", max |a - b| {float(d.max()):.3e}, "
              f"{int((d > 1e-4).sum())} of {x.numel()} entries apart by "
              f"more than 1e-4")
    rel = max(abs(p.loss - q.loss) / abs(q.loss)
              for r in a.regions
              for p, q in zip(a.regions[r].history, b.regions[r].history)
              if math.isfinite(q.loss))
    print(f"largest relative loss difference of any iteration: {rel:.3e} "
          f"(gradient noise {args.noise:g})")
    return 0


if __name__ == "__main__":
    main()
