"""Local SGD — the paper's asynchronous-update fix (§3.5 s.2); port of
``repro.core.local_sgd``.

MLitB proposes "asynchronous update rules (each slave computes for a
random amount of time, then sends updates), reducing the load of any one
master node process". The classical synchronous equivalent is LOCAL SGD /
FedAvg: every virtual worker takes H optimizer steps on its own shard
between reductions, cutting reduce/broadcast traffic by H while keeping a
single consistent model at round boundaries.

Properties:
  - H=1 with plain SGD is EXACTLY the paper's synchronized weighted
    reduce (average of one-step params == one step on the weighted mean
    gradient, by linearity);
  - heterogeneous per-worker sample counts weight the average, matching
    the master's reduce semantics;
  - communication per optimizer step drops by 1/H.

The JAX package maps workers with ``vmap`` and local steps with
``lax.scan``; here both are plain loops. The same H-steps-between-syncs
math is the OUTER tier of the two-tier hierarchy (core/hierarchy.py):
``communication_ratio(H)`` is its cross-region traffic ratio before
compression.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.flatbuf import flat_spec, tree_leaves, tree_map
from repro_torch.optim.base import Optimizer

PyTree = Any


def build_local_sgd_round(
        grad_fn: Callable[[PyTree, PyTree], Tuple[PyTree, Any]],
        optimizer: Optimizer):
    """grad_fn(params, microbatch) -> (mean-grad tree, n_samples).

    Returns round(params, batches) where ``batches`` is a nested dict
    whose leaves have leading dims (W, H, ...): W workers x H local
    steps.
    """

    def worker_update(params, worker_batches):
        opt_state = optimizer.init(params)
        p, ns = params, []
        H = tree_leaves(worker_batches)[0].shape[0]
        for h in range(H):
            mb = tree_map(lambda x: x[h], worker_batches)
            g, n = grad_fn(p, mb)
            p, opt_state = optimizer.update(p, g, opt_state)
            ns.append(torch.as_tensor(n, dtype=torch.float32))
        return p, torch.stack(ns).sum()

    def round_fn(params, batches):
        batches = tree_map(torch.as_tensor, batches)
        W = tree_leaves(batches)[0].shape[0]
        ps, ns = [], []
        for w in range(W):
            p, n = worker_update(params, tree_map(lambda x: x[w], batches))
            ps.append(p)
            ns.append(n)
        ns = torch.stack(ns)
        wt = ns / torch.clamp(ns.sum(), min=1.0)
        # weighted average over the flat buffer: one (W,) @ (W, n)
        # product instead of a per-leaf fan-out
        spec = flat_spec(params)
        stacked = torch.stack([spec.flatten(p) for p in ps])
        dev = stacked.device
        new_params = spec.unflatten(wt.to(dev) @ stacked)
        return new_params, {"samples": ns.sum(), "workers": W,
                            "comm_rounds": torch.tensor(1, dtype=torch.int32)}

    return round_fn


def communication_ratio(H: int) -> float:
    """Reduce+broadcast events per optimizer step vs synchronized SGD."""
    return 1.0 / H
