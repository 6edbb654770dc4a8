"""Gossip averaging — the peer-to-peer direction MLitB names (§3.3: "we
believe that our framework opens the door to peer-to-peer or gossip
algorithms [Boyd et al., 2006]"); port of ``repro.core.gossip``.

Randomized pairwise averaging over worker-local parameter replicas: each
round, a random matching of workers averages their parameters (optionally
weighted by local sample counts). No master, no global barrier — the
variance of the replica ensemble contracts geometrically (Boyd et al.
Thm 3) and each worker keeps taking local SGD steps between exchanges.

A replica is one tensor (the hierarchy's flat buffers) or a nested dict
of tensors. The matching comes from the caller's
``numpy.random.RandomState``, so the pairs are the JAX package's exactly,
and the pair average is ``(wa * x + wb * y) / z`` in f32, in that order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.flatbuf import tree_leaves
from repro_torch.optim.base import leaf_map

PyTree = Any


def random_matching(n: int, rng: np.random.RandomState
                    ) -> List[Tuple[int, int]]:
    perm = rng.permutation(n)
    return [(int(perm[i]), int(perm[i + 1]))
            for i in range(0, n - 1, 2)]


def gossip_round(replicas: List[PyTree], rng: np.random.RandomState,
                 weights: Optional[Sequence[float]] = None) -> List[PyTree]:
    """One asynchronous-gossip round: pairwise (weighted) averaging over a
    random matching. Returns the new replica list (same length)."""
    out = list(replicas)
    w = list(weights) if weights is not None else [1.0] * len(replicas)
    for a, b in random_matching(len(replicas), rng):
        wa, wb = w[a], w[b]
        z = wa + wb
        if z <= 1e-12:
            # two idle replicas (regions that processed zero vectors this
            # outer step) carry no sample mass to weight by: fall back to
            # the unweighted average instead of dividing by ~0
            wa = wb = 1.0
            z = 2.0

        def avg(x, y):
            # a tensor divisor: the card divides by a host scalar as a
            # multiply by its reciprocal, which rounds differently
            zt = torch.tensor(z, dtype=torch.float32, device=x.device)
            return (wa * x.float() + wb * y.float()) / zt

        mean = leaf_map(avg, out[a], out[b])
        out[a] = leaf_map(lambda v, o: v.to(o.dtype), mean, out[a])
        out[b] = leaf_map(lambda v, o: v.to(o.dtype), mean, out[b])
    return out


def replica_spread(replicas: List[PyTree]) -> float:
    """Max pairwise L-inf distance — the consensus diagnostic."""
    flat = [torch.cat([x.reshape(-1).float() for x in
                       ([r] if isinstance(r, torch.Tensor)
                        else tree_leaves(r))])
            for r in replicas]
    spread = 0.0
    for i in range(len(flat)):
        for j in range(i + 1, len(flat)):
            spread = max(spread, float((flat[i] - flat[j]).abs().max()))
    return spread


def gossip_sgd(replicas: List[PyTree],
               local_step: Callable[[PyTree, int, int], PyTree],
               n_rounds: int, *, seed: int = 0,
               gossip_every: int = 1) -> List[PyTree]:
    """Interleave local steps with gossip rounds: the paper's fully
    decentralized regime. ``local_step(params, worker, round)``."""
    rng = np.random.RandomState(seed)
    for r in range(n_rounds):
        replicas = [local_step(p, i, r) for i, p in enumerate(replicas)]
        if (r + 1) % gossip_every == 0:
            replicas = gossip_round(replicas, rng)
    return replicas
