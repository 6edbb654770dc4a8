"""Seeded open-loop request schedules (copy of
``repro.core.simulation.generate_requests``). Client latencies are drawn
from the training fleet's device profiles (``core/simulation.py``). The
same arguments and seed give a bit-equal schedule on both sides: every
draw comes from the same ``numpy.random.RandomState`` streams in the same
order.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.simulation import (LAPTOP, PHONE,
                                         WORKSTATION, DeviceProfile)
from repro_torch.serving.engine import ServeRequest


def generate_requests(n: int, *, rate_rps: float = 60.0,
                      vocab_size: int = 512,
                      prompt_rng: Tuple[int, int] = (8, 48),
                      gen_short: Tuple[int, int] = (4, 12),
                      gen_long: Tuple[int, int] = (96, 160),
                      long_frac: float = 0.3,
                      profiles: Tuple[DeviceProfile, ...] = (
                          WORKSTATION, LAPTOP, PHONE),
                      profile_weights: Tuple[float, ...] = (0.35, 0.4, 0.25),
                      burst: Optional[Tuple[float, float, float]] = None,
                      shared_prefix: Optional[Tuple[int, int, float]] = None,
                      seed: int = 0) -> List[ServeRequest]:
    """Seeded open-loop request schedule: Poisson arrivals at ``rate_rps``,
    uniform prompt lengths, a short/long generation mixture and
    per-request client latencies drawn from the device profiles.

    ``burst=(start_s, duration_s, rate_multiplier)`` raises the arrival
    rate inside ``[start, start+duration)``. ``shared_prefix=(n_prefixes,
    prefix_len, frac)`` prepends one of ``n_prefixes`` fixed system
    prompts to each request with probability ``frac``; those draws come
    from a separate derived RandomState, so ``shared_prefix=None`` leaves
    the main stream unchanged."""
    rng = np.random.RandomState(seed)
    w = np.asarray(profile_weights, float)
    w = w / w.sum()
    prefixes: List[np.ndarray] = []
    prng = None
    if shared_prefix is not None:
        n_pref, pref_len, pref_frac = shared_prefix
        prng = np.random.RandomState(seed + 100003)
        prefixes = [prng.randint(0, vocab_size, size=int(pref_len)).astype(
            np.int32) for _ in range(int(n_pref))]
    clock = 0.0
    out: List[ServeRequest] = []
    for rid in range(n):
        rate = rate_rps
        if burst is not None and burst[0] <= clock < burst[0] + burst[1]:
            rate = rate_rps * burst[2]
        clock += float(rng.exponential(1.0 / rate))
        p = int(rng.randint(prompt_rng[0], prompt_rng[1] + 1))
        if rng.rand() < long_frac:
            g = int(rng.randint(gen_long[0], gen_long[1] + 1))
        else:
            g = int(rng.randint(gen_short[0], gen_short[1] + 1))
        prof = profiles[int(rng.choice(len(profiles), p=w))]
        lat = prof.latency_mean * math.exp(prof.latency_jitter * rng.randn())
        prompt = rng.randint(0, vocab_size, size=p).astype(np.int32)
        if prefixes and prng.rand() < pref_frac:
            prompt = np.concatenate(
                [prefixes[int(prng.randint(len(prefixes)))], prompt])
        out.append(ServeRequest(
            rid=rid, prompt=prompt,
            max_new=g, arrival=clock, client_latency=float(lat)))
    return out
