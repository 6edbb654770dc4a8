"""Generated traffic: the token data every cell trains on, from the seed.

Copies of the program's generators (``repro_torch.data.datasets.
synthetic_lm``, ``launch.train.data_stream``, ``core.simulation.
make_lm_problem``), so a later change to them cannot move the benchmark:
the program is handed only the arrays."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

NP_SEED_MOD = 2 ** 32


def synthetic_lm(n_tokens: int, vocab: int, seed: int) -> np.ndarray:
    """A token stream whose transitions follow a planted successor map
    75% of the time (int32): token i is a fresh draw where ``jumps[i]``,
    else the successor of token i - 1. The program's generator walks the
    stream in a Python loop; this one gives the same tokens from the same
    draws by raising the successor map to each token's distance from the
    last fresh draw, one bit of the distance at a time."""
    rng = np.random.RandomState(seed % NP_SEED_MOD)
    succ = rng.randint(0, vocab, size=vocab)
    first = rng.randint(vocab)
    jumps = rng.rand(n_tokens) < 0.25
    rand_toks = rng.randint(0, vocab, size=n_tokens)
    fresh = jumps.copy()
    fresh[0] = True
    at = np.arange(n_tokens)
    last = np.maximum.accumulate(np.where(fresh, at, 0))
    start = np.where(jumps, rand_toks, 0)
    start[0] = first
    toks = start[last]
    dist = at - last
    power = succ
    while dist.any():
        odd = (dist & 1).astype(bool)
        toks[odd] = power[toks[odd]]
        power = power[power]
        dist = dist >> 1
    return toks.astype(np.int32)


def lm_batches(vocab: int, batch: int, seq: int, n_tokens: int, seed: int
               ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless (batch, seq) next-token batches: windows at starts drawn
    uniformly from one ``synthetic_lm`` stream, as host int32 tensors
    (the program uploads them)."""
    toks = synthetic_lm(n_tokens, min(vocab, 65_536), seed)
    rng = np.random.RandomState((seed + 1) % NP_SEED_MOD)
    cols = np.arange(seq)
    while True:
        starts = rng.randint(0, len(toks) - seq - 1, size=batch)
        at = starts[:, None] + cols
        yield {"tokens": torch.from_numpy(toks[at]),
               "labels": torch.from_numpy(toks[at + 1])}


def lm_windows(vocab: int, n_data: int, seq: int, seed: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The fleet's data set: ``n_data`` windows of ``seq`` uniform random
    tokens (int32) and their one-step-shifted labels."""
    rng = np.random.RandomState(seed % NP_SEED_MOD)
    stream = rng.randint(0, vocab, size=n_data + seq).astype(np.int32)
    at = np.arange(n_data)[:, None] + np.arange(seq)
    return stream[at], stream[at + 1]
