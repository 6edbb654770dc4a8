"""Synthetic datasets (copy of ``repro.data.datasets``; numpy only, so the
same seed gives bit-equal arrays on both sides).

``synthetic_mnist``: a learnable 10-class 28x28 image problem standing in
for the paper's MNIST runs: each class is a fixed smooth random template,
samples are template + noise + small shifts.

``synthetic_lm``: a Zipf-ish token stream with planted bigram structure so
LM training losses actually drop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_mnist(n: int, *, seed: int = 0, n_classes: int = 10,
                    hw: int = 28, template_seed: int = 1234,
                    noise: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` images (n, hw, hw, 1) float32 NHWC and their int32 labels."""
    rng = np.random.RandomState(seed)
    # smooth class templates: low-frequency random images. The template rng
    # is SEPARATE from the sample rng so train/test splits drawn with
    # different seeds share the same class structure.
    trng = np.random.RandomState(template_seed)
    freq = 4
    base = trng.randn(n_classes, freq, freq)
    templates = np.zeros((n_classes, hw, hw), np.float32)
    for c in range(n_classes):
        t = np.kron(base[c], np.ones((hw // freq, hw // freq)))
        templates[c] = t
    templates /= templates.std()
    labels = rng.randint(0, n_classes, size=n)
    shift = rng.randint(-2, 3, size=(n, 2))
    X = np.empty((n, hw, hw, 1), np.float32)
    for i in range(n):
        t = np.roll(templates[labels[i]], shift[i], axis=(0, 1))
        X[i, :, :, 0] = t + noise * rng.randn(hw, hw)
    return X, labels.astype(np.int32)


def synthetic_lm(n_tokens: int, vocab: int, *, seed: int = 0) -> np.ndarray:
    """A token stream whose transitions follow a planted successor map
    75% of the time."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, size=vocab)
    toks = np.empty(n_tokens, np.int64)
    toks[0] = rng.randint(vocab)
    jumps = rng.rand(n_tokens) < 0.25
    rand_toks = rng.randint(0, vocab, size=n_tokens)
    for i in range(1, n_tokens):
        toks[i] = rand_toks[i] if jumps[i] else succ[toks[i - 1]]
    return toks.astype(np.int32)
