"""Sharded data pipeline speaking the allocator's index protocol (a copy
of ``repro.data.pipeline``: numpy throughout, so the same seed and
allocator history give bit-equal batches in both packages).

The paper's data path: the master tracks (allocated, cached) index sets
per worker; workers pull *their* indices and batch locally within their
compute budget. This pipeline is the framework-side realization: it owns
a dataset (array-like or LM token stream), consults a DataAllocator for
per-worker index ownership, and emits GLOBAL batches + work masks laid
out so row-slice w of the batch contains only worker w's data — exactly
what ElasticMeshSGD's mask protocol and the weighted reduce expect.

Worker churn re-allocates indices (pie-cutter) without touching the
pipeline: the next batch simply draws from the new ownership map.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.allocator import DataAllocator


class ShardedBatchPipeline:
    """Classification-style (X, y) datasets (the paper's image use-case)."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 allocator: DataAllocator, *, seed: int = 0):
        if len(X) != len(y):
            raise ValueError(f"len(X)={len(X)} != len(y)={len(y)}")
        self.X, self.y = X, y
        self.allocator = allocator
        self.rng = np.random.RandomState(seed)
        if not allocator.n_indices:
            allocator.add_data(range(len(X)))

    def worker_batch(self, worker: str, n: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Up to n vectors from the worker's ALLOCATED indices (the paper's
        time-budgeted map step: fewer if the worker owns fewer)."""
        idx = sorted(self.allocator.workers[worker].allocated)
        if not idx:
            return self.X[:0], self.y[:0], 0
        take = self.rng.choice(len(idx), size=min(n, len(idx)),
                               replace=False)
        sel = np.asarray(idx)[take]
        return self.X[sel], self.y[sel], len(sel)

    def global_batch(self, rows_per_worker: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(X, y, mask) with contiguous per-worker row slices; short
        workers are zero-padded and masked out — the weighted reduce
        ignores them exactly like the master ignores a late client."""
        workers = sorted(self.allocator.workers)
        B = rows_per_worker * len(workers)
        Xb = np.zeros((B,) + self.X.shape[1:], self.X.dtype)
        yb = np.zeros((B,), self.y.dtype)
        mask = np.zeros((B,), np.float32)
        for i, w in enumerate(workers):
            xw, yw, n = self.worker_batch(w, rows_per_worker)
            lo = i * rows_per_worker
            Xb[lo:lo + n] = xw
            yb[lo:lo + n] = yw
            mask[lo:lo + n] = 1.0
        return Xb, yb, mask


class ShardedLMPipeline:
    """Token-stream datasets for the transformer zoo: each worker owns a
    set of document indices (fixed-length windows of the stream)."""

    def __init__(self, tokens: np.ndarray, seq_len: int,
                 allocator: DataAllocator, *, seed: int = 0):
        self.tokens = tokens
        self.seq_len = seq_len
        self.allocator = allocator
        self.n_windows = (len(tokens) - 1) // seq_len
        self.rng = np.random.RandomState(seed)
        if not allocator.n_indices:
            allocator.add_data(range(self.n_windows))

    def _window(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = i * self.seq_len
        return (self.tokens[lo:lo + self.seq_len],
                self.tokens[lo + 1:lo + self.seq_len + 1])

    def global_batch(self, rows_per_worker: int
                     ) -> Dict[str, np.ndarray]:
        workers = sorted(self.allocator.workers)
        B, S = rows_per_worker * len(workers), self.seq_len
        toks = np.zeros((B, S), np.int32)
        labs = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        for i, w in enumerate(workers):
            own = sorted(self.allocator.workers[w].allocated)
            if not own:
                continue
            take = self.rng.choice(len(own),
                                   size=min(rows_per_worker, len(own)),
                                   replace=False)
            for j, t in enumerate(take):
                x, y = self._window(own[t])
                r = i * rows_per_worker + j
                toks[r], labs[r] = x, y
                mask[r] = 1.0
        return {"tokens": toks, "labels": labs, "mask": mask}
