"""Data-index allocation — MLitB master-side data management (§3.3 a/b).

A copy of ``repro.core.allocator`` (pure Python): the port never imports
the JAX package, and identical code keeps every decision bit-equal.

The master tracks, per data index, (a) the worker the index is *allocated*
to (exactly one or none — allocation = who computes gradients on it) and
(b) the set of workers that have it *cached* (who has the bytes). New data
is balanced across workers; a new worker receives either unallocated data
or a slice carved from current holders by the *pie-cutter* algorithm, which
prefers indices the receiving worker already caches and otherwise carves
proportionally from the largest holders — "this prevents unnecessary data
transfers" (paper §3.3b). Lost workers' indices are re-allocated to workers
with spare capacity (preferring cache hits), else marked unallocated.

Per-worker capacity mirrors the paper's 3000-vector browser memory cap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

DEFAULT_CAPACITY = 3000


@dataclass
class WorkerAlloc:
    capacity: int = DEFAULT_CAPACITY
    allocated: Set[int] = field(default_factory=set)
    cached: Set[int] = field(default_factory=set)

    @property
    def spare(self) -> int:
        return self.capacity - len(self.allocated)


class DataAllocator:
    def __init__(self):
        self.workers: Dict[str, WorkerAlloc] = {}
        self.owner: Dict[int, Optional[str]] = {}   # index -> allocated worker
        self.unallocated: Set[int] = set()
        self.transfers: int = 0                      # indices moved to a worker
                                                     # that had NOT cached them

    # ------------------------------------------------------------------
    @property
    def n_indices(self) -> int:
        return len(self.owner)

    def allocation_counts(self) -> Dict[str, int]:
        return {w: len(a.allocated) for w, a in self.workers.items()}

    def _assign(self, idx: int, w: str) -> None:
        prev = self.owner.get(idx)
        if prev is not None and prev in self.workers:
            self.workers[prev].allocated.discard(idx)
        self.owner[idx] = w
        self.unallocated.discard(idx)
        wa = self.workers[w]
        wa.allocated.add(idx)
        if idx not in wa.cached:
            self.transfers += 1
            wa.cached.add(idx)

    def _unassign(self, idx: int) -> None:
        prev = self.owner.get(idx)
        if prev is not None and prev in self.workers:
            self.workers[prev].allocated.discard(idx)
        self.owner[idx] = None
        self.unallocated.add(idx)

    # ------------------------------------------------------------------
    # (a) new data uploading and allocation
    # ------------------------------------------------------------------
    def add_data(self, indices: Sequence[int]) -> None:
        for i in indices:
            if i not in self.owner:
                self.owner[i] = None
                self.unallocated.add(i)
        self._drain_unallocated()

    def _drain_unallocated(self) -> None:
        """Hand unallocated indices to workers, least-loaded first."""
        if not self.workers:
            return
        pool = sorted(self.unallocated)
        for idx in pool:
            best = None
            for w, wa in self.workers.items():
                if wa.spare <= 0:
                    continue
                if best is None or len(wa.allocated) < len(
                        self.workers[best].allocated):
                    best = w
            if best is None:
                break
            self._assign(idx, best)

    # ------------------------------------------------------------------
    # (b) new client trainer initialization and data allocation
    # ------------------------------------------------------------------
    def add_worker(self, w: str, capacity: int = DEFAULT_CAPACITY) -> None:
        if w in self.workers:
            raise ValueError(f"worker {w!r} already registered")
        self.workers[w] = WorkerAlloc(capacity=capacity)
        if self.unallocated:
            self._drain_unallocated()
        if self.workers[w].spare > 0 and self.n_indices:
            self._pie_cut(w)

    def _pie_cut(self, new_w: str) -> None:
        """Carve a balanced share for ``new_w`` from current holders."""
        n_alloc = sum(len(a.allocated) for a in self.workers.values())
        target = min(n_alloc // len(self.workers),
                     self.workers[new_w].capacity)
        need = target - len(self.workers[new_w].allocated)
        if need <= 0:
            return
        # 1) indices the new worker already caches move free of transfer
        # cost (sorted: set iteration order depends on insertion history,
        # which a TrainState resume cannot reproduce)
        cached_here = sorted(i for i in self.workers[new_w].cached
                             if self.owner.get(i) not in (None, new_w))
        for idx in cached_here[:need]:
            self._assign(idx, new_w)
            need -= 1
        # 2) carve from the largest holders, round-robin, biggest slice first
        while need > 0:
            donors = sorted(
                (ww for ww in self.workers if ww != new_w
                 and len(self.workers[ww].allocated) >
                 len(self.workers[new_w].allocated) + 1),
                key=lambda ww: -len(self.workers[ww].allocated))
            if not donors:
                break
            for d in donors:
                if need <= 0:
                    break
                # min(): deterministic under resume, unlike raw set order
                idx = min(self.workers[d].allocated)
                self._assign(idx, new_w)
                need -= 1

    # ------------------------------------------------------------------
    # lost-participant handling (paper §3.2: "re-allocation of data")
    # ------------------------------------------------------------------
    def remove_worker(self, w: str) -> List[int]:
        if w not in self.workers:
            return []
        orphans = sorted(self.workers[w].allocated)
        del self.workers[w]
        for idx in orphans:
            self.owner[idx] = None
            self.unallocated.add(idx)
        # prefer workers that already cache the orphan
        for idx in list(orphans):
            holders = [ww for ww, wa in self.workers.items()
                       if idx in wa.cached and wa.spare > 0]
            if holders:
                best = min(holders,
                           key=lambda ww: len(self.workers[ww].allocated))
                self._assign(idx, best)
        self._drain_unallocated()
        return orphans

    # ------------------------------------------------------------------
    # TrainState snapshot (docs/elastic_training.md). Worker dict ORDER is
    # part of the state: tie-breaks in _drain_unallocated follow it.
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        return {
            "workers": {w: {"capacity": a.capacity,
                            "allocated": sorted(a.allocated),
                            "cached": sorted(a.cached)}
                        for w, a in self.workers.items()},
            "owner": [[int(i), o] for i, o in sorted(self.owner.items())],
            "unallocated": sorted(self.unallocated),
            "transfers": self.transfers,
        }

    def load_state_dict(self, st) -> None:
        self.workers = {
            w: WorkerAlloc(capacity=int(d["capacity"]),
                           allocated=set(int(i) for i in d["allocated"]),
                           cached=set(int(i) for i in d["cached"]))
            for w, d in st["workers"].items()}
        self.owner = {int(i): o for i, o in st["owner"]}
        self.unallocated = set(int(i) for i in st["unallocated"])
        self.transfers = int(st["transfers"])

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        seen: Set[int] = set()
        for w, wa in self.workers.items():
            assert len(wa.allocated) <= wa.capacity, f"{w} over capacity"
            assert wa.allocated <= wa.cached, f"{w} allocated w/o cache"
            for idx in wa.allocated:
                assert self.owner[idx] == w
                assert idx not in seen, f"index {idx} double-allocated"
                seen.add(idx)
        for idx in self.unallocated:
            assert self.owner[idx] is None
        assert seen | self.unallocated == set(self.owner), "index leak"
