"""Latency monitoring + adaptive work scheduling — MLitB §3.3(d).

A copy of ``repro.core.scheduler`` (pure Python): the port never imports
the JAX package, and identical code keeps every decision bit-equal.

"At each reduce step, the master node estimates the latency between the
client and the master and informs the client worker how long it should run
for. A client does not need to have a batch size because it just clocks its
own computation and returns results at the end of its scheduled work time."

The master keeps EWMA estimates of each worker's round-trip latency,
power (vectors/second), and uplink bandwidth (bytes/second, from measured
reduce-step uploads — consumed by the adaptive compression controller in
core/adaptive_frac.py). For iteration duration T it schedules each worker a
compute budget  b_w = T - latency_w  (floored), so every reply lands inside
the iteration ("asynchronous reduction callback delay" is thereby bounded).
On a synchronous TPU mesh the same estimates convert to per-virtual-worker
*sample budgets* (tokens per step) — same math, different unit.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, List


@dataclass
class WorkerStats:
    latency: float = 0.05          # seconds, EWMA round trip
    power: float = 100.0           # vectors / second, EWMA
    bandwidth: float = 1e6         # uplink bytes / second, EWMA (fed from
                                   # measured reduce-step upload time and
                                   # the wire bytes the event loop logs)
    upload: float = 0.0            # seconds, EWMA reduce-step upload —
                                   # part of the predicted round trip the
                                   # iteration deadline is derived from
    last_budget: float = 0.0       # seconds of compute scheduled
    total_vectors: int = 0
    total_upload_bytes: float = 0.0
    iterations: int = 0


class AdaptiveScheduler:
    """EWMA-based per-worker budgets for a target iteration duration T."""

    def __init__(self, T: float = 4.0, ewma: float = 0.5,
                 min_budget: float = 0.1,
                 prior_power: float = 100.0, prior_latency: float = 0.05,
                 prior_bandwidth: float = 1e6):
        assert T > 0 and 0 < ewma <= 1
        self.T = T
        self.ewma = ewma
        self.min_budget = min_budget
        self.prior_power = prior_power
        self.prior_latency = prior_latency
        self.prior_bandwidth = prior_bandwidth
        self.stats: Dict[str, WorkerStats] = {}

    # ------------------------------------------------------------------
    def add_worker(self, w: str) -> None:
        self.stats.setdefault(
            w, WorkerStats(latency=self.prior_latency,
                           power=self.prior_power,
                           bandwidth=self.prior_bandwidth))

    def remove_worker(self, w: str) -> None:
        self.stats.pop(w, None)

    # ------------------------------------------------------------------
    def _compute_budget(self, s: WorkerStats) -> float:
        """The shared budget formula — ``budget()`` and the deadline's
        ``predicted_round_trip()`` must never drift apart."""
        return max(self.min_budget, self.T - s.latency)

    def budget(self, w: str) -> float:
        """Seconds of compute worker w should run this iteration."""
        s = self.stats[w]
        s.last_budget = self._compute_budget(s)
        return s.last_budget

    def predicted_round_trip(self, w: str) -> float:
        """EWMA-predicted seconds until worker w's reduce message lands:
        scheduled compute budget plus round-trip latency plus the
        measured upload time (without the upload term an upload-bound
        fleet would be classified all-late every iteration)."""
        s = self.stats[w]
        return s.latency + self._compute_budget(s) + s.upload

    def deadline(self, workers: List[str], quantile: float = 0.75,
                 slack: float = 1.5) -> float:
        """Iteration close time for deadline-based partial participation
        (docs/elastic_training.md): a ``quantile`` of the fleet's EWMA-
        predicted round trips, scaled by ``slack`` to absorb jitter,
        floored at T. Workers whose reply lands after this are excluded
        from the reduce (their mass parks in the error-feedback
        residual), so one straggler stops setting the wall-clock."""
        if not workers:
            return self.T
        preds = sorted(self.predicted_round_trip(w) for w in workers)
        idx = min(len(preds) - 1, int(quantile * (len(preds) - 1) + 0.5))
        return max(self.T, slack * preds[idx])

    def expected_vectors(self, w: str) -> int:
        s = self.stats[w]
        return max(1, int(s.power * self._compute_budget(s)))

    def record(self, w: str, *, latency: float, vectors: int,
               compute_time: float, upload_bytes: float = 0.0,
               upload_time: float = 0.0) -> None:
        """Measurement feedback from one map-reduce round (paper step d).
        ``upload_bytes``/``upload_time`` are the reduce-step message size
        and its measured transfer time; together they grow the per-worker
        uplink bandwidth EWMA that the adaptive compression controller
        (core/adaptive_frac.py) maps to a keep-fraction."""
        s = self.stats[w]
        a = self.ewma
        s.latency = (1 - a) * s.latency + a * max(0.0, latency)
        if compute_time > 0:
            s.power = (1 - a) * s.power + a * (vectors / compute_time)
        if upload_bytes > 0 and upload_time > 0:
            s.bandwidth = ((1 - a) * s.bandwidth
                           + a * (upload_bytes / upload_time))
            s.upload = (1 - a) * s.upload + a * upload_time
            s.total_upload_bytes += upload_bytes
        s.total_vectors += vectors
        s.iterations += 1

    # ------------------------------------------------------------------
    # TrainState snapshot: the EWMAs ARE the scheduler's memory; the
    # constructor args (T, ewma, priors) are config the resuming harness
    # re-supplies (docs/elastic_training.md resume contract)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"stats": {w: asdict(s) for w, s in self.stats.items()}}

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.stats = {w: WorkerStats(**d) for w, d in st["stats"].items()}

    # ------------------------------------------------------------------
    def iteration_wall_time(self) -> float:
        """Time until the slowest scheduled reply returns (>= T by design
        only when latency spikes exceed the EWMA estimate)."""
        if not self.stats:
            return self.T
        return max(self.T, max(s.latency + s.last_budget
                               for s in self.stats.values()))

    def sample_budgets(self, total: int) -> Dict[str, int]:
        """TPU-mesh adaptation: split ``total`` samples per step across
        virtual workers proportionally to estimated power (same estimates,
        token units). Guarantees sum == total, each >= 0."""
        if not self.stats:
            return {}
        ws = sorted(self.stats)
        weights = [max(self.stats[w].power, 1e-9) for w in ws]
        z = sum(weights)
        raw = [total * x / z for x in weights]
        out = {w: int(r) for w, r in zip(ws, raw)}
        rem = total - sum(out.values())
        # distribute remainder by largest fractional part
        fracs = sorted(((r - int(r), w) for r, w in zip(raw, ws)),
                       reverse=True)
        for _, w in fracs[:rem]:
            out[w] += 1
        return out
