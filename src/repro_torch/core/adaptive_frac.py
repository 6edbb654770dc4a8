"""Bandwidth-adaptive per-worker compression — closing the §3.3(d) loop;
port of ``repro.core.adaptive_frac`` (pure Python, the same arithmetic,
so every keep decision is bit-equal).

The controller maps each worker's measured uplink bandwidth (the EWMA
``AdaptiveScheduler.record`` grows from reduce-step upload time and wire
bytes) and latency to a per-worker keep-fraction sized so the worker's
upload fits its communication budget — ``comm_frac`` of its scheduling
slack:

    comm_budget_w = comm_frac * max(T - latency_w, min_comm)
    raw_k_w       = bandwidth_w * comm_budget_w / BYTES_PER_ENTRY
    frac_w        = clamp(raw_k_w / n, frac_min, frac_max)

The keep count is snapped DOWN onto the compressor's power-of-two
``k_lattice``, with an ASYMMETRIC hysteresis against EWMA noise:
re-bucketing UP needs the raw target to clear ``2k * (1 +
hysteresis_up)``, re-bucketing DOWN needs it to fall below ``k * (1 -
hysteresis_down)``. ``MasterEventLoop`` syncs ``T`` to its scheduler's on
construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.core.compression import GradientCompressor
from repro_torch.core.scheduler import WorkerStats

BYTES_PER_ENTRY = 8            # 4B value + 4B index, the packed wire cost


@dataclass
class AdaptiveFracController:
    """Maps per-worker (bandwidth, latency) -> keep count for one
    (n,)-entry flat gradient buffer."""
    T: float = 4.0              # iteration duration the uploads must fit
    comm_frac: float = 0.25     # share of a worker's slack spent uploading
    frac_min: float = 1.0 / 1024
    frac_max: float = 0.25
    hysteresis_down: float = 0.25   # dead-band below the bucket's floor
    hysteresis_up: float = 0.05     # margin past the bucket's ceiling
    min_comm: float = 0.05      # floor for the comm budget (seconds)
    _last_k: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not (self.T > 0 and 0 < self.comm_frac <= 1):
            raise ValueError(f"T={self.T} must be > 0 and comm_frac="
                             f"{self.comm_frac} in (0, 1]")
        if not 0 < self.frac_min <= self.frac_max <= 1:
            raise ValueError(f"need 0 < frac_min={self.frac_min} <= "
                             f"frac_max={self.frac_max} <= 1")
        if not (0 <= self.hysteresis_down < 1 and self.hysteresis_up >= 0):
            raise ValueError(
                f"hysteresis_down={self.hysteresis_down} must lie in [0, 1) "
                f"and hysteresis_up={self.hysteresis_up} be >= 0")

    # -- pure math --------------------------------------------------------
    def frac_for(self, n: int, bandwidth: float, latency: float) -> float:
        """Continuous target keep-fraction, before bucketing."""
        budget = self.comm_frac * max(self.T - latency, self.min_comm)
        raw_k = bandwidth * budget / BYTES_PER_ENTRY
        return min(self.frac_max, max(self.frac_min, raw_k / n))

    def target_k(self, n: int, bandwidth: float, latency: float) -> float:
        return self.frac_for(n, bandwidth, latency) * n

    # -- per-iteration assignment ----------------------------------------
    def assign_worker(self, worker: str, compressor: GradientCompressor,
                      n: int, bandwidth: float, latency: float) -> int:
        """Bucketed keep total for one worker, with hysteresis against
        its previous assignment."""
        raw = self.target_k(n, bandwidth, latency)
        cand = compressor.quantize_k(n, raw)
        prev = self._last_k.get(worker)
        if prev is not None and cand != prev:
            # floor-quantization owns the raw domain [prev, 2*prev); hold
            # the bucket unless raw clears a boundary by its margin
            lo = prev * (1.0 - self.hysteresis_down)
            hi = 2.0 * prev * (1.0 + self.hysteresis_up)
            if lo <= raw < hi:
                cand = prev
        self._last_k[worker] = cand
        return cand

    def assign(self, compressor: GradientCompressor, n: int,
               stats: Dict[str, WorkerStats]) -> Dict[str, int]:
        """{worker: keep total} for the workers in ``stats`` — the
        ``keep=`` argument of ``MasterReducer.reduce_and_step``."""
        return {w: self.assign_worker(w, compressor, n,
                                      s.bandwidth, s.latency)
                for w, s in stats.items()}

    def drop_worker(self, worker: str) -> None:
        self._last_k.pop(worker, None)

    # -- TrainState snapshot ----------------------------------------------
    def state_dict(self) -> Dict[str, Dict[str, int]]:
        """The hysteresis memory is the controller's only mutable state
        (config is re-supplied by the resuming harness)."""
        return {"last_k": dict(self._last_k)}

    def load_state_dict(self, st) -> None:
        self._last_k = {w: int(k) for w, k in st["last_k"].items()}
