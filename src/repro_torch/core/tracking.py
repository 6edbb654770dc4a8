"""Tracking mode — MLitB §3.6; port of ``repro.core.tracking`` (pure
Python).

"There are two possible functions in tracking mode: 1) executing the
neural network on test data, and 2) monitoring classification error on an
independent data set ... after each complete evaluation of the test
images, the latest neural network received from the master is used."

Trackers are non-training slaves: they receive the broadcast parameters
(step e) and asynchronously evaluate/execute the latest model. Here they
hook the master event loop's per-iteration callback; evaluation cadence
mirrors the paper (a tracker starts its next evaluation only after
finishing the previous one, always on the freshest params).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

PyTree = Any


@dataclass
class TrackPoint:
    step: int
    clock: float
    value: float


class StatTracker:
    """Monitors a statistic (e.g. classification error) over iterations."""

    def __init__(self, name: str,
                 eval_fn: Callable[[PyTree], float],
                 eval_cost_s: float = 0.0):
        self.name = name
        self.eval_fn = eval_fn
        self.eval_cost_s = eval_cost_s      # simulated evaluation duration
        self._busy_until = 0.0
        self.history: List[TrackPoint] = []

    def observe(self, params: PyTree, step: int, clock: float) -> None:
        if clock < self._busy_until:        # still evaluating older params
            return
        value = float(self.eval_fn(params))
        self._busy_until = clock + self.eval_cost_s
        self.history.append(TrackPoint(step, clock, value))

    @property
    def latest(self) -> Optional[TrackPoint]:
        return self.history[-1] if self.history else None


class ExecutorTracker:
    """Executes the latest model on demand (the paper's camera demo —
    'classify an image on a mobile device' with the freshest params)."""

    def __init__(self, predict_fn: Callable[[PyTree, Any], Any]):
        self.predict_fn = predict_fn
        self._params: Optional[PyTree] = None
        self.params_step = -1

    def observe(self, params: PyTree, step: int, clock: float) -> None:
        self._params = params
        self.params_step = step

    def __call__(self, inputs: Any) -> Any:
        if self._params is None:
            raise RuntimeError("no parameters received yet")
        return self.predict_fn(self._params, inputs)


def attach_trackers(loop, trackers: List) -> Callable:
    """Returns a per-iteration callback wiring trackers to an event loop
    (use with MasterEventLoop.run(..., callback=cb))."""
    def cb(log) -> None:
        for t in trackers:
            t.observe(loop.reducer.params, log.step, loop.clock)
    return cb
