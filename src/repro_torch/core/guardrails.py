"""Training guardrails: NaN/divergence containment for the volunteer
fleet; port of ``repro.core.guardrails``.

MLitB's workers are browsers the master does not control: a tab can
return a NaN gradient or a garbage-scaled one, and the error-feedback
channel makes a single poisoned message PERMANENT — the NaN lands in the
worker's residual and in the params, and every later iteration re-ships
it. Three layers:

- **finite-ness screen** (``TrainingGuardrails.screen``): every worker
  message is checked for NaN/Inf BEFORE it can touch the fused reduce.
  An offending message is QUARANTINED — excluded from the reduce and
  from the loss, its error-feedback residual left untouched — and the
  worker collects a strike. Repeat offenders are evicted through the
  ordinary membership path (``LeaveEvent``).

- **loss-divergence watchdog + last-good rollback**
  (``check_divergence`` / ``snapshot`` / ``rollback``): garbage-SCALED
  gradients pass the screen, but the next iteration's pre-step loss
  gives them away — non-finite, or more than ``max_loss_ratio`` x the
  best recent healthy loss. On divergence the loop restores the
  reducer's in-memory last-good snapshot (``MasterReducer.state_dict``)
  and SKIPS the round's reduce. The snapshot is refreshed only after a
  round's loss has vouched for the params it holds.

- **canary-gated publish** (``CanaryGate``): a candidate parameter tree
  must produce a finite probe loss no worse than ``max_loss_ratio`` x
  the best accepted one before it may be published.

Wiring: ``MasterEventLoop(training=TrainingConfig(guardrails=...))``
runs the screen and the watchdog inside ``iteration()``.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.flatbuf import tree_leaves
from repro_torch.kernels.runtime import DeviceLike, resolve_device

PyTree = Any


def tree_finite(tree: PyTree) -> bool:
    """True iff every leaf of ``tree`` is entirely finite (one host sync
    for the whole tree)."""
    leaves = [torch.as_tensor(x) for x in tree_leaves(tree)]
    if not leaves:
        return True
    return bool(torch.stack([torch.isfinite(x).all() for x in leaves])
                .all())


@dataclass(frozen=True)
class GuardrailConfig:
    """Knobs for the training-side watchdog."""
    max_loss_ratio: float = 4.0   # diverged when loss > ratio * recent min
    loss_window: int = 8          # healthy losses the divergence test sees
    min_history: int = 2          # healthy rounds before the ratio test arms
                                  # (non-finite loss always triggers)
    strikes_to_evict: int = 3     # NaN/Inf offenses before LeaveEvent
    snapshot_every: int = 1       # refresh last-good every N healthy rounds


class TrainingGuardrails:
    """Per-loop watchdog state: strikes, the recent-loss window, and the
    in-memory last-good reducer snapshot. One instance per
    ``MasterEventLoop``; survives checkpoint/resume via
    ``state_dict``/``load_state_dict`` like every other loop component."""

    def __init__(self, config: Optional[GuardrailConfig] = None):
        self.cfg = config or GuardrailConfig()
        self.strikes: Dict[str, int] = {}
        self.evicted: List[str] = []
        self._losses: Deque[float] = deque(maxlen=self.cfg.loss_window)
        self._last_good: Optional[Dict[str, Any]] = None
        self.last_good_step: Optional[int] = None
        self._healthy_since_snapshot = 0
        self.n_quarantined = 0        # poisoned messages screened out
        self.n_rollbacks = 0

    # -- layer 1: the finite-ness screen --------------------------------
    def screen(self, messages: Dict[str, Tuple[PyTree, float]]
               ) -> Tuple[Dict[str, Tuple[PyTree, float]], List[str]]:
        """Split worker messages into (clean, offender names). Offenders
        are dropped BEFORE the reduce so neither the params nor their
        own error-feedback residual can absorb the poison."""
        offenders = sorted(w for w, (g, _) in messages.items()
                           if not tree_finite(g))
        if not offenders:
            return messages, []
        self.n_quarantined += len(offenders)
        clean = {w: m for w, m in messages.items() if w not in offenders}
        return clean, offenders

    def record_offense(self, worker: str) -> bool:
        """One strike; True when the worker just crossed the eviction
        threshold (the caller submits the LeaveEvent)."""
        self.strikes[worker] = self.strikes.get(worker, 0) + 1
        if self.strikes[worker] == self.cfg.strikes_to_evict:
            self.evicted.append(worker)
            return True
        return False

    # -- layer 2: divergence detection + last-good rollback -------------
    def check_divergence(self, loss: float) -> bool:
        """Judge the round's pre-step loss (evaluated at the CURRENT
        params). Non-finite is always divergence; otherwise the loss must
        stay within ``max_loss_ratio`` of the best loss in the recent
        healthy window once ``min_history`` rounds have armed the test."""
        if not math.isfinite(loss):
            return True
        if len(self._losses) >= self.cfg.min_history:
            return loss > self.cfg.max_loss_ratio * min(self._losses)
        return False

    def observe_healthy(self, loss: float) -> None:
        self._losses.append(float(loss))

    def snapshot(self, reducer) -> None:
        """Capture the reducer's PRE-step state once the round's loss has
        vouched for it (throttled by ``snapshot_every``), in memory."""
        if self._last_good is None or self._healthy_since_snapshot + 1 \
                >= self.cfg.snapshot_every:
            self._last_good = reducer.state_dict()
            self.last_good_step = int(self._last_good["step"])
            self._healthy_since_snapshot = 0
        else:
            self._healthy_since_snapshot += 1

    @property
    def can_rollback(self) -> bool:
        return self._last_good is not None

    def rollback(self, reducer) -> bool:
        """Restore the last-good snapshot into the reducer (params,
        optimizer state, residuals, step counter — bit-exact). Returns
        False when no healthy round has been snapshotted yet."""
        if self._last_good is None:
            return False
        reducer.load_state_dict(self._last_good)
        self.n_rollbacks += 1
        # keep only the snapshot-era minimum so the ratio test re-arms
        # against verified state
        best = min(self._losses) if self._losses else None
        self._losses.clear()
        if best is not None:
            self._losses.append(best)
        return True

    # -- TrainState snapshot --------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "strikes": dict(self.strikes),
            "evicted": list(self.evicted),
            "losses": [float(x) for x in self._losses],
            "last_good": self._last_good,
            "last_good_step": self.last_good_step,
            "healthy_since_snapshot": self._healthy_since_snapshot,
            "n_quarantined": self.n_quarantined,
            "n_rollbacks": self.n_rollbacks,
        }

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.strikes = {w: int(v) for w, v in st["strikes"].items()}
        self.evicted = list(st["evicted"])
        self._losses = deque((float(x) for x in st["losses"]),
                             maxlen=self.cfg.loss_window)
        self._last_good = st["last_good"]
        self.last_good_step = (None if st["last_good_step"] is None
                               else int(st["last_good_step"]))
        self._healthy_since_snapshot = int(st["healthy_since_snapshot"])
        self.n_quarantined = int(st["n_quarantined"])
        self.n_rollbacks = int(st["n_rollbacks"])


# ---------------------------------------------------------------------------
# layer 3: the publish-path canary
# ---------------------------------------------------------------------------
class CanaryGate:
    """Probe-batch screen in front of a publish: a candidate tree must
    produce a finite probe loss no worse than ``max_loss_ratio`` x the
    best loss any ACCEPTED candidate has shown."""

    def __init__(self, probe_fn: Callable[[PyTree], float], *,
                 max_loss_ratio: float = 4.0):
        self.probe_fn = probe_fn
        self.max_loss_ratio = float(max_loss_ratio)
        self.best: Optional[float] = None
        self.n_passed = 0
        self.n_refused = 0
        self.refusals: List[Tuple[int, str]] = []   # (version, reason)

    def check(self, params: PyTree, version: int = -1) -> bool:
        """True when ``params`` is safe to publish. Screens leaf
        finite-ness first (Inf weights can give a finite probe loss)."""
        if not tree_finite(params):
            self.n_refused += 1
            self.refusals.append((int(version), "non-finite params"))
            return False
        loss = float(self.probe_fn(params))
        if not math.isfinite(loss):
            self.n_refused += 1
            self.refusals.append((int(version), "non-finite probe loss"))
            return False
        if self.best is not None and loss > self.max_loss_ratio * self.best:
            self.n_refused += 1
            self.refusals.append((int(version), "diverged probe loss"))
            return False
        self.best = loss if self.best is None else min(self.best, loss)
        self.n_passed += 1
        return True


def make_lm_probe(cfg, X: np.ndarray, y: np.ndarray,
                  device: DeviceLike = "cuda"
                  ) -> Callable[[PyTree], float]:
    """Mean next-token loss over a fixed probe batch, on ``device`` — the
    canary's forward pass (the same model math as ``make_lm_problem``,
    without the gradient)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import softmax_xent

    dev = resolve_device(device)
    Xp = torch.as_tensor(np.asarray(X)).to(dev)
    yp = torch.as_tensor(np.asarray(y)).to(dev)

    def probe_fn(params: PyTree) -> float:
        with torch.no_grad():
            logits, _ = tf.forward(params, cfg, Xp, remat=False)
            s, _ = softmax_xent(logits, yp)
        return float(s / yp.numel())

    return probe_fn
