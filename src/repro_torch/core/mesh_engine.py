"""ElasticMeshSGD — the paper's runtime as one training program (port of
``repro.core.mesh_engine``).

Each row slice of the global batch is a *virtual worker*:

  - the adaptive scheduler's per-worker budgets become per-step SAMPLE
    budgets: worker w's contiguous row slice has its first ``budget_w``
    rows mask=1, the rest 0;
  - worker churn (paper: closed tabs) = zeroing a worker's mask rows.
    The weighted reduce (sum / global count inside the train step) makes
    the math identical to the master dropping that client's message;
  - the master's reduce + AdaGrad step is the train step's optimizer
    update.

The engine holds no device of its own: it follows the state's tensors,
and a batch's arrays are moved there. The reference's ``jit_kwargs`` are
shardings over a device mesh, which the port does not have yet (ROADMAP
A10b); a non-empty one raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.flatbuf import tree_leaves
from repro_torch.core.scheduler import AdaptiveScheduler

PyTree = Any


class ElasticMeshSGD:
    def __init__(self, *, train_step: Callable, state: PyTree,
                 n_workers: int, global_batch: int,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 jit_kwargs: Optional[dict] = None):
        if jit_kwargs:
            raise NotImplementedError(
                f"jit_kwargs={sorted(jit_kwargs)}: shardings over a device "
                f"mesh are the multi-device surface, not ported yet "
                f"(ROADMAP A10b)")
        if global_batch % n_workers:
            raise ValueError(f"global_batch={global_batch} is not a "
                             f"multiple of n_workers={n_workers}")
        self.n_workers = n_workers
        self.rows_per_worker = global_batch // n_workers
        self.global_batch = global_batch
        self.live = np.ones(n_workers, bool)
        self.scheduler = scheduler or AdaptiveScheduler(T=1.0)
        for w in self._names():
            self.scheduler.add_worker(w)
        self.state = state
        self._step = train_step
        self.history: List[Dict[str, float]] = []

    def _names(self) -> List[str]:
        return [f"vw{i}" for i in range(self.n_workers)]

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.state["params"])[0].device

    # ------------------------------------------------------------------
    # membership events (paper step b)
    # ------------------------------------------------------------------
    def leave(self, i: int) -> None:
        self.live[i] = False
        self.scheduler.remove_worker(f"vw{i}")

    def join(self, i: int) -> None:
        if not self.live[i]:
            self.live[i] = True
            self.scheduler.add_worker(f"vw{i}")

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    # ------------------------------------------------------------------
    def work_mask(self, seq_len: int) -> torch.Tensor:
        """(B, S) float32 mask on the state's device, from liveness and
        the scheduler's sample budgets."""
        rpw = self.rows_per_worker
        total_live_rows = rpw * self.n_live
        budgets = self.scheduler.sample_budgets(total_live_rows)
        mask = np.zeros((self.global_batch,), np.float32)
        for i in range(self.n_workers):
            if not self.live[i]:
                continue
            b = min(budgets.get(f"vw{i}", 0), rpw)
            mask[i * rpw: i * rpw + b] = 1.0
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            mask[:, None], (self.global_batch, seq_len)))).to(self.device)

    # ------------------------------------------------------------------
    def step(self, batch: Dict[str, Any],
             measured_power: Optional[Dict[str, float]] = None
             ) -> Dict[str, float]:
        """One master-event-loop iteration: (a/b) events were applied via
        join/leave, (c) weighted reduce + update in the train step, (d)
        scheduler feedback from ``measured_power``, (e) broadcast is
        implicit (the engine holds the one copy of the params). Reading
        the metrics as floats waits for the device."""
        dev = self.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mask = self.work_mask(batch["tokens"].shape[1])
        batch["mask"] = mask * batch["mask"] if "mask" in batch else mask
        self.state, metrics = self._step(self.state, batch)
        if measured_power:
            for w, p in measured_power.items():
                if w in self.scheduler.stats:
                    self.scheduler.record(w, latency=0.0,
                                          vectors=max(1, int(p)),
                                          compute_time=1.0)
        out = {k: float(v) for k, v in metrics.items()}
        out["n_live"] = self.n_live
        self.history.append(out)
        return out
