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
and a batch's arrays are moved there.

The reference's ``jit_kwargs`` are shardings over a device mesh. Given
``in_shardings`` / ``out_shardings`` (``distributed.sharding.to_shardings``
trees), the engine runs on every rank of the entered ``Mesh`` and wraps
the step in ``distributed.sharded_step.ShardedTrainStep``: ``state``
holds this rank's shards (``gather_state()`` rebuilds the whole), each
slice of the data axis is a virtual worker's rows, and churn zeroes its
mask rows. ``donate_argnums`` is taken and has no effect (every step
replaces the state); any other key raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.flatbuf import tree_leaves, tree_paths
from repro_torch.core.scheduler import AdaptiveScheduler
from repro_torch.distributed.sharded_step import ShardedTrainStep

PyTree = Any

JIT_KEYS = ("in_shardings", "out_shardings", "donate_argnums")


class ElasticMeshSGD:
    def __init__(self, *, train_step: Callable, state: PyTree,
                 n_workers: int, global_batch: int,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 jit_kwargs: Optional[dict] = None):
        jit_kwargs = dict(jit_kwargs or {})
        unknown = sorted(set(jit_kwargs) - set(JIT_KEYS))
        if unknown:
            raise TypeError(f"jit_kwargs keys {unknown}: the port takes "
                            f"{list(JIT_KEYS)}")
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
        self._sharded = _sharded_step(train_step, jit_kwargs, global_batch)
        if self._sharded is not None:
            state = self._sharded.shard_state(state)
            train_step = self._sharded
        self.state = state
        self._step = train_step
        self.history: List[Dict[str, float]] = []

    def gather_state(self) -> PyTree:
        """The whole state (on every rank when sharded)."""
        if self._sharded is None:
            return self.state
        return self._sharded.gather_state(self.state)

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
        the metrics as floats waits for the device. Spans: ``mesh.step``
        over ``mesh.upload`` (the batch and the work mask to the device),
        ``train.step`` and ``mesh.readback`` (the metrics' floats)."""
        with tracing.span("mesh.step"):
            dev = self.device
            with tracing.span("mesh.upload"):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                mask = self.work_mask(batch["tokens"].shape[1])
                batch["mask"] = mask * batch["mask"] if "mask" in batch \
                    else mask
            with tracing.span("train.step"):
                self.state, metrics = self._step(self.state, batch)
            if measured_power:
                for w, p in measured_power.items():
                    if w in self.scheduler.stats:
                        self.scheduler.record(w, latency=0.0,
                                              vectors=max(1, int(p)),
                                              compute_time=1.0)
            with tracing.span("mesh.readback"):
                out = {k: float(v) for k, v in metrics.items()}
        out["n_live"] = self.n_live
        self.history.append(out)
        return out


def _sharded_step(train_step, jit_kwargs: dict, global_batch: int):
    """``ShardedTrainStep`` for the shardings in ``jit_kwargs``, or None
    when it names none."""
    ins, outs = jit_kwargs.get("in_shardings"), jit_kwargs.get("out_shardings")
    if ins is None and outs is None:
        return None
    state_sh = (ins or outs)[0]
    if ins is not None and outs is not None and outs[0] is not None:
        a = [(p, s.spec) for p, s in tree_paths(ins[0])]
        b = [(p, s.spec) for p, s in tree_paths(outs[0])]
        if a != b:
            raise ValueError("out_shardings' state placement differs from "
                             "in_shardings': the port keeps one placement")
    batch_sh = ins[1] if ins is not None else None
    return ShardedTrainStep.from_shardings(train_step, state_sh, batch_sh,
                                           global_batch)
