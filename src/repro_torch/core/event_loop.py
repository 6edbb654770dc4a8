"""The master event loop — MLitB §3.3, the paper's central algorithm; port
of ``repro.core.event_loop``.

Each iteration runs the five ordered steps:

  a) new data uploading and allocation
  b) new client trainer initialization and data allocation (+ lost clients)
  c) training workers' reduce step (weighted gradient average + AdaGrad)
  d) latency monitoring and data allocation adjustment
  e) master broadcasts parameters

The loop is generic over a ``Cluster`` adapter (the discrete-event
simulator in core/simulation.py) and the reducer. The iteration duration T
plays the paper's role: workers are budgeted T - latency seconds of
compute and return gradient sums over however many vectors they managed.
Two optional components ride along: the guardrails
(``TrainingConfig(guardrails=)``: finite-ness screen, divergence rollback;
core/guardrails.py) and the adaptive per-worker keep controller
(``frac_controller=``; core/adaptive_frac.py).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

from repro_torch import tracing
from repro_torch.core.adaptive_frac import AdaptiveFracController
from repro_torch.core.allocator import DataAllocator
from repro_torch.core.config import TrainingConfig
from repro_torch.core.elastic import (EventQueue, JoinEvent, LeaveEvent,
                                      UploadDataEvent, WorkerRegistry)
from repro_torch.core.reducer import MasterReducer
from repro_torch.core.scheduler import AdaptiveScheduler

PyTree = Any


@dataclass
class ComputeResult:
    grad_sum: PyTree
    n_vectors: int
    compute_time: float          # seconds the worker actually computed
    latency: float               # measured round-trip latency
    loss_sum: float = 0.0


class Cluster(Protocol):
    def compute(self, worker: str, params: PyTree, budget: float,
                indices: List[int]) -> Optional[ComputeResult]:
        """Run worker's map step; None if the worker died mid-iteration."""
        ...

    def broadcast(self, params: PyTree, workers: List[str]) -> float:
        """Deliver params to workers; returns broadcast wall-time seconds."""
        ...

    # Optional: ``upload_time(worker, nbytes) -> float`` — seconds the
    # worker's reduce-step message of ``nbytes`` spends on its uplink.


@dataclass
class IterationLog:
    step: int
    wall_time: float
    n_workers: int
    vectors: int
    power: float                 # vectors / second this iteration
    mean_latency: float
    loss: float
    events: List[str] = field(default_factory=list)
    wire_bytes: int = 0          # reduce-step upstream bytes (packed if
                                 # the reducer's channel compresses)
    per_worker_wire_bytes: Dict[str, int] = field(default_factory=dict)
    max_upload: float = 0.0      # slowest worker's reduce-step upload (s)
    n_late: int = 0              # workers excluded by the deadline
    deadline: Optional[float] = None   # this iteration's close time (s)
    n_quarantined: int = 0       # NaN/Inf messages screened out this round
    rolled_back: bool = False    # divergence detected: reducer restored to
                                 # its last-good snapshot, reduce skipped


class MasterEventLoop:
    def __init__(self, *, reducer: MasterReducer, cluster: Cluster,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 allocator: Optional[DataAllocator] = None,
                 frac_controller: Optional[AdaptiveFracController] = None,
                 training: Optional[TrainingConfig] = None):
        training = training or TrainingConfig()
        self.training = training
        self.reducer = reducer
        self.cluster = cluster
        self.scheduler = scheduler or AdaptiveScheduler(T=training.T)
        self.allocator = allocator or DataAllocator()
        # NaN/divergence watchdog; None = trust every message (the
        # paper's behavior)
        self.guardrails = training.resolve_guardrails()
        self.deadline_quantile = training.deadline.quantile
        self.deadline_slack = training.deadline.slack
        self.publish_every = training.publish.every
        self.publish_fn = training.publish.fn
        # measurement -> controller -> per-worker channel: scales each
        # worker's keep-fraction to its measured uplink
        self.frac_controller = frac_controller
        if frac_controller is not None:
            if reducer.compressor is None or not reducer.fused:
                raise ValueError("frac_controller needs a fused compressed "
                                 "reducer (compressor=..., fused=True)")
            # one iteration budget: the controller sizes uploads against
            # the same T the scheduler budgets compute against
            frac_controller.T = self.scheduler.T
        self.registry = WorkerRegistry()
        self.events = EventQueue()
        self.clock = 0.0
        self.step = 0
        self.history: List[IterationLog] = []

    # ------------------------------------------------------------------
    # client-triggered events (arrive asynchronously, processed at the
    # iteration boundary)
    # ------------------------------------------------------------------
    def submit(self, ev) -> None:
        self.events.push(ev)

    def _process_events(self) -> List[str]:
        notes = []
        for ev in self.events.drain():
            if isinstance(ev, UploadDataEvent):                  # step (a)
                self.allocator.add_data(list(ev.indices))
                notes.append(f"data+{len(ev.indices)}")
            elif isinstance(ev, JoinEvent):                      # step (b)
                if ev.worker in self.registry:
                    continue
                self.registry.join(ev.worker, ev.capacity, self.step)
                self.allocator.add_worker(ev.worker, ev.capacity)
                self.scheduler.add_worker(ev.worker)
                notes.append(f"join:{ev.worker}")
            elif isinstance(ev, LeaveEvent):                     # step (b)
                if ev.worker not in self.registry:
                    continue
                self.registry.leave(ev.worker)
                orphans = self.allocator.remove_worker(ev.worker)
                self.scheduler.remove_worker(ev.worker)
                self.reducer.drop_worker(ev.worker)
                if self.frac_controller is not None:
                    self.frac_controller.drop_worker(ev.worker)
                notes.append(f"leave:{ev.worker}(orphans={len(orphans)})")
        return notes

    # ------------------------------------------------------------------
    def _predicted_wire_bytes(self, worker: str,
                              keep: Optional[Dict[str, int]],
                              grad: PyTree) -> int:
        """Exact bytes the reducer will account for this worker's message
        — computable BEFORE the reduce, so upload time participates in the
        deadline classification."""
        red = self.reducer
        if red.compressor is None:
            return 4 * red.flat_n
        if red.fused:
            return 8 * red.compressor.flat_k(red.flat_n,
                                             (keep or {}).get(worker))
        return red.compressor.wire_bytes(grad)

    def iteration(self) -> IterationLog:
        """One iteration, in the spans ``fleet.iteration`` over
        ``fleet.events``, ``fleet.map``, ``fleet.screen``,
        ``fleet.deadline`` (keep assignment, late classification),
        ``fleet.reduce``, ``fleet.monitor``, ``fleet.broadcast`` and
        ``fleet.publish``. Counters, by each reply's fate:
        ``fleet.vectors_on_time`` (the log's ``vectors``),
        ``fleet.vectors_deferred`` (late), ``fleet.vectors_quarantined``;
        ``fleet.workers_gone`` (workers that closed or were killed before
        computing). With the cluster's counters, every iteration keeps
        ``vectors_computed + vectors_resent = vectors_on_time +
        vectors_deferred + vectors_quarantined + vectors_dropped +
        vectors_stale``."""
        with tracing.span("fleet.iteration"):
            return self._iteration()

    def _iteration(self) -> IterationLog:
        with tracing.span("fleet.events"):
            notes = self._process_events()                       # (a),(b)
        self.step += 1
        workers = self.registry.live_workers()
        if not workers:
            # an empty-fleet iteration still advances the step counter
            log = IterationLog(self.step, self.scheduler.T, 0, 0, 0.0, 0.0,
                               float("nan"), notes)
            self.clock += self.scheduler.T
            self.history.append(log)
            with tracing.span("fleet.publish"):
                self._maybe_publish()
            return log

        # ---- map phase: budgeted local gradient accumulation ----
        with tracing.span("fleet.map"):
            budgets = {w: self.scheduler.budget(w)               # (d) out
                       for w in workers}
            deadline = None
            if self.deadline_quantile is not None:
                deadline = self.scheduler.deadline(
                    workers, self.deadline_quantile, self.deadline_slack)
            messages: Dict[str, Tuple[PyTree, float]] = {}
            results: Dict[str, ComputeResult] = {}
            died: List[str] = []
            for w in workers:
                idx = sorted(self.allocator.workers[w].allocated)
                res = self.cluster.compute(w, self.reducer.params,
                                           budgets[w], idx)
                if res is None:
                    died.append(w)
                    continue
                results[w] = res
                if res.n_vectors > 0:
                    messages[w] = (res.grad_sum, res.n_vectors)

            for w in died:                                       # footnote 5
                self.submit(LeaveEvent(w))
                notes.append(f"lost:{w}")

        # ---- guardrail layer 1: finite-ness screen ----
        # a NaN/Inf message is quarantined BEFORE the reduce — excluded
        # from the weighted average, the loss, and its own error-feedback
        # residual — and repeat offenders leave through the ordinary
        # membership path
        quarantined: List[str] = []
        with tracing.span("fleet.screen"):
            if self.guardrails is not None and messages:
                messages, quarantined = self.guardrails.screen(messages)
                for w in quarantined:
                    notes.append(f"quarantine:{w}")
                    if self.guardrails.record_offense(w):
                        self.submit(LeaveEvent(w))
                        notes.append(f"evict:{w}")

        # ---- deadline classification: who makes the reduce? ----
        with tracing.span("fleet.deadline"):
            # synthetic-compute clusters send empty gradient dicts
            # (throughput studies): count vectors but skip the update
            has_grads = any(len(g) > 0 for g, _ in messages.values())

            # per-worker keep counts must precede the deadline split:
            # message size decides upload time, which decides who makes
            # the deadline
            keep = None
            if self.frac_controller is not None and messages and has_grads:
                # bandwidth/latency estimates from step (d) of PREVIOUS
                # iterations pick this iteration's per-worker keep counts
                keep = self.frac_controller.assign(
                    self.reducer.compressor, self.reducer.flat_n,
                    {w: self.scheduler.stats[w] for w in messages})

            uploads: Dict[str, float] = {}
            upbytes: Dict[str, int] = {}
            finishes: Dict[str, float] = {}
            upload_fn = getattr(self.cluster, "upload_time", None)
            for w, r in results.items():
                nbytes = (self._predicted_wire_bytes(w, keep,
                                                     messages[w][0])
                          if w in messages and has_grads else 0)
                t_up = (upload_fn(w, nbytes)
                        if upload_fn is not None and nbytes else 0.0)
                uploads[w] = t_up
                upbytes[w] = nbytes
                finishes[w] = r.latency + r.compute_time + t_up
            late = (sorted(w for w, f in finishes.items() if f > deadline)
                    if deadline is not None else [])
            for w in late:
                notes.append(f"late:{w}")
            on_time = {w: r for w, r in results.items()
                       if w not in late and w not in quarantined}
            vectors = sum(r.n_vectors for r in on_time.values())
        if tracing.enabled():
            _count_vectors(results, late, quarantined, vectors, died)

        # ---- (c) reduce step (on-time, unquarantined workers only) ----
        with tracing.span("fleet.reduce"):
            loss, wire_bytes, per_bytes, rolled_back = self._reduce(
                messages, on_time, late, keep, has_grads, notes)

        # ---- (d) latency + bandwidth monitoring ----
        # late workers are still measured: their message DID transit the
        # uplink, just past the deadline
        with tracing.span("fleet.monitor"):
            for w, r in results.items():
                nbytes = upbytes[w]
                self.scheduler.record(
                    w, latency=r.latency, vectors=r.n_vectors,
                    compute_time=r.compute_time, upload_bytes=float(nbytes),
                    upload_time=uploads[w] if nbytes else 0.0)

        # ---- (e) broadcast ----
        with tracing.span("fleet.broadcast"):
            bc_time = self.cluster.broadcast(self.reducer.params,
                                             [w for w in workers
                                              if w not in died])

        # the master closes when the last reply lands or at the deadline,
        # whichever is first
        slowest = max(finishes.values()) if finishes else self.scheduler.T
        if deadline is not None:
            slowest = min(slowest, deadline)
        wall = max(self.scheduler.T, slowest) + bc_time
        self.clock += wall
        lat = ([r.latency for r in results.values()] or [0.0])
        log = IterationLog(
            step=self.step, wall_time=wall, n_workers=len(on_time),
            vectors=vectors, power=vectors / wall,
            mean_latency=sum(lat) / len(lat), loss=loss, events=notes,
            wire_bytes=wire_bytes, per_worker_wire_bytes=per_bytes,
            max_upload=max(uploads.values()) if uploads else 0.0,
            n_late=len(late), deadline=deadline,
            n_quarantined=len(quarantined), rolled_back=rolled_back)
        self.history.append(log)
        with tracing.span("fleet.publish"):
            self._maybe_publish()
        return log

    def _reduce(self, messages: Dict[str, Tuple[PyTree, float]],
                on_time: Dict[str, ComputeResult], late: List[str],
                keep: Optional[Dict[str, int]], has_grads: bool,
                notes: List[str]) -> Tuple[float, int, Dict[str, int], bool]:
        """Step (c): the weighted reduce and the update over the on-time,
        unquarantined messages; ``(loss, wire bytes, per-worker wire
        bytes, rolled back)``."""
        loss = float("nan")
        wire_bytes = 0
        per_bytes: Dict[str, int] = {}
        rolled_back = False
        if not (messages and has_grads):
            return loss, wire_bytes, per_bytes, rolled_back
        late_msgs = [w for w in late if w in messages]
        if len(late_msgs) < len(messages):
            # the round's loss, evaluated at the CURRENT params (the
            # previous step's output): what the divergence watchdog
            # judges before another step compounds it
            tot = sum(messages[w][1] for w in messages
                      if w not in late)
            loss = (sum(r.loss_sum for w, r in on_time.items())
                    / max(tot, 1))
            if self.guardrails is not None \
                    and self.guardrails.check_divergence(loss):
                # guardrail layer 2: the previous step poisoned the
                # params. Restore the last-good snapshot and SKIP this
                # round's reduce (its gradients saw diverged params).
                self.guardrails.rollback(self.reducer)
                rolled_back = True
                notes.append("rollback")
            else:
                if self.guardrails is not None:
                    # this loss vouched for the pre-step params:
                    # refresh the last-good snapshot BEFORE stepping
                    self.guardrails.observe_healthy(loss)
                    self.guardrails.snapshot(self.reducer)
                if self.reducer.fused:
                    # late workers ride the reduce live-masked to
                    # zero; their corrected gradient parks in their
                    # residual
                    self.reducer.reduce_and_step(messages, keep=keep,
                                                 defer=late_msgs)
                else:
                    # dense path: keep late mass in the residual when
                    # a compressor channel exists, else drop it
                    if self.reducer.compressor is not None:
                        for w in late_msgs:
                            self.reducer.defer_to_residual(
                                w, messages[w][0])
                    self.reducer.reduce_and_step(
                        {w: m for w, m in messages.items()
                         if w not in late}, keep=keep)
                wire_bytes = self.reducer.last_wire_bytes
                per_bytes = dict(self.reducer.last_per_worker_bytes)
        elif self.reducer.supports_defer:
            # every reply missed the deadline: no update this
            # iteration, but none of the mass is lost
            for w in late_msgs:
                self.reducer.defer_to_residual(w, messages[w][0])
        return loss, wire_bytes, per_bytes, rolled_back

    def _maybe_publish(self) -> None:
        """Step (e)': hand post-step params to ``publish_fn``; the version
        IS the training step."""
        if self.publish_fn is not None and self.publish_every > 0 \
                and self.step % self.publish_every == 0:
            self.publish_fn(self.reducer.params, self.step, self.clock)

    # ------------------------------------------------------------------
    # TrainState snapshot: the loop composes its components' state.
    # Constructor wiring is re-supplied by the resuming harness;
    # everything MUTABLE lives here.
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        events: List[Dict[str, Any]] = []
        for ev in self.events._pending:
            if isinstance(ev, JoinEvent):
                events.append({"type": "join", "worker": ev.worker,
                               "capacity": ev.capacity})
            elif isinstance(ev, LeaveEvent):
                events.append({"type": "leave", "worker": ev.worker})
            elif isinstance(ev, UploadDataEvent):
                events.append({"type": "data",
                               "indices": [int(i) for i in ev.indices]})
        st = {
            "step": self.step,
            "clock": self.clock,
            "history": [asdict(lg) for lg in self.history],
            "pending_events": events,
            "registry": self.registry.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "allocator": self.allocator.state_dict(),
            "reducer": self.reducer.state_dict(),
        }
        if self.frac_controller is not None:
            st["frac_controller"] = self.frac_controller.state_dict()
        if self.guardrails is not None:
            st["guardrails"] = self.guardrails.state_dict()
        return st

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        if (self.frac_controller is None) != ("frac_controller" not in st):
            # dropping the hysteresis memory silently would make the
            # resumed run re-bucket differently — fail loudly instead
            raise ValueError(
                "frac_controller mismatch: snapshot "
                f"{'has' if 'frac_controller' in st else 'lacks'} "
                f"controller state but this loop was built "
                f"{'without' if self.frac_controller is None else 'with'} "
                f"one")
        self.step = int(st["step"])
        self.clock = float(st["clock"])
        self.history = [IterationLog(**lg) for lg in st["history"]]
        self.events = EventQueue()
        for ev in st["pending_events"]:
            if ev["type"] == "join":
                self.events.push(JoinEvent(ev["worker"],
                                           int(ev["capacity"])))
            elif ev["type"] == "leave":
                self.events.push(LeaveEvent(ev["worker"]))
            else:
                self.events.push(UploadDataEvent(
                    [int(i) for i in ev["indices"]]))
        self.registry.load_state_dict(st["registry"])
        self.scheduler.load_state_dict(st["scheduler"])
        self.allocator.load_state_dict(st["allocator"])
        self.reducer.load_state_dict(st["reducer"])
        if self.frac_controller is not None:
            self.frac_controller.load_state_dict(st["frac_controller"])
        if self.guardrails is not None and "guardrails" in st:
            # a snapshot without watchdog state resumes it fresh
            # (strikes/window re-arm): no numerical trajectory depends on
            # watchdog memory
            self.guardrails.load_state_dict(st["guardrails"])

    # ------------------------------------------------------------------
    def run(self, n_iterations: int,
            callback: Optional[Callable[[IterationLog], None]] = None
            ) -> List[IterationLog]:
        out = []
        for _ in range(n_iterations):
            log = self.iteration()
            out.append(log)
            if callback:
                callback(log)
        return out


def _count_vectors(results: Dict[str, ComputeResult], late: List[str],
                   quarantined: List[str], on_time: int,
                   died: List[str]) -> None:
    """The replies' vectors by fate: on time, late or quarantined (a
    late, quarantined reply counts as quarantined); and the workers gone
    before computing."""
    q = set(quarantined)
    tracing.count("fleet.vectors_on_time", on_time)
    tracing.count("fleet.vectors_deferred",
                  sum(results[w].n_vectors for w in late if w not in q))
    tracing.count("fleet.vectors_quarantined",
                  sum(results[w].n_vectors for w in quarantined))
    tracing.count("fleet.workers_gone", len(died))
