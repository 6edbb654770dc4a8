"""Discrete-event cluster simulator — the browser swarm, faithfully
modeled; port of ``repro.core.simulation``.

Reproduces the experimental setting of MLitB §3.5 on one machine:
  - heterogeneous device profiles (workstation / laptop / phone) with
    power (vectors/sec) and base latency distributions;
  - a single-master congestion model: at the end of each iteration ALL
    workers send their gradient simultaneously, so per-message service
    time queues behind N-1 other messages; a worker assigned to a region
    (``add_worker(region=)``) queues only behind its own region's fleet
    at that region's sub-master, and ``RegionalNetworkModel`` prices the
    slow cross-region links the two-tier hierarchy's gossip crosses;
  - worker churn, straggler modes (``straggle_p``/``straggle_factor`` and
    the scripted ``straggle``), mid-iteration death (``kill`` and the
    per-profile ``reliability`` draw) and seeded fault injection
    (``FaultProfile``, ``poison``);
  - compute modes: "real" (actual gradients of a ready-made problem on
    the allocated vectors, computed on the problem's device: the paper's
    conv net on synthetic MNIST, or next-token training of a dense LM)
    and "synthetic" (power-model only).

Every draw comes from the same ``numpy.random.RandomState`` streams in the
same order as the JAX package's simulator, so the same seed gives the
same latencies, deaths, faults and subset choices. ``state_dict`` /
``load_state_dict`` carry those streams for a bit-exact resume.

``ServeCostModel`` is the serving clock's cost model;
``generate_requests`` (the serving workload) lives in
``repro_torch.serving.requests``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.event_loop import ComputeResult
from repro_torch.core.flatbuf import build_tree, tree_map, tree_paths
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import cnn

PyTree = Any


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    power_vps: float            # gradient vectors per second
    latency_mean: float         # base one-way network latency (s)
    latency_jitter: float       # lognormal-ish jitter scale
    reliability: float = 1.0    # P(survive an iteration)
    uplink_bps: float = 12.5e6  # worker->master uplink (bytes/sec): the
                                # per-client link the adaptive compression
                                # controller sizes messages for
    straggle_p: float = 0.0     # P(transient stall this reply): a GC
                                # pause / backgrounded tab multiplies the
    straggle_factor: float = 8.0   # reply's latency by straggle_factor


@dataclass(frozen=True)
class FaultProfile:
    """Seeded per-worker fault model (docs/robustness.md): the ways a
    volunteer browser goes BAD rather than merely slow. Gradient faults
    are mutually exclusive per reply (one seeded draw chooses); the
    flaky-uplink model is independent and applies to whatever reply the
    gradient faults produced. Workers without a profile draw nothing
    extra from their RNG stream, so fault-free runs stay bit-identical
    to pre-fault-injection behavior."""
    nan_p: float = 0.0          # P(reply gradient poisoned NaN/Inf —
                                # fp16 overflow, a broken kernel, malice)
    garbage_p: float = 0.0      # P(reply finite but garbage-scaled:
    garbage_scale: float = 1e6  # passes a finite screen, diverges the step)
    stale_p: float = 0.0        # P(reply duplicates the worker's previous
                                # message — a re-send of a stale payload)
    drop_p: float = 0.0         # P(one uplink send attempt is lost)
    max_retries: int = 2        # bounded retransmits before the reply is
                                # lost for good (master sees no message)
    retry_backoff: float = 0.25  # s added per retransmit, doubling
                                 # (charged to the reply's sim latency)


WORKSTATION = DeviceProfile("workstation", 400.0, 0.010, 0.20,
                            uplink_bps=12.5e6)       # ~100 Mb/s ethernet
LAPTOP = DeviceProfile("laptop", 150.0, 0.030, 0.40,
                       uplink_bps=2.5e6)             # ~20 Mb/s wifi
PHONE = DeviceProfile("phone", 25.0, 0.120, 0.80, reliability=0.995,
                      uplink_bps=0.125e6)            # ~1 Mb/s cellular

# Paper-faithful homogeneous grid node (i3-2120 workstations on a LAN): the
# paper reports ~113 vectors/sec/node on MNIST (Fig. 4 slope).
GRID_NODE = DeviceProfile("grid", 113.0, 0.005, 0.10, uplink_bps=125e6)


@dataclass(frozen=True)
class NetworkModel:
    """Single-master bandwidth/service model (paper §3.5/§3.7).

    Calibrated against Fig. 4: latency stays ~flat to 32 nodes then jumps
    to ~1s around 64-96 as gradient messages queue at the single master.
    Service time per ~1MB gradient message ~= 30ms (Node.js ingest +
    deserialize + accumulate), so congestion ~= 30ms * (N-1)/2.
    """
    master_bw: float = 40e6          # bytes/sec single master process ingest
    per_msg_overhead: float = 0.005  # per-message master processing (s)
    grad_bytes: float = 1e6          # wire size of one gradient message
                                     # (">1MB for small neural networks")

    def reduce_congestion(self, n_workers: int) -> float:
        """Mean extra latency a message sees when n messages arrive at once:
        the j-th message in the queue waits j service times; average over j.
        Service time = transfer + overhead."""
        service = self.grad_bytes / self.master_bw + self.per_msg_overhead
        return service * (n_workers - 1) / 2.0

    def broadcast_time(self, n_workers: int) -> float:
        """Step (e): master pushes params to every boss sequentially."""
        return n_workers * self.grad_bytes / self.master_bw * 0.25


@dataclass(frozen=True)
class RegionalNetworkModel(NetworkModel):
    """Region-structured bandwidth: the base ``NetworkModel`` fields
    describe the INTRA-region fast path (each regional sub-master ingests
    only its own fleet, so congestion queues are region-scoped), while
    ``wan_bw``/``wan_latency`` price the slow cross-region links that only
    the H-step gossip deltas traverse (a ~10x intra/inter asymmetry)."""
    wan_bw: float = 4e6              # bytes/sec on a cross-region link
    wan_latency: float = 0.080       # one-way cross-region latency (s)

    def wan_time(self, nbytes: float) -> float:
        """Seconds one gossip message of ``nbytes`` spends crossing the
        WAN (transfer + propagation)."""
        return float(nbytes) / self.wan_bw + self.wan_latency


@dataclass
class SimWorker:
    worker: str
    profile: DeviceProfile
    rng: np.random.RandomState


class SimulatedCluster:
    """Implements the Cluster protocol against synthetic data + profiles."""

    def __init__(self, *,
                 grad_fn: Optional[Callable[[PyTree, Any, Any],
                                            Tuple[PyTree, float]]] = None,
                 data: Optional[Tuple[Any, Any]] = None,
                 network: NetworkModel = NetworkModel(),
                 mode: str = "real",
                 seed: int = 0,
                 device: DeviceLike = "cuda"):
        """``data`` = (X, y) is copied to ``device`` once, here; each
        worker's batch is then gathered there. ``grad_fn`` must compute on
        the same device (``make_cnn_problem(device=...)``)."""
        if mode not in ("real", "synthetic"):
            raise ValueError(f"mode={mode!r}: expected 'real' or "
                             f"'synthetic'")
        if mode == "real" and (grad_fn is None or data is None):
            raise ValueError("mode='real' needs grad_fn and data")
        self.device = resolve_device(device)
        self.grad_fn = grad_fn
        self.data = None if data is None else tuple(
            torch.as_tensor(a).to(self.device) for a in data)
        self.network = network
        self.mode = mode
        self.workers: Dict[str, SimWorker] = {}
        self._rng = np.random.RandomState(seed)
        self.total_grad_bytes = 0.0
        # scripted churn hooks (tests/benchmarks): worker -> [factor,
        # remaining replies] latency multipliers, and one-shot kills
        self._straggle: Dict[str, List[float]] = {}
        self._kill_pending: Set[str] = set()
        # fault injection (docs/robustness.md): per-worker seeded fault
        # profiles, scripted poison hooks (worker -> [kind, remaining
        # replies]), and the last CLEAN reply per worker (what a stale
        # fault re-sends). The stale cache is intentionally NOT part of
        # state_dict: it holds full gradient trees, and a resume simply
        # lets the first post-resume stale draw fall through.
        self._faults: Dict[str, FaultProfile] = {}
        self._poison: Dict[str, List[Any]] = {}
        self._last_reply: Dict[str, Tuple[PyTree, int, float]] = {}  # reprolint: exempt[RL005]
        # two-tier topology: worker -> region label. Unassigned workers
        # congest globally (the flat master, bit-exact); assigned workers
        # queue only behind their own region's fleet
        self._regions: Dict[str, str] = {}

    # ------------------------------------------------------------------
    def add_worker(self, worker: str, profile: DeviceProfile,
                   region: Optional[str] = None) -> None:
        # a rejoining tab starts clean: scripted stalls/kills/poison
        # aimed at a previous incarnation of this name must not leak
        # onto it
        self._straggle.pop(worker, None)
        self._kill_pending.discard(worker)
        self._poison.pop(worker, None)
        self._last_reply.pop(worker, None)
        self.workers[worker] = SimWorker(
            worker, profile,
            np.random.RandomState(self._rng.randint(2 ** 31)))
        if region is None:
            self._regions.pop(worker, None)
        else:
            self._regions[worker] = region

    def set_faults(self, worker: str,
                   faults: Optional[FaultProfile]) -> None:
        """Attach (or clear, with None) a seeded fault profile to the
        worker — the probabilistic counterpart of ``poison``."""
        if faults is None:
            self._faults.pop(worker, None)
        else:
            self._faults[worker] = faults

    # ------------------------------------------------------------------
    # scripted churn (deterministic counterpart of reliability/straggle_p)
    # ------------------------------------------------------------------
    def kill(self, worker: str) -> None:
        """Close the worker's tab mid-iteration: its next compute call
        returns None (the master loses that contribution and submits a
        LeaveEvent, paper footnote 5)."""
        self._kill_pending.add(worker)
        self._straggle.pop(worker, None)       # the stall died with it
        self._poison.pop(worker, None)         # so did the poison

    def straggle(self, worker: str, factor: float, iters: int = 1) -> None:
        """Multiply the worker's next ``iters`` reply latencies by
        ``factor`` — a scripted GC pause / backgrounded tab."""
        self._straggle[worker] = [float(factor), int(iters)]

    def poison(self, worker: str, kind: str, iters: int = 1) -> None:
        """Corrupt the worker's next ``iters`` replies deterministically
        — the scripted counterpart of ``FaultProfile`` (tests pin exact
        rounds). ``kind``: 'nan' | 'inf' (non-finite gradient),
        'garbage' (finite, scaled by the profile's ``garbage_scale`` or
        1e6), 'stale' (re-send the previous clean reply), 'drop' (the
        reply is lost on the uplink after its bounded retries)."""
        if kind not in ("nan", "inf", "garbage", "stale", "drop"):
            raise ValueError(f"unknown poison kind {kind!r}")
        self._poison[worker] = [kind, int(iters)]

    # ------------------------------------------------------------------
    def _congestion_peers(self, worker: str) -> int:
        """How many simultaneous reduce-step messages queue with this
        worker's: the whole fleet at a flat master, only the same-region
        fleet once the worker reports to a regional sub-master."""
        region = self._regions.get(worker)
        if region is None:
            return len(self.workers)
        return sum(1 for w in self.workers
                   if self._regions.get(w) == region)

    def region_of(self, worker: str) -> Optional[str]:
        return self._regions.get(worker)

    # ------------------------------------------------------------------
    def _sample_latency(self, sw: SimWorker, n_live: int) -> float:
        base = sw.profile.latency_mean * math.exp(
            sw.profile.latency_jitter * sw.rng.randn())
        stall = 1.0
        sched = self._straggle.get(sw.worker)
        if sched is not None:
            stall = sched[0]
            sched[1] -= 1
            if sched[1] <= 0:
                del self._straggle[sw.worker]
        elif (sw.profile.straggle_p > 0.0
              and sw.rng.rand() < sw.profile.straggle_p):
            stall = sw.profile.straggle_factor
        return base * stall + self.network.reduce_congestion(n_live)

    # ------------------------------------------------------------------
    # fault injection (docs/robustness.md)
    # ------------------------------------------------------------------
    def _fault_kind(self, sw: SimWorker) -> Optional[str]:
        """This reply's gradient fault, if any: the scripted poison
        schedule wins (no RNG), else one seeded draw against the
        worker's FaultProfile. Profile-less workers draw NOTHING, so
        their streams match pre-fault-injection runs bit-exactly."""
        sched = self._poison.get(sw.worker)
        if sched is not None:
            kind = sched[0]
            sched[1] -= 1
            if sched[1] <= 0:
                del self._poison[sw.worker]
            return kind
        fp = self._faults.get(sw.worker)
        if fp is None or (fp.nan_p + fp.garbage_p + fp.stale_p) <= 0.0:
            return None
        u = sw.rng.rand()
        if u < fp.nan_p:
            return "nan" if sw.rng.rand() < 0.5 else "inf"
        if u < fp.nan_p + fp.garbage_p:
            return "garbage"
        if u < fp.nan_p + fp.garbage_p + fp.stale_p:
            return "stale"
        return None

    def _uplink_delivery(self, sw: SimWorker,
                         kind: Optional[str]) -> Tuple[bool, float]:
        """(delivered, extra_latency) for the reply's flaky uplink:
        each send attempt is lost with ``drop_p``; bounded retransmits
        back off exponentially, charged to the sim clock; past
        ``max_retries`` the reply is lost for good (the master sees a
        live worker with nothing to contribute this round). A scripted
        'drop' burns the full retry budget then loses the reply."""
        fp = self._faults.get(sw.worker)
        if kind == "drop":
            backoff = fp.retry_backoff if fp else 0.25
            retries = fp.max_retries if fp else 2
            return False, sum(backoff * 2.0 ** a for a in range(retries))
        if fp is None or fp.drop_p <= 0.0:
            return True, 0.0
        extra, attempt = 0.0, 0
        while sw.rng.rand() < fp.drop_p:
            attempt += 1
            if attempt > fp.max_retries:
                return False, extra
            extra += fp.retry_backoff * 2.0 ** (attempt - 1)
        return True, extra

    def compute(self, worker: str, params: PyTree, budget: float,
                indices: List[int]) -> Optional[ComputeResult]:
        """One worker's map step in the span ``fleet.worker``, over
        ``worker.rows`` (row sampling, the index upload and the gather)
        and ``grad_fn``'s own spans. Counters: ``fleet.vectors_computed``
        (the rows this worker computed; a synthetic worker's are
        nominal), ``fleet.vectors_dropped`` (the rows of a reply its
        uplink lost), and for a stale reply ``fleet.vectors_stale`` (the
        fresh rows it replaced) and ``fleet.vectors_resent`` (the old
        rows it re-sent, computed in an earlier round)."""
        with tracing.span("fleet.worker"):
            return self._compute(worker, params, budget, indices)

    def _compute(self, worker: str, params: PyTree, budget: float,
                 indices: List[int]) -> Optional[ComputeResult]:
        sw = self.workers[worker]
        if worker in self._kill_pending:
            self._kill_pending.discard(worker)
            del self.workers[worker]
            return None                                   # scripted death
        if sw.rng.rand() > sw.profile.reliability:
            return None                                   # tab closed mid-run
        n_live = self._congestion_peers(worker)
        n_possible = int(sw.profile.power_vps * budget)
        n = min(n_possible, len(indices)) if indices else 0
        latency = self._sample_latency(sw, n_live)
        self.total_grad_bytes += self.network.grad_bytes
        if n == 0:
            return ComputeResult({}, 0, budget, latency, 0.0)
        with tracing.span("worker.rows"):
            take = sw.rng.choice(len(indices), size=n, replace=False)
            idx = np.asarray(indices)[take]
            if self.mode != "synthetic":
                X, y = self.data
                ix = torch.from_numpy(np.asarray(idx, np.int64)).to(
                    self.device)
                Xb, yb = X[ix], y[ix]
        if self.mode == "synthetic":
            tracing.count("fleet.vectors_computed", n)
            kind = self._fault_kind(sw)      # keeps schedules in step
            delivered, extra = self._uplink_delivery(sw, kind)
            if not delivered:
                tracing.count("fleet.vectors_dropped", n)
                return ComputeResult({}, 0, n / sw.profile.power_vps,
                                     latency + extra, 0.0)
            return ComputeResult({}, int(n), n / sw.profile.power_vps,
                                 latency + extra, 0.0)
        grad_sum, loss_sum = self.grad_fn(params, Xb, yb)
        tracing.count("fleet.vectors_computed", n)
        reply_n = int(n)
        loss_sum = float(loss_sum)
        kind = self._fault_kind(sw)
        if kind in ("nan", "inf"):
            bad = float("nan") if kind == "nan" else float("inf")
            grad_sum = tree_map(lambda g: torch.full_like(g, bad), grad_sum)
            loss_sum = bad
        elif kind == "garbage":
            fp = self._faults.get(worker)
            scale = fp.garbage_scale if fp else 1e6
            grad_sum = tree_map(lambda g: g * scale, grad_sum)
        elif kind == "stale" and worker in self._last_reply:
            grad_sum, reply_n, loss_sum = self._last_reply[worker]
            tracing.count("fleet.vectors_stale", n)
            tracing.count("fleet.vectors_resent", reply_n)
        if kind is None:
            # only CLEAN replies seed the stale cache: a stale fault
            # re-sends the last genuine message, not a poisoned one
            self._last_reply[worker] = (grad_sum, reply_n, loss_sum)
        delivered, extra = self._uplink_delivery(sw, kind)
        latency += extra
        if not delivered:
            tracing.count("fleet.vectors_dropped", reply_n)
            return ComputeResult({}, 0, n / sw.profile.power_vps,
                                 latency, 0.0)
        return ComputeResult(grad_sum, reply_n, n / sw.profile.power_vps,
                             latency, loss_sum)

    def upload_time(self, worker: str, nbytes: float) -> float:
        """Seconds worker's reduce-step message spends on ITS uplink —
        the per-client cost the adaptive compression controller adapts
        to. Deterministic (the jittered part of the path is sampled in
        ``_sample_latency``), so measured bandwidth EWMAs converge to the
        profile's ``uplink_bps``."""
        return float(nbytes) / self.workers[worker].profile.uplink_bps

    def broadcast(self, params: PyTree, workers: List[str]) -> float:
        return self.network.broadcast_time(len(workers))

    # ------------------------------------------------------------------
    # TrainState snapshot: the RNG streams ARE the cluster's state — a
    # resumed run must draw the exact jitter/death/subset sequence the
    # uninterrupted run would have (docs/elastic_training.md)
    # ------------------------------------------------------------------
    @staticmethod
    def _rng_state(rng: np.random.RandomState) -> List[Any]:
        name, keys, pos, has_gauss, cached = rng.get_state()
        return [name, np.asarray(keys), int(pos), int(has_gauss),
                float(cached)]

    @staticmethod
    def _set_rng_state(rng: np.random.RandomState, st: List[Any]) -> None:
        rng.set_state((st[0], np.asarray(st[1], np.uint32), int(st[2]),
                       int(st[3]), float(st[4])))

    def state_dict(self) -> Dict[str, Any]:
        return {
            "rng": self._rng_state(self._rng),
            "total_grad_bytes": self.total_grad_bytes,
            "straggle": {w: list(v) for w, v in self._straggle.items()},
            "kill_pending": sorted(self._kill_pending),
            "faults": {w: dataclasses.asdict(fp)
                       for w, fp in self._faults.items()},
            "poison": {w: list(v) for w, v in self._poison.items()},
            "regions": dict(self._regions),
            "workers": {w: {"profile": dataclasses.asdict(sw.profile),
                            "rng": self._rng_state(sw.rng)}
                        for w, sw in self.workers.items()},
        }

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self._set_rng_state(self._rng, st["rng"])
        self.total_grad_bytes = float(st["total_grad_bytes"])
        self._straggle = {w: [float(v[0]), int(v[1])]
                          for w, v in st["straggle"].items()}
        self._kill_pending = set(st["kill_pending"])
        # _last_reply is deliberately NOT restored (it holds gradient
        # trees): the first post-resume stale draw just falls through to
        # a clean reply, which is a superset of correct behavior
        self._faults = {w: FaultProfile(**d) for w, d in st["faults"].items()}
        self._poison = {w: [str(v[0]), int(v[1])]
                        for w, v in st["poison"].items()}
        # lenient, as the JAX package's: a snapshot without the map is a
        # flat topology
        self._regions = {w: str(r)
                         for w, r in st.get("regions", {}).items()}
        self._last_reply = {}
        self.workers = {}
        for w, d in st["workers"].items():
            sw = SimWorker(w, DeviceProfile(**d["profile"]),
                           np.random.RandomState(0))
            self._set_rng_state(sw.rng, d["rng"])
            self.workers[w] = sw


# ---------------------------------------------------------------------------
# Ready-made problems
# ---------------------------------------------------------------------------
def make_cnn_problem(seed: int = 0, device: DeviceLike = "cuda"):
    """(init_params, grad_fn, eval_fn) for the paper's conv net on
    synthetic MNIST, computing on ``device``. ``init_params(seed=seed)``
    draws the weights; grad_fn(params, X, y) returns (grad_SUM, loss_SUM)
    per the paper's sum-then-weighted-average protocol (one host sync,
    for the loss, as the JAX package's); eval_fn(params, X, y) -> test
    error. X, y may be numpy arrays or tensors already on ``device``."""
    from repro_torch.models import cnn

    dev = resolve_device(device)

    def init_params(seed: int = seed):
        return cnn.init_params(seed, device=dev)

    def grad_fn(params, X, y):
        loss, grads, _ = cnn.loss_and_grad(
            params, torch.as_tensor(X, device=dev),
            torch.as_tensor(y, device=dev))
        return grads, float(loss)

    def eval_fn(params, X, y):
        with torch.no_grad():
            logits = cnn.forward(params, torch.as_tensor(X, device=dev))
            wrong = torch.argmax(logits, -1) != torch.as_tensor(
                y, device=dev).long()
            return float(wrong.float().mean())

    return init_params, grad_fn, eval_fn


def make_lm_problem(cfg, n_data: int = 512, seq_len: int = 16,
                    seed: int = 0, device: DeviceLike = "cuda"):
    """(data, grad_fn) for next-token training of a dense ``ArchConfig``
    LM on synthetic token sequences: the same numpy stream and windows as
    the JAX package's. ``data = (X, y)`` with X (n, S) int32 token windows
    and y their one-step-shifted labels (numpy). grad_fn(params, X, y)
    returns (grad_SUM, loss_SUM) per the paper's sum-then-weighted-average
    protocol, computing on ``device``: the gradient tree has the params'
    key paths, one leaf per ``tree_leaves(params)`` leaf. Its spans:
    ``worker.forward``, ``worker.backward`` (the host launching the
    work) and ``worker.readback`` (the loss's float: the host waiting
    for the device)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import softmax_xent

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    stream = rng.randint(0, cfg.vocab_size,
                         size=n_data + seq_len).astype(np.int32)
    X = np.stack([stream[i:i + seq_len] for i in range(n_data)])
    y = np.stack([stream[i + 1:i + 1 + seq_len] for i in range(n_data)])

    def grad_fn(params, Xb, yb):
        with tracing.span("worker.forward"):
            paths, leaves = zip(*[(p, x.detach().requires_grad_(True))
                                  for p, x in tree_paths(params)])
            logits, _ = tf.forward(build_tree(paths, leaves), cfg,
                                   torch.as_tensor(Xb, device=dev),
                                   remat=False)
            s, _ = softmax_xent(logits, torch.as_tensor(yb, device=dev))
        with tracing.span("worker.backward"):
            grads = build_tree(paths, list(torch.autograd.grad(s, leaves)))
        with tracing.span("worker.readback"):
            loss = float(s.detach())
        return grads, loss

    return (X, y), grad_fn


# ---------------------------------------------------------------------------
# Serving cost model (the simulated serving clock)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServeCostModel:
    """Wall-time model for one serving step on a single accelerator (a
    copy of the JAX package's; its seconds are the model's, not a
    card's).

    Charges the PADDED shapes the engine actually executes: a prefill of
    ``(batch_cap, prompt_cap)`` costs ``batch_cap * prompt_cap`` token
    units (compute-bound), a decode step one unit per batch ROW
    (memory-bound: every row reads the whole KV cache whether or not it
    is live). ``step_overhead`` is the per-dispatch cost of a call plus
    host-side sampling and bookkeeping.
    """
    step_overhead: float = 2e-3     # s per engine step (dispatch+sampling)
    prefill_tok: float = 2e-5       # s per padded prefill token
    decode_row: float = 1e-4        # s per padded decode row
    swap_overhead: float = 1e-3     # s per param hot swap (host-side tree
                                    # install, no device work)
    draft_tok: float = 1e-6         # s per draft-window token per forward
                                    # (the speculative draft LM is tiny and
                                    # cacheless: k forwards over (B, window))

    def prefill_time(self, batch_cap: int, prompt_cap: int) -> float:
        return self.step_overhead + self.prefill_tok * batch_cap * prompt_cap

    def decode_time(self, batch: int) -> float:
        return self.step_overhead + self.decode_row * batch

    def decode_time_paged(self, page_reads: int, pages_per_row: int
                          ) -> float:
        """Decode charge for the PAGED engine: proportional to the KV
        pages actually read. Calibrated so a full dense batch
        (``max_batch * pages_per_row`` page reads) costs exactly
        ``decode_time(max_batch)``."""
        return self.step_overhead + self.decode_row * page_reads \
            / max(pages_per_row, 1)

    def decode_time_flash(self, kv_tokens: int, max_seq: int) -> float:
        """Decode charge for the DENSE engine under the flash kernel:
        proportional to the KV tokens actually read. Calibrated so a
        saturated batch (``batch * max_seq`` KV tokens) costs exactly
        ``decode_time(batch)``."""
        return self.step_overhead + self.decode_row * kv_tokens \
            / max(max_seq, 1)

    def draft_time(self, k: int, batch: int, window: int) -> float:
        """Charge for ONE speculative draft dispatch: k cacheless
        forwards of the draft LM over a (batch, window) buffer."""
        return self.step_overhead + self.draft_tok * k * batch * window

    def swap_time(self) -> float:
        return self.swap_overhead
