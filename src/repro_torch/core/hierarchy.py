"""Two-tier hierarchical training — breaking the single-master wall; port
of ``repro.core.hierarchy``.

MLitB §3.3/§3.5 envisions planet-scale browser fleets, but one
``MasterEventLoop`` reducing every worker reply hits the paper's own
Fig. 4 congestion knee (~64 workers) long before that. The fix mirrors
how real federations are laid out: REGIONAL SUB-MASTERS, each running
the deadline/compressed fused reduce (``MasterReducer`` + error-feedback
residuals, unchanged) over its own fleet on the intra-region fast path,
with a local-SGD-style OUTER step that gossips model deltas between
sub-masters — so only H-step deltas ever cross the slow WAN.

The outer step is CHOCO-Gossip-shaped (Koloskova et al. 2019):

  publish   each region i compresses x_i - x_hat_i through the SAME
            packed ``CompressedMessage`` error-feedback channel the
            worker uplinks use (top-k), and every peer applies it to its
            mirror of x_hat_i — the "ghost" public copy stays consistent
            everywhere because publishes are broadcast, and the un-sent
            mass parks in a per-region residual;
  gossip    one ``gossip_round`` over the ghosts: a seeded random
            matching pairwise-averages them, weighted by each region's
            sample count since the last outer step;
  correct   x_i += gossip_lr * (avg - x_hat_i) — the sub-master's inner
            AdaGrad trajectory continues from a point pulled toward the
            pair consensus, without touching its accumulator.

With ``gossip_frac=1.0`` the ghosts equal the params exactly and the
outer step is exact pairwise weighted averaging; with small fractions the
residuals ship the difference over later rounds.

Regional churn reuses the elastic machinery one level up: a whole region
``leave_region``s mid-run (its loop keeps its state, parked) and
``join_region``s back re-seeded to the current consensus.

Ghosts and residuals live on the reducers' device. Everything mutable —
sub-master loops, ghosts, residuals, the gossip RNG stream, outer-step
counters — round-trips through ``state_dict`` as numpy in the JAX
package's keys, so a two-tier ``TrainState`` written by either package
loads in the other and a resume replays bit-exactly.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compression import GradientCompressor
from repro_torch.core.config import HierarchyConfig, PublishConfig
from repro_torch.core.event_loop import MasterEventLoop
from repro_torch.core.gossip import gossip_round
from repro_torch.core.local_sgd import communication_ratio
from repro_torch.core.simulation import RegionalNetworkModel, SimulatedCluster

PyTree = Any


@dataclass
class OuterLog:
    """One outer step: H inner reduces per active region, then the WAN
    gossip exchange."""
    outer_step: int
    clock: float                 # global clock after the WAN barrier (s)
    vectors: int                 # fleet-wide vectors this outer step
    loss: float                  # vector-weighted mean of regional losses
    wan_bytes: int               # compressed gossip bytes this outer step
    wan_time: float              # the outer exchange's WAN wall (s)
    spread: float                # max pairwise L-inf over region params
    region_steps: Dict[str, int] = field(default_factory=dict)
    events: List[str] = field(default_factory=list)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class HierarchicalMaster:
    """Drives ``n_regions`` sub-master ``MasterEventLoop``s plus the
    compressed outer gossip between them.

    All regions share ONE cluster (region-scoped congestion lives there);
    each region's loop owns its own fused reducer over the same parameter
    layout. Regions are iterated in sorted-name order everywhere: the
    gossip matching consumes a seeded stream and replica order is part of
    it."""

    def __init__(self, *, regions: Dict[str, MasterEventLoop],
                 config: HierarchyConfig,
                 publish: Optional[PublishConfig] = None,
                 network: Optional[RegionalNetworkModel] = None):
        if not regions:
            raise ValueError("regions={}: a hierarchy needs at least one "
                             "sub-master")
        if config.gossip and len(regions) < 2:
            raise ValueError(
                f"{len(regions)} region(s) with gossip enabled: pairwise "
                f"averaging needs >= 2 (HierarchyConfig(gossip=False) for "
                f"a degenerate single-region hierarchy)")
        ns = set()
        for name, loop in regions.items():
            if not loop.reducer.fused:
                raise ValueError(f"region {name!r}: sub-masters need the "
                                 f"fused flat reducer (fused=True)")
            ns.add(loop.reducer.flat_n)
        if len(ns) > 1:
            raise ValueError(f"regions disagree on parameter layout: "
                             f"flat_n in {sorted(ns)}")
        self.regions = dict(regions)
        self.config = config
        self.publish = publish or PublishConfig()
        self.network = network or RegionalNetworkModel()
        # the WAN channel: the same packed top-k + error feedback as the
        # worker uplinks, one residual per region
        self.compressor = GradientCompressor(
            method="topk", frac=config.gossip_frac, seed=config.gossip_seed)
        self._rng = np.random.RandomState(config.gossip_seed)
        self._active = set(self.regions)
        # ghosts: the public copy x_hat every peer mirrors; starts equal
        # to the region's params (the reducer never writes its buffer in
        # place, so holding it is holding a snapshot)
        self._ghosts: Dict[str, torch.Tensor] = {
            r: self.regions[r].reducer.flat_params
            for r in sorted(self.regions)}
        self._residuals: Dict[str, Optional[torch.Tensor]] = {
            r: None for r in sorted(self.regions)}
        self._inner_vectors: Dict[str, int] = {
            r: 0 for r in sorted(self.regions)}
        self.outer_step = 0
        self.clock = 0.0
        self.wan_bytes = 0
        self.intra_bytes = 0
        self.history: List[OuterLog] = []
        self._notes: List[str] = []

    # ------------------------------------------------------------------
    @property
    def live_regions(self) -> List[str]:
        return sorted(self._active)

    def region(self, name: str) -> MasterEventLoop:
        return self.regions[name]

    def submit(self, region: str, ev) -> None:
        """Route a worker-level elastic event to its region's loop."""
        self.regions[region].submit(ev)

    def consensus_flat(self) -> torch.Tensor:
        """Plain mean of the live regions' parameter buffers (summed in
        sorted order) — what a checkpoint reader or the serving side
        should call "the model"."""
        live = self.live_regions
        acc = self.regions[live[0]].reducer.flat_params
        for r in live[1:]:
            acc = acc + self.regions[r].reducer.flat_params
        # a tensor divisor: the card divides by a host scalar as a
        # multiply by its reciprocal, which rounds differently
        return acc / torch.tensor(len(live), dtype=torch.float32,
                                  device=acc.device)

    @property
    def params(self) -> PyTree:
        first = self.regions[self.live_regions[0]].reducer
        return first._spec.unflatten(self.consensus_flat())

    # ------------------------------------------------------------------
    # regional churn: the elastic join/leave machinery, one level up
    # ------------------------------------------------------------------
    def leave_region(self, name: str) -> None:
        """Park a whole region mid-run (WAN partition, datacenter
        maintenance): its loop keeps all state but stops iterating and
        drops out of the gossip. Ghost/residual/weights go with it — a
        rejoin re-seeds from consensus."""
        if name not in self._active:
            return
        self._active.discard(name)
        self._ghosts.pop(name, None)
        self._residuals.pop(name, None)
        self._inner_vectors.pop(name, None)
        self._notes.append(f"region-leave:{name}")

    def join_region(self, name: str,
                    loop: Optional[MasterEventLoop] = None) -> None:
        """(Re)activate a region, re-seeded to the current consensus (as a
        joining worker receives the master's params) with its clock
        fast-forwarded to the global clock."""
        if loop is not None:
            if not loop.reducer.fused:
                raise ValueError(f"region {name!r}: sub-masters need the "
                                 f"fused flat reducer (fused=True)")
            self.regions[name] = loop
        if name not in self.regions:
            raise ValueError(f"unknown region {name!r}: pass its loop on "
                             f"first join")
        lp = self.regions[name]
        consensus = self.consensus_flat() if self._active else None
        if consensus is not None:
            lp.reducer.apply_outer_delta(consensus - lp.reducer.flat_params)
        lp.clock = max(lp.clock, self.clock)
        self._active.add(name)
        self._ghosts[name] = lp.reducer.flat_params
        self._residuals[name] = None
        self._inner_vectors[name] = 0
        self._notes.append(f"region-join:{name}")

    # ------------------------------------------------------------------
    def _outer_exchange(self, live: List[str]):
        """Compressed publish + gossip + correction over the live regions.
        Returns (WAN bytes, WAN wall seconds)."""
        cfg = self.config
        round_bytes = 0
        wan_wall = 0.0
        for r in live:
            red = self.regions[r].reducer
            delta = red.flat_params - self._ghosts[r]
            msg, new_res = self.compressor.compress_flat(
                delta, self._residuals[r], step=self.outer_step)
            self._residuals[r] = new_res
            self._ghosts[r] = self._ghosts[r] + msg.dense()
            nbytes = msg.wire_bytes()
            # every peer mirrors the ghost, so a publish fans out to the
            # other R-1 sub-masters; uplinks run in parallel across
            # regions
            round_bytes += nbytes * (len(live) - 1)
            wan_wall = max(wan_wall, self.network.wan_time(
                nbytes * (len(live) - 1)))
        ghosts = [self._ghosts[r] for r in live]
        weights = [float(self._inner_vectors[r]) for r in live]
        mixed = gossip_round(ghosts, self._rng, weights)
        for r, old, new in zip(live, ghosts, mixed):
            self.regions[r].reducer.apply_outer_delta(
                cfg.gossip_lr * (new - old))
            self._inner_vectors[r] = 0
        return round_bytes, wan_wall

    def iteration(self) -> OuterLog:
        """One outer step: H inner reduces per live region, barrier,
        compressed publish, gossip, correction, WAN clock sync."""
        self.outer_step += 1
        notes, self._notes = self._notes, []
        live = self.live_regions
        cfg = self.config

        # ---- inner phase: each sub-master runs the paper's loop ----
        vectors = 0
        loss_num, loss_den = 0.0, 0
        for r in live:
            logs = self.regions[r].run(cfg.inner_steps)
            v = sum(lg.vectors for lg in logs)
            vectors += v
            self._inner_vectors[r] += v
            self.intra_bytes += sum(lg.wire_bytes for lg in logs)
            for lg in logs:
                if np.isfinite(lg.loss) and lg.vectors > 0:
                    loss_num += lg.loss * lg.vectors
                    loss_den += lg.vectors
        loss = loss_num / loss_den if loss_den else float("nan")

        # ---- barrier: the outer exchange waits for the slowest region
        t = max((self.regions[r].clock for r in live), default=self.clock)
        t = max(t, self.clock)

        # ---- outer phase ----
        round_bytes, wan_wall = 0, 0.0
        if cfg.gossip and len(live) >= 2:
            round_bytes, wan_wall = self._outer_exchange(live)
        self.wan_bytes += round_bytes

        # ---- clock sync: regions leave the exchange together ----
        self.clock = t + wan_wall
        for r in live:
            self.regions[r].clock = self.clock

        spread = 0.0
        flats = [self.regions[r].reducer.flat_params for r in live]
        for i in range(len(flats)):
            for j in range(i + 1, len(flats)):
                spread = max(spread,
                             float((flats[i] - flats[j]).abs().max()))
        log = OuterLog(
            outer_step=self.outer_step, clock=self.clock, vectors=vectors,
            loss=loss, wan_bytes=round_bytes, wan_time=wan_wall,
            spread=spread,
            region_steps={r: self.regions[r].step for r in live},
            events=notes)
        self.history.append(log)
        if self.publish.fn is not None and self.publish.every > 0 \
                and self.outer_step % self.publish.every == 0:
            self.publish.fn(self.params, self.outer_step, self.clock)
        return log

    def run(self, n_outer: int, callback=None) -> List[OuterLog]:
        out = []
        for _ in range(n_outer):
            log = self.iteration()
            out.append(log)
            if callback:
                callback(log)
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "outer_steps": self.outer_step,
            "clock": self.clock,
            "regions": self.live_regions,
            "wan_bytes": int(self.wan_bytes),
            "intra_bytes": int(self.intra_bytes),
            "wan_bytes_frac": (self.wan_bytes
                               / max(self.wan_bytes + self.intra_bytes, 1)),
            # the local-SGD lens: gossiping every H inner steps is a 1/H
            # cross-region communication ratio before compression
            "communication_ratio": communication_ratio(
                self.config.inner_steps),
        }

    # ------------------------------------------------------------------
    # TrainState snapshot: each sub-master loop's state plus the outer
    # tier's. The shared cluster is captured separately by
    # checkpoint/io.py, as for a flat loop.
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "outer_step": self.outer_step,
            "clock": self.clock,
            "wan_bytes": int(self.wan_bytes),
            "intra_bytes": int(self.intra_bytes),
            "rng": SimulatedCluster._rng_state(self._rng),
            "active": sorted(self._active),
            "notes": list(self._notes),
            "history": [asdict(lg) for lg in self.history],
            "ghosts": {r: _host(g) for r, g in sorted(self._ghosts.items())},
            "residuals": {r: (_host(v) if v is not None else None)
                          for r, v in sorted(self._residuals.items())},
            "inner_vectors": {r: int(v) for r, v in
                              sorted(self._inner_vectors.items())},
            "regions": {r: self.regions[r].state_dict()
                        for r in sorted(self.regions)},
        }

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        if sorted(self.regions) != sorted(st["regions"]):
            raise ValueError(
                f"region mismatch: snapshot has {sorted(st['regions'])}, "
                f"this hierarchy was built with {sorted(self.regions)}")
        dev = self.regions[sorted(self.regions)[0]].reducer.device

        def tensor(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        self.outer_step = int(st["outer_step"])
        self.clock = float(st["clock"])
        self.wan_bytes = int(st["wan_bytes"])
        self.intra_bytes = int(st["intra_bytes"])
        SimulatedCluster._set_rng_state(self._rng, st["rng"])
        self._active = set(str(r) for r in st["active"])
        self._notes = [str(n) for n in st["notes"]]
        self.history = [OuterLog(**lg) for lg in st["history"]]
        self._ghosts = {r: tensor(g) for r, g in st["ghosts"].items()}
        self._residuals = {r: (tensor(v) if v is not None else None)
                           for r, v in st["residuals"].items()}
        self._inner_vectors = {r: int(v)
                               for r, v in st["inner_vectors"].items()}
        for r in sorted(self.regions):
            self.regions[r].load_state_dict(st["regions"][r])
