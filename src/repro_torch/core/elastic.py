"""Elastic membership: the master's event queue + worker registry.

A copy of ``repro.core.elastic`` (pure Python): the port never imports
the JAX package, and identical code keeps every decision bit-equal.

MLitB §3.2: "Participants are free to leave (or join) the network at
anytime ... MLitB must robustly handle new and lost clients, re-allocation
of data, and client variability."

Events are processed at iteration boundaries ("New clients must also wait
until the end of an iteration before joining a network", §3.2-Master
Server); worker loss is detected immediately and handled at the next
boundary (footnote 5: the master knows immediately when a tab closes).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Sequence, Union


@dataclass(frozen=True)
class JoinEvent:
    worker: str
    capacity: int = 3000


@dataclass(frozen=True)
class LeaveEvent:
    worker: str


@dataclass(frozen=True)
class UploadDataEvent:
    indices: Sequence[int]


Event = Union[JoinEvent, LeaveEvent, UploadDataEvent]


class EventQueue:
    def __init__(self):
        self._pending: List[Event] = []

    def push(self, ev: Event) -> None:
        self._pending.append(ev)

    def drain(self) -> List[Event]:
        evs, self._pending = self._pending, []
        return evs

    def __len__(self) -> int:
        return len(self._pending)


@dataclass
class WorkerRecord:
    worker: str
    capacity: int
    joined_at_step: int
    live: bool = True


class WorkerRegistry:
    def __init__(self):
        self.records: Dict[str, WorkerRecord] = {}

    def join(self, worker: str, capacity: int, step: int) -> None:
        self.records[worker] = WorkerRecord(worker, capacity, step)

    def leave(self, worker: str) -> None:
        if worker in self.records:
            self.records[worker].live = False

    def live_workers(self) -> List[str]:
        return sorted(w for w, r in self.records.items() if r.live)

    def __contains__(self, worker: str) -> bool:
        r = self.records.get(worker)
        return r is not None and r.live

    # -- TrainState snapshot (docs/elastic_training.md) ----------------
    def state_dict(self) -> Dict[str, Any]:
        return {"records": {w: asdict(r) for w, r in self.records.items()}}

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.records = {
            w: WorkerRecord(d["worker"], int(d["capacity"]),
                            int(d["joined_at_step"]), bool(d["live"]))
            for w, d in st["records"].items()}
