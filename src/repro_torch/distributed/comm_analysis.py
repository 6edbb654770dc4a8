"""Collective traffic and roofline terms (the counterpart of
``repro.distributed.hlo_analysis``).

The reference parses the compiled, SPMD-partitioned HLO text for its
communication ops (``collective_bytes(hlo_text)``, ``count_ops``,
``shape_bytes``). PyTorch runs eagerly and emits no HLO, so that parse is
not ported. In its place every collective of the port goes through one
wrapper (``distributed/collectives.py`` ``all_reduce`` / ``all_gather``)
that adds, per rank, the bytes it puts on the wire to ``COUNTER``, by op;
``collective_bytes()`` reads the counts and ``reset()`` zeroes them. The
dry-run reckons a step's schedule with the same ``wire_bytes``, so its
figures and a real run's counts are one accounting.

Byte accounting per op, the reference's (result-shape bytes B):
  all-reduce : 2B per rank (ring: reduce-scatter + all-gather)
  all-gather : B per rank (the gathered result)
The factor (n-1)/n is left out, as in the reference.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Sequence

import torch

COLLECTIVE_OPS = ("all-reduce", "all-gather")


def wire_bytes(op: str, shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes one rank puts on the wire for ``op`` with a result of
    ``shape`` / ``dtype``."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}")
    n = 1
    for d in shape:
        n *= int(d)
    b = n * torch.empty((), dtype=dtype, device="meta").element_size()
    return 2 * b if op == "all-reduce" else b


class CommCounter:
    """Per-rank wire bytes and host seconds by op. The seconds are
    the host's time inside each call; with ``sync`` set, the wrapper
    first waits for the card's queued work, so that they hold the
    collective alone (the cost: no overlap of a collective with earlier
    work)."""

    def __init__(self):
        self.bytes: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.sync = False

    def start(self, x: torch.Tensor) -> float:
        if self.sync and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def add(self, op: str, nbytes: int, t0: float) -> None:
        self.seconds[op] += time.perf_counter() - t0
        self.bytes[op] += nbytes

    def reset(self) -> None:
        self.bytes.clear()
        self.seconds.clear()


# this process's (this rank's) counts
COUNTER = CommCounter()


def collective_bytes() -> Dict[str, int]:
    """This rank's wire bytes by op since the last ``reset()``."""
    return {op: b for op, b in COUNTER.bytes.items() if b}


def reset() -> None:
    COUNTER.reset()


# ---------------------------------------------------------------------------
def roofline_terms(*, flops: float, hbm_bytes: float,
                   coll_bytes: float, n_chips: int,
                   peak_flops: float, hbm_bw: float, ici_bw: float
                   ) -> Dict[str, float]:
    """Three-term roofline (seconds) from per-rank numbers: operations
    over the peak rate, bytes over the memory rate, wire bytes over the
    interconnect's rate."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_coll = coll_bytes / ici_bw
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dom[1],
            "n_chips": n_chips}
