"""The traced run: ``torch.profiler`` over a few whole steps, reduced to
what the per-layer readers need. Two passes, so that the profiler's own
cost on the host does not pass for the program's:

1. The timeline: the device's activity alone (CUPTI adds a few
   microseconds a launch; recording every host op with its shapes costs
   tens, which starves the device in a host-bound step). Each step
   starts with a marker kernel (``torch.cuda._sleep``, ``spin_kernel``),
   launched when the device is idle, since every step before it ended in
   a synchronisation. The traced window runs from the first marker's
   start to the end of the last operation; the device is busy in the
   union of every operation (kernels, copies, fills) but the markers.
   A step's gap runs from the last kernel before its marker to its
   first kernel after it. The device operations that took most time
   come from here.
2. The attribution: one more step with the host's ops and their shapes
   recorded. Every matrix product gives its least time from its shapes
   (``products``): each ``aten::mm`` / ``addmm`` / ``bmm`` / ``baddbmm``
   on cuBLAS, and each product of the program's hand-written kernel,
   ``gemm_3xtf32_kernel``, launched by ``linear``'s autograd function:
   one in its forward (``_Linear``, whose inputs are x and w) and two in
   its backward (``_LinearBackward``, which carries its forward's
   sequence number and thread), all three at the forward's shapes. Each
   device operation is put down to the host op that launched it (the
   profiler's linked correlation). The products' device time is the
   cuBLAS ops' launches and every launch of the kernel, found by name;
   a product counts in the bound only where its op's launches ran, so
   the share never counts work whose time it does not hold. Each idle
   gap of this step is put down to the host op that started last before
   it (``after <op>`` where that op had already returned). These gaps
   are stretched by the recording; their shares are what they show.
"""
from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from perfbench.flops import (ELEMENT_BYTES, MATMULS, gemm_mnk, linear_mnk,
                             product_bound_s)

MARKER = "spin_kernel"
KERNEL = "gemm_3xtf32_kernel"
LINEAR = "_Linear"
LINEAR_BACKWARD = "_LinearBackward"
PRECISION_OF = {"float": "float32", "c10::BFloat16": "bfloat16",
                "c10::Half": "float16"}
TOP = 10
NAME_CHARS = 120


@dataclass
class TraceData:
    steps: int
    window_s: float
    busy_s: float
    tokens: float = 0.0              # trained in the timeline's steps
    step_gaps_s: List[float] = field(default_factory=list)
    gemm_bound_s: float = 0.0
    gemm_device_s: float = 0.0
    linear_flops: float = 0.0        # the kernel's products the bound counts
    kernel_launches: int = 0
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _t(ev, what: str) -> float:
    """An event's start or duration in ns, across profiler versions."""
    fn = getattr(ev, f"{what}_ns", None)
    return float(fn()) if fn is not None \
        else 1e3 * float(getattr(ev, f"{what}_us")())


def _on_device(ev) -> bool:
    return "CPU" not in str(ev.device_type())


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _gaps(busy, w0, w1) -> List[Tuple[float, float]]:
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    return gaps


def profile_steps(step: Callable[[], object], n: int) -> TraceData:
    """``step()`` returns a ``drivers.Step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            torch.cuda._sleep(1)
            tokens += step().tokens
        torch.cuda.synchronize()
    out = timeline(prof.profiler.kineto_results.events())
    out.tokens = tokens
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    attribute(list(prof.profiler.kineto_results.events()), out)
    return out


def timeline(events) -> TraceData:
    ops, markers = [], []
    totals: Dict[str, float] = {}
    for ev in events:
        if not _on_device(ev):
            continue
        name = ev.name()
        a = _t(ev, "start")
        b = a + _t(ev, "duration")
        if MARKER in name:
            markers.append(a)
            continue
        ops.append((a, b, name))
        totals[name] = totals.get(name, 0.0) + (b - a) * 1e-9
    if not markers or not ops:
        raise RuntimeError("the device trace holds no step")
    markers.sort()
    w0, w1 = markers[0], max(b for _, b, _ in ops)
    busy = [(max(a, w0), min(b, w1)) for a, b in
            _union([(a, b) for a, b, _ in ops]) if b > w0 and a < w1]
    out = TraceData(steps=len(markers), window_s=(w1 - w0) * 1e-9,
                    busy_s=sum(b - a for a, b in busy) * 1e-9)
    kernels = sorted((a, b) for a, b, name in ops
                     if not name.startswith(("Memcpy", "Memset")))
    starts = [a for a, _ in kernels]
    for m in markers[1:]:
        i = bisect.bisect_left(starts, m)
        if 0 < i < len(kernels):
            last = max(b for _, b in kernels[:i])
            out.step_gaps_s.append((kernels[i][0] - last) * 1e-9)
    out.device_ops = [[k[:NAME_CHARS], v] for k, v in
                      sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
    return out


@dataclass
class Product:
    op: int              # correlation id of the host op that launched it
    kind: str            # the op's name
    flops: float
    bound_s: float


def products(events) -> List[Product]:
    """Every matrix product that the recorded host ops launched, with its
    FLOPs and least time from the recorded shapes (module docstring)."""
    out: List[Product] = []
    forward: Dict[Tuple[int, int], Tuple[Tuple, str]] = {}
    backward = []
    for ev in events:
        if _on_device(ev):
            continue
        name = ev.name()
        if name in MATMULS:
            mnk = gemm_mnk(name, ev.shapes())
        elif name == LINEAR:
            mnk = linear_mnk(ev.shapes())
            forward[(ev.start_thread_id(), ev.sequence_nr())] = (
                mnk, _dtype(ev))
        elif name == LINEAR_BACKWARD:
            backward.append(ev)
            continue
        else:
            continue
        out.append(_product(ev.correlation_id(), name, mnk, _dtype(ev)))
    for ev in backward:
        fwd = forward.get((ev.fwd_thread_id(), ev.sequence_nr()))
        if fwd is not None:
            out += 2 * [_product(ev.correlation_id(), LINEAR_BACKWARD, *fwd)]
    return out


def _dtype(ev) -> str:
    return next((d for d in ev.dtypes() if d in ELEMENT_BYTES), "float")


def _product(op: int, kind: str, mnk, dtype: str) -> Product:
    b, M, N, K = mnk
    return Product(op, kind, 2.0 * b * M * N * K, product_bound_s(
        b, M, N, K, ELEMENT_BYTES[dtype], PRECISION_OF.get(dtype, "float32")))


def attribute(events, out: TraceData) -> None:
    """The products' bound and device time, and the idle gaps by host op,
    from one step recorded with the host's ops and shapes."""
    cpu, dev = [], []
    linked: Dict[int, List[float]] = {}      # op -> [device s, launches]
    kernel_s = 0.0
    for ev in events:
        a = _t(ev, "start")
        b = a + _t(ev, "duration")
        name = ev.name()
        if not _on_device(ev):
            cpu.append((a, b, name))
            continue
        if getattr(ev, "is_user_annotation", lambda: False)():
            continue
        dev.append((a, b))
        t = linked.setdefault(ev.linked_correlation_id(), [0.0, 0])
        t[0] += (b - a) * 1e-9
        if KERNEL in name:
            t[1] += 1
            kernel_s += (b - a) * 1e-9
            out.kernel_launches += 1
    # [FLOPs, least time, device time] of cuBLAS's products and the kernel's
    sums = {"cublas": [0.0, 0.0, 0.0], "kernel": [0.0, 0.0, kernel_s]}
    used: Dict[int, int] = {}
    for p in products(events):
        s, launches = linked.get(p.op, (0.0, 0))
        if p.kind in MATMULS:
            if s <= 0:
                continue
            part = sums["cublas"]
            part[2] += s
        elif used.get(p.op, 0) < launches:
            used[p.op] = used.get(p.op, 0) + 1
            part = sums["kernel"]
        else:
            continue
        part[0] += p.flops
        part[1] += p.bound_s
    for _, bound, device in sums.values():
        out.gemm_bound_s += bound
        out.gemm_device_s += device
    out.linear_flops = sums["kernel"][0]
    print("products: " + "; ".join(
        f"{k} {f:.6e} FLOP, least {b:.6e} s, device {d:.6e} s"
        for k, (f, b, d) in sums.items())
        + f"; {out.kernel_launches} launches of {KERNEL}", file=sys.stderr)
    if dev:
        busy = _union(dev)
        out.idle_gaps = idle_by_host(_gaps(busy, busy[0][0], busy[-1][1]),
                                     cpu)


def idle_by_host(gaps, cpu) -> List[list]:
    """Idle seconds summed by the host op that started last before each
    gap's middle, largest first."""
    cpu = sorted(cpu)
    starts = [a for a, _, _ in cpu]
    totals: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0:
            label = "before any host op"
        else:
            s, e, name = cpu[i]
            label = name if e >= mid else f"after {name}"
        totals[label] = totals.get(label, 0.0) + (b - a) * 1e-9
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
