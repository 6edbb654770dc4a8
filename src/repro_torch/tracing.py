"""The port's spans and counters: where a step's time goes, seen from
inside the program.

``span(name, device=None)`` marks a phase of the program at a layer
boundary (``mesh.step``, ``train.forward``, ``fleet.map``, ...)::

    with tracing.span("train.forward", device=dev):
        ...

Tracing is off by default. Off, ``span`` returns one shared no-op object
after a single flag check: it reads no clock, records no CUDA event and
calls no profiler. On (``enable()``), each span records its name, the id
of its parent (the innermost span open on the thread), a step id shared
by every span under one outermost span (one ``ElasticMeshSGD.step``, one
``MasterEventLoop.iteration``), and its start and end on the host's
``perf_counter_ns`` clock. ``device=`` names the device the span's work
runs on: on a CUDA device the span also records a pair of CUDA events
on the current stream. While a
``torch.profiler`` is recording, the span enters
``torch.profiler.record_function(name)``, so it lies on the profiler's
clock beside the device's kernels, and ``idle_by_span`` can put each
device idle gap down to the phase the host was in.

A span never synchronises: its CUDA events are read by ``drain()``,
which returns the records (name, parent, step, host ns, self ns: the host
ns less what its child spans cover, device ms) and the counters, and
clears the records. At most ``MAX_RECORDS`` records are held; past that
they are counted in ``dropped`` and not kept. There is no exporter: the
profiler's trace is the export path.

Counters share one registry, ``COUNTERS``. ``count(name, n)`` adds to a
program counter while tracing is on (``fleet.vectors_on_time``, ...).
The kernels' launch counters (``launch_counter``, ``LaunchCounter``,
re-exported by ``kernels.runtime``) count whether tracing is on or off,
since a run proves its main path went through a kernel by them.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import torch

MAX_RECORDS = 1 << 16
OUTSIDE = "outside the program"


class LaunchCounter:
    """A named count. A kernel wrapper adds one exactly where it launches
    its kernel (never on the plain path), so a run can prove its main path
    went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


# every counter, by name: the kernels' launch counters (filled as kernel
# modules import) and the program's counters (filled by ``count``)
COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    if name not in COUNTERS:
        COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


@dataclass(frozen=True)
class Record:
    name: str
    id: int
    parent: Optional[int]        # the enclosing span's id
    step: int                    # the outermost enclosing span's step
    start_ns: int                # perf_counter_ns
    host_ns: int
    self_ns: int                 # host_ns less the child spans' host_ns
    device_ms: Optional[float]   # between the span's CUDA events


class Drained(NamedTuple):
    records: List[Record]
    counters: Dict[str, int]
    dropped: int


_on = False
_records: list = []
_dropped = 0
_ids = itertools.count(1)
_steps = itertools.count(1)
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "step", "start", "end", "child_ns",
                 "events", "rf")

    def __init__(self, name: str, device):
        self.name = name
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.step = stack[-1].id, stack[-1].step
        else:
            self.parent, self.step = None, next(_steps)
        self.id = next(_ids)
        self.child_ns = 0
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += self.end - self.start
        if len(_records) < MAX_RECORDS:
            _records.append(self)
        else:
            _dropped += 1
        return False


def span(name: str, device: Union[None, str, torch.device] = None):
    """A context manager timing one phase (see the module's docstring)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program counter ``name`` while tracing is on."""
    if _on:
        launch_counter(name).count += n


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop every record and the dropped count; zero every counter."""
    global _dropped
    _records.clear()
    _dropped = 0
    reset_counters()


def drain() -> Drained:
    """The records held (in the order the spans closed), every counter's
    count and the records dropped past the cap; clears the records. A
    record's ``device_ms`` reads its CUDA events, waiting for the last:
    drain after the caller's own synchronisation, outside a timed
    window."""
    global _dropped
    spans, dropped = list(_records), _dropped
    _records.clear()
    _dropped = 0
    out = []
    for s in spans:
        ms = None
        if s.events is not None:
            s.events[1].synchronize()
            ms = s.events[0].elapsed_time(s.events[1])
        out.append(Record(name=s.name, id=s.id, parent=s.parent,
                          step=s.step, start_ns=s.start,
                          host_ns=s.end - s.start,
                          self_ns=s.end - s.start - s.child_ns,
                          device_ms=ms))
    return Drained(records=out,
                   counters={k: c.count for k, c in COUNTERS.items()},
                   dropped=dropped)


def idle_by_span(gaps: Iterable[Tuple[float, float]],
                 ranges: Iterable[Tuple[float, float, str]]
                 ) -> Dict[str, float]:
    """Each device idle gap ``(start, end)`` put down to the innermost
    host range ``(start, end, name)`` open at the gap's middle, or to
    ``OUTSIDE``: the gaps' summed length by name. Ranges of one thread
    nest, so the innermost open range is the open one that started last.
    Ranges that start together nest too: the shorter is inside, so it is
    sorted after the longer and met first. Both on one clock (a
    profiler's trace)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    starts = [a for a, _, _ in ranges]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = OUTSIDE
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ranges[i][1] >= mid:
                label = ranges[i][2]
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def _ns(ev, what: str) -> float:
    """A profiler event's start or duration in ns, across versions."""
    fn = getattr(ev, f"{what}_ns", None)
    return float(fn()) if fn is not None \
        else 1e3 * float(getattr(ev, f"{what}_us")())


def profile_idle_by_span(prof) -> Dict[str, float]:
    """``idle_by_span`` over a ``torch.profiler`` trace of CPU and CUDA
    activity taken with tracing on: the seconds the device sat idle
    between its first and last operation, by the innermost span open on
    the host (the trace's CPU-side ``record_function`` ranges)."""
    busy, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        a = _ns(ev, "start")
        b = a + _ns(ev, "duration")
        note = getattr(ev, "is_user_annotation", lambda: False)()
        if "CPU" not in str(ev.device_type()):
            if not note:
                busy.append((a, b))
        elif note:
            ranges.append((a, b, ev.name()))
    gaps, at = [], None
    for a, b in sorted(busy):
        if at is not None and a > at:
            gaps.append((at, a))
        at = b if at is None else max(at, b)
    return {k: 1e-9 * v for k, v in idle_by_span(gaps, ranges).items()}
