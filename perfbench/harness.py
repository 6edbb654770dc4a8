"""One run of one cell: set-up, the measured window, the traced steps,
the check against the reference, and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (and by its ``arch_type`` the reference's family
module, ``reference/families/<arch_type>.py``), its traffic mix
``workloads/<traffic>.json`` (which names its driver
``drivers/<driver>.py``), its limits ``limits/<cell>.json``, and a
reader module for each of its metrics
(``endtoend/<name>.py``, ``metrics/<name>.py``). A metric named
``<reader>.<variant>`` is read by ``<reader>``'s module: one quantity,
named apart in cells that report another end-to-end metric (the fleet's
``train_tokens_per_s.fleet``, held to a bound of its own, and the
per-layer metrics that move it).

The window runs whole steps until ``--seconds`` have passed; each step
ends synchronised, so its rate is all the window's work over all its
time. In a trace run the program's own spans and counters
(``repro_torch.tracing``) are on for the window alone, drained into
``Run`` after it; the run then profiles a few more steps with them off.
The program's state is freed, and the device's peak read, before the
reference runs.
"""
from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from perfbench.flops import peak_flops
from perfbench.reference.train import compare

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: Dict[str, str]          # name -> unit
    per_layer: Dict[str, str]


@dataclass
class Window:
    tokens: float
    seconds: float
    flops: float
    peak_flops: float
    setup_s: float


@dataclass
class Run:
    trace: object = None
    spans: Dict[str, List[float]] = field(default_factory=dict)
    program_spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    steps: List[float] = field(default_factory=list)
    peak_window_bytes: int = 0
    flops_per_token: float = 0.0
    peak_flops: float = 0.0


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = root / "perfbench"

    def applies(metric):
        return name in metric.get("workloads", [name])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads((here / "workloads" /
                            f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end={m["name"]: m["unit"] for m in bench["end_to_end"]
                    if applies(m)},
        per_layer={m["name"]: m["unit"] for m in bench["per_layer"]
                   if applies(m)})


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """The result line's object; the numbers compared are under its last
    key, ``check``."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    before = time.perf_counter() - t0
    drv = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(
            cell, seed, device, trace)
    drv.setup()
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    setup_s = start - t0
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                [("imports", before), *drv.phases.items()]),
          file=sys.stderr)
    if trace:
        from repro_torch import tracing
        tracing.reset()
        tracing.enable()
    steps, tokens, failed = [], 0.0, 0
    try:
        while True:
            a = time.perf_counter()
            st = drv.step()
            b = time.perf_counter()
            steps.append(1e3 * (b - a))
            tokens += st.tokens
            failed += int(st.failed)
            if b - start >= seconds:
                break
    finally:
        if trace:
            tracing.disable()
    window = Window(tokens=tokens, seconds=b - start,
                    flops=tokens * drv.flops_per_token,
                    peak_flops=peak_flops(drv.precision), setup_s=setup_s)
    out_run = Run(steps=steps, flops_per_token=drv.flops_per_token,
                  peak_flops=window.peak_flops)
    if cuda:
        out_run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
        peak = max(peak, out_run.peak_window_bytes)
    if trace:
        drv.spans.flush()
        out_run.spans = {k: list(v) for k, v in drv.spans.ms.items()}
        out_run.program_spans, out_run.counters = program_spans(tracing)
        from perfbench.devtrace import profile_steps
        out_run.trace = profile_steps(drv.step, int(cell.traffic[
            "trace_steps"]))
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    drv.release()
    prog, ref = drv.check()
    numbers = compare(prog, ref)

    if trace:
        metrics = {n: _read("metrics", n, out_run) for n in cell.per_layer}
        units = cell.per_layer
    else:
        metrics = {n: _read("endtoend", n, window) for n in cell.end_to_end}
        units = cell.end_to_end
    result = {
        "correct": judge(numbers, cell.limits),
        "attempted": len(steps),
        "failed": failed,
        "metrics": {n: {"value": v, "unit": units[n]}
                    for n, v in metrics.items() if v is not None},
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace:
        t = out_run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops,
                               "idle_gaps": t.idle_gaps}
    result["check"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in cell.limits.items()}
    return result


def program_spans(tracing):
    """The program's spans drained (name -> ms of each call: by its CUDA
    events where it ran on the card, else on the host's clock) and its
    counters (name -> count since the reset). Spans past the program's
    cap on records would be missing calls: then none are handed on."""
    drained = tracing.drain()
    ms: Dict[str, List[float]] = {}
    if drained.dropped:
        print(f"spans: {drained.dropped} records past the cap; the spans' "
              "metrics are left out", file=sys.stderr)
    else:
        for r in drained.records:
            ms.setdefault(r.name, []).append(
                r.device_ms if r.device_ms is not None else 1e-6 * r.host_ns)
    return ms, drained.counters


def reader(kind: str, name: str):
    """The ``read`` function of metric ``name`` (``kind``: ``endtoend`` or
    ``metrics``), found by the name's part before the first dot."""
    return importlib.import_module(
        f"perfbench.{kind}.{name.split('.')[0]}").read


def _read(kind: str, name: str, data):
    v = reader(kind, name)(data)
    return None if v is None else float(v)


def _finite(x):
    """``x`` with every non-finite number as null, so the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(args, root: Path, t0: float) -> int:
    cell = load_cell(root, args.workload)
    import torch

    # one process, few threads: the program's host work is a single
    # Python thread, and idle intra-op threads only contend on a shared host
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("error: no CUDA device; this benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    # after the window and the check, in the process that prints the line
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded {', '.join(bad)}", file=sys.stderr)
        return 5
    card = power_limit()
    result["device"]["card"] = card
    print(f"card: {card}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0
