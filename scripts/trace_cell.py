"""One benchmark cell driven with the program's spans and counters
(``repro_torch.tracing``) on, on the card: what they read, what they
cost, and where the device's idle time falls.

    python3 scripts/trace_cell.py --workload fleet.mlitb-lm-100m \\
        --seed 2147480001 --seconds 10 --windows 6

It builds the cell's ``perfbench`` driver (with its own host and CUDA
event wrappers, as a ``--trace 1`` run has them) and runs, after its
set-up:

1. the cost of a span: ns a call, off, on, and on with CUDA events;
2. ``--windows`` windows of ``--seconds`` in the order off, on, on, off,
   ...: each window's tokens a second, and in the windows with tracing
   on the spans (host and device ms a step, by name), the counters and
   the driver's own timings of the same steps;
3. ``perfbench.devtrace.profile_steps`` with tracing off (its timeline
   pass gives the traced step time);
4. a third pass: the cell's ``trace_steps`` steps under ``torch.profiler``
   (CPU and CUDA activity, no shapes) with tracing on, each device idle
   gap put down to the innermost span open on the host
   (``tracing.profile_idle_by_span``), printed as ``idle by span:``.

The last stdout line is one JSON object, also written to
``chiprun_out/trace_cell.<cell>.<seed>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
MAP = ("fleet.map", "fleet.worker", "worker.rows", "worker.forward",
       "worker.backward", "worker.readback")


def span_cost_ns(tracing, n: int = 200_000) -> dict:
    """ns a ``with tracing.span(...)`` costs over an empty loop body,
    best of five: off, on (host clock only) and on with CUDA events."""
    def best(fn):
        out = []
        for _ in range(5):
            t = time.perf_counter_ns()
            fn()
            out.append((time.perf_counter_ns() - t) / n)
        return min(out)

    def bare():
        for _ in range(n):
            pass

    def spanned(device):
        def run():
            for _ in range(n):
                with tracing.span("cost", device=device):
                    pass
        return run
    base = best(bare)
    tracing.disable()
    off = best(spanned(None))
    tracing.enable()
    on = best(spanned(None))
    on_dev = best(spanned(torch.device("cuda")))
    tracing.disable()
    tracing.reset()
    return {"off_ns": off - base, "on_ns": on - base,
            "on_device_ns": on_dev - base}


def window(drv, seconds: float, on: bool, tracing, sync) -> dict:
    drv.spans.clear()
    tracing.reset()
    if on:
        tracing.enable()
    steps, tokens = [], 0.0
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        tokens += drv.step().tokens
        b = time.perf_counter()
        steps.append(1e3 * (b - a))
        if b - start >= seconds:
            break
    tracing.disable()
    sync()
    out = {"on": on, "steps": len(steps), "seconds": b - start,
           "tokens": tokens, "tokens_per_s": tokens / (b - start)}
    if not on:
        return out
    drained = tracing.drain()
    drv.spans.flush()
    n = len(steps)
    by = {}
    for r in drained.records:
        s = by.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                   "self_ms": 0.0, "device_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += 1e-6 * r.host_ns
        s["self_ms"] += 1e-6 * r.self_ns
        s["device_ms"] += r.device_ms or 0.0
    out["spans"] = {k: {f: v / n if f != "calls" else v
                        for f, v in s.items()} for k, s in by.items()}
    out["counters"] = {k: v for k, v in drained.counters.items() if v}
    out["dropped"] = drained.dropped
    out["driver_ms"] = {k: sum(v) / n for k, v in drv.spans.ms.items()}
    out["step_ms"] = sum(steps) / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args()
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import importlib

    from perfbench import harness
    from repro_torch import tracing

    torch.set_num_threads(1)
    sync = torch.cuda.synchronize
    cell = harness.load_cell(ROOT, args.workload)
    drv = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(
            cell, args.seed, torch.device("cuda"), True)  # CUDA event timings
    t0 = time.perf_counter()
    drv.setup()
    sync()
    result = {"cell": cell.name, "seed": args.seed,
              "card": harness.power_limit(),
              "setup_s": time.perf_counter() - t0,
              "span_cost": span_cost_ns(tracing)}
    order = [i % 4 in (1, 2) for i in range(args.windows)]
    result["windows"] = [window(drv, args.seconds, on, tracing, sync)
                         for on in order]
    for on in (False, True):
        rates = [w["tokens_per_s"] for w in result["windows"]
                 if w["on"] == on]
        result["tokens_per_s_" + ("on" if on else "off")] = \
            statistics.median(rates)
    result["on_vs_off"] = (result["tokens_per_s_on"]
                           / result["tokens_per_s_off"] - 1.0)

    profile_passes(result, drv, int(cell.traffic["trace_steps"]), tracing)
    result["readings"] = readings(result, cell)
    drv.release()
    line = json.dumps(result)
    out = ROOT / "chiprun_out" / f"trace_cell.{cell.name}.{args.seed}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(line + "\n")
    print(line, flush=True)
    return 0


def profile_passes(result: dict, drv, n: int, tracing) -> None:
    """The benchmark's two passes with tracing off (the timeline's step
    time), then the third: ``n`` steps with tracing on, each device idle
    gap by span."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.devtrace import profile_steps

    tr = profile_steps(drv.step, n)
    result["timeline"] = {"steps": tr.steps, "window_s": tr.window_s,
                          "busy_s": tr.busy_s,
                          "step_s": tr.window_s / tr.steps,
                          "idle_gaps": tr.idle_gaps}
    # the benchmark's passes ran with tracing off: no span recorded
    result["passes_1_2_records"] = len(tracing.drain().records)
    tracing.reset()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            drv.step()
        torch.cuda.synchronize()
    tracing.disable()
    tracing.reset()
    idle = tracing.profile_idle_by_span(prof)
    total = sum(idle.values())
    result["idle_by_span_s"] = idle
    result["idle_s"] = total
    if total > 0:
        result["idle_attributed_share"] = \
            100.0 * (1.0 - idle.get(tracing.OUTSIDE, 0.0) / total)
        result["fleet_map_idle_share"] = \
            100.0 * sum(v for k, v in idle.items() if k in MAP) / total
    print("idle by span: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in
        sorted(idle.items(), key=lambda kv: -kv[1])), file=sys.stderr)


def readings(result: dict, cell) -> dict:
    """The six quantities a ``--trace 1`` run would read from the spans
    and counters, from the windows with tracing on pooled, and the
    checks they allow against the driver's own timings."""
    on = [w for w in result["windows"] if w["on"]]
    steps = sum(w["steps"] for w in on)

    def per_step(name, field):
        return sum(w["spans"].get(name, {}).get(field, 0.0) * w["steps"]
                   for w in on) / steps

    def driver(name):
        return sum(w["driver_ms"].get(name, 0.0) * w["steps"]
                   for w in on) / steps
    out = {}
    if cell.traffic["driver"] == "mesh":
        out["forward_ms"] = per_step("train.forward", "device_ms")
        out["backward_ms"] = per_step("train.backward", "device_ms")
        out["optimizer_ms"] = driver("optimizer")
        out["optimizer_span_ms"] = per_step("train.optimizer", "device_ms")
        out["split_of_step"] = (out["forward_ms"] + out["backward_ms"]
                                + out["optimizer_ms"]) \
            / (1e3 * result["timeline"]["step_s"])
        return out
    counters = {}
    for w in on:
        for k, v in w["counters"].items():
            counters[k] = counters.get(k, 0) + v
    out["fleet_launch_ms"] = per_step("worker.forward", "host_ms") \
        + per_step("worker.backward", "host_ms")
    out["fleet_sync_ms"] = per_step("worker.readback", "host_ms")
    out["fleet_map_idle_share"] = result.get("fleet_map_idle_share")
    out["fleet_ontime_share"] = 100.0 * counters.get(
        "fleet.vectors_on_time", 0) / max(counters.get(
            "fleet.vectors_computed", 0), 1)
    out["counters"] = counters
    out["fleet_worker_ms"] = per_step("fleet.worker", "host_ms")
    out["fleet_map_ms"] = driver("fleet.map")
    if out["fleet_map_ms"]:
        out["worker_vs_map"] = out["fleet_worker_ms"] / out["fleet_map_ms"] \
            - 1
    out["on_time_tokens"] = counters.get("fleet.vectors_on_time", 0) \
        * cell.traffic["seq"]
    out["window_tokens"] = sum(w["tokens"] for w in on)
    return out


if __name__ == "__main__":
    sys.exit(main())
