"""The program's spans and counters reach the per-layer readers: a traced
run turns ``repro_torch.tracing`` on for its window alone and hands what
it drained to the readers (``harness.Run.program_spans``, ``counters``);
an untraced run never turns it on. On the CPU the device profile is
stood in for (it needs the card), and the driver's own CUDA-event timings
are taken on the host's clock."""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from perfbench.tests.support import CELLS, ROOT, harness, run_small, small_cell

TRACED = [n for n in CELLS
          if "forward_ms" in harness.load_cell(ROOT, n).per_layer]


@pytest.mark.parametrize("name", TRACED)
def test_traced_window_hands_readers_the_programs_spans(monkeypatch, name):
    from repro_torch import tracing

    from perfbench import devtrace
    from perfbench.drivers import Spans

    runs, profiled = [], []
    real = harness._read

    def read(kind, metric, data):
        runs.append(data)
        return real(kind, metric, data)

    def profile(step, n):
        profiled.append(tracing.enabled())
        return devtrace.TraceData(steps=n, window_s=1.0, busy_s=1.0)
    monkeypatch.setattr(harness, "_read", read)
    monkeypatch.setattr(devtrace, "profile_steps", profile)
    monkeypatch.setattr(Spans, "device", Spans.host)
    r = harness.run(small_cell(name), 2 ** 31 + 17, 0.05, True, "cpu", 0.0)
    assert r["correct"] is True, r["check"]
    assert profiled == [False] and not tracing.enabled()
    run = runs[0]
    steps = len(run.steps)
    for metric, span in (("forward_ms", "train.forward"),
                         ("backward_ms", "train.backward")):
        calls = run.program_spans[span]
        assert len(calls) == steps and min(calls) > 0
        assert r["metrics"][metric]["value"] == sum(calls) / steps
    assert run.counters["gemm_3xtf32.launches"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_untraced_window_leaves_tracing_off(monkeypatch, name):
    from repro_torch import tracing

    driver = importlib.import_module(
        f"perfbench.drivers.{small_cell(name).traffic['driver']}").Driver
    seen = []
    real = driver.step

    def step(self):
        seen.append(tracing.enabled())
        return real(self)
    monkeypatch.setattr(driver, "step", step)
    run_small(name, seed=2 ** 31 + 19)
    assert seen and not any(seen)


def test_program_spans_take_device_time_and_leave_out_a_capped_drain():
    def drained(dropped):
        records = [SimpleNamespace(name="a", device_ms=2.5, host_ns=9e6),
                   SimpleNamespace(name="b", device_ms=None, host_ns=3e6),
                   SimpleNamespace(name="a", device_ms=1.5, host_ns=9e6)]
        return SimpleNamespace(drain=lambda: SimpleNamespace(
            records=records, counters={"k": 4}, dropped=dropped))
    assert harness.program_spans(drained(0)) == (
        {"a": [2.5, 1.5], "b": [3.0]}, {"k": 4})
    assert harness.program_spans(drained(1)) == ({}, {"k": 4})
