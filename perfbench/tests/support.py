"""Shared by the benchmark's CPU tests: the repository root on the path,
the cells of ``BENCHMARK.json``, and a cell cut to the CPU (the
``.reduced()`` sizes of the configuration its file gives the program,
and the traffic's sizes from its driver's test module,
``perfbench/tests/drivers/<driver>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def driver_tests(name: str):
    """The test module of cell ``name``'s driver: ``SMALL_TRAFFIC`` (the
    traffic's sizes on the CPU), ``TOL`` (tolerances of the reference
    test that differ from its defaults) and ``FAULTS`` (fault name ->
    ``plant(monkeypatch)``)."""
    driver = harness.load_cell(ROOT, name).traffic["driver"]
    return importlib.import_module(f"perfbench.tests.drivers.{driver}")


def small_cell(name: str) -> harness.Cell:
    """Cell ``name`` at the CPU's sizes: the ``.reduced()`` sizes of the
    configuration the program runs from the cell's file (so a cut the
    file declares, such as the experts held, runs here too)."""
    from perfbench.drivers import program_config

    cell = harness.load_cell(ROOT, name)
    cfg = dataclasses.asdict(program_config(cell.config).reduced())
    cell.config = {**cell.config, **cfg}
    cell.traffic = {**cell.traffic, **driver_tests(name).SMALL_TRAFFIC}
    return cell


def run_small(name: str, seed: int = 3):
    return harness.run(small_cell(name), seed, 0.05, False, "cpu", 0.0)


def still_optimizer(monkeypatch):
    """A step that returns its state unchanged: AdaGrad's update keeps
    the parameters and its own state."""
    import repro_torch.core  # noqa: F401  (``repro_torch.optim`` alone
    # imports itself in a circle through ``core.reducer``)
    import repro_torch.optim as optim
    from repro_torch.optim.base import Optimizer

    real = optim.adagrad

    def adagrad(**kw):
        opt = real(**kw)
        return Optimizer(opt.name, opt.init, lambda p, g, s: (p, s))
    monkeypatch.setattr(optim, "adagrad", adagrad)
