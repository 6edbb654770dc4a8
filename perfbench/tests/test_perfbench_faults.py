"""The check catches what a broken timed path does: each fault is planted
in the program underneath a CPU run of the harness at ``.reduced()``
sizes (the look for a card skipped), and ``correct`` comes out false.

Every cell of ``BENCHMARK.json`` is run under every fault of its
driver's test module (``perfbench/tests/drivers/<driver>.py``):

- a step that returns its state unchanged (the optimizer's update keeps
  the parameters and its own state);
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced (a loss off by 1e-3);
- for the fleet, a reply's count of rows off by one.

The exchange between chips is not a fault these one-chip cells can
have."""
from __future__ import annotations

import pytest

from perfbench.tests.support import CELLS, driver_tests, run_small

CASES = [(name, fault) for name in CELLS
         for fault in sorted(driver_tests(name).FAULTS)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(monkeypatch, name, fault):
    driver_tests(name).FAULTS[fault](monkeypatch)
    r = run_small(name, seed=2 ** 31 + 5)
    assert r["correct"] is False, r["check"]
