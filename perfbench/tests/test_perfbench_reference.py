"""The reference against the program at ``.reduced()`` sizes on the CPU:
each cell's harness run (the program's ``ElasticMeshSGD`` over
``build_train_step``, or ``build_training``'s fleet with its
``MasterReducer``) is judged by the reference's first steps.

Tolerances: both sides compute in float32 and differ only in the order
of their sums, so the losses agree to ~1e-7 and the gradients' leaf
norms to ~1e-6; the parameters' change follows AdaGrad's sign(g) on
entries whose gradient is near 0, and top-k picks at the threshold, so
it is held to 1e-3. A driver's test module may hold a number otherwise
(``TOL``: the fleet's first gradient)."""
from __future__ import annotations

import pytest

from perfbench.tests.support import CELLS, driver_tests, run_small

TOL = {"loss_gap": 1e-5, "loss1_gap": 1e-5, "grad_gap": 1e-5,
       "change_gap": 1e-3}


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    r = run_small(name, seed=2 ** 31 + 11)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert r["check"]
    tol = {**TOL, **driver_tests(name).TOL}
    for k, got in r["check"].items():
        assert got["value"] <= tol[k], (k, got)
    assert list(r)[-1] == "check"
