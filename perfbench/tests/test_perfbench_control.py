"""The control at ``.reduced()`` sizes on the CPU: the reference put in
the program's place and computed in TF32 (on a CPU, its operands
rounded to TF32's mantissa) reads far above the program on some number,
as does the reference with half of each batch left out; the program
reads within float32's rounding. The harness's own ``judge`` passes the
program and fails the fault against the cell's limits. Those limits are
set at the cell's own size, where the program's rounding is larger too:
at these sizes the control of the 48-layer SSM reads ~1000x the program
and still under them, so the control's verdict against the limits is
taken on the card, where ``control.py`` reads each cell at its own size
and prints ``control_correct``."""
from __future__ import annotations

import pytest

from perfbench.control import readings, summary
from perfbench.tests.support import CELLS, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_and_fault_read_far_above_the_program(name):
    rec = readings(small_cell(name), 2 ** 31 + 21, True, "cpu")
    s = summary([rec])
    nums = {k: v for k, v in s.items() if not k.endswith("_correct")}
    assert max(v["control"] / max(v["lower"], 1e-12)
               for v in nums.values()) >= 10, s
    assert max(v["half_batch"] / max(v["lower"], 1e-12)
               for v in nums.values()) >= 100, s
    assert s["loss_gap"]["lower"] < 1e-5
    assert rec["program_correct"] is True, s
    assert rec["half_batch_correct"] is False, s
