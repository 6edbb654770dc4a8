"""The yardstick as it was before each model family moved into a module of
its own (``reference/families/``): the weights a seed makes, the FLOPs a
trained token, and the numbers each cell's check compares, pinned bit for
bit. Each constant was read from the code before the move, on the CPU
with one thread (``conftest.py``), at ``.reduced()`` sizes where a model
runs."""
from __future__ import annotations

import hashlib

import pytest

from perfbench import flops, weights
from perfbench.tests.support import BENCH, ROOT, harness, run_small, small_cell

SEED = 2 ** 31 + 7
CHECK_SEED = 2 ** 31 + 13

# sha256 over each leaf's path and bytes, in ``weights.make``'s order
WEIGHTS = {
    "mlitb-lm-100m":
        "246866c979da4b5837a714ee30945cf7aefeb1d795df44b1d924a7f18dff0516",
    "mamba2-780m":
        "dd07f2616da8615f5cdd95f95ceb4491fc9ff53672ff34a026da65a8b0e67357",
}
# ``flops.train_flops_per_token`` at the cell's full size and sequence
FLOPS = {
    "mesh.mlitb-lm-100m": 660_658_176,
    "mesh.mamba2-780m": 4_960_659_456,
    "fleet.mlitb-lm-100m": 604_919_808,
}
# ``run_small``'s check at CHECK_SEED
CHECK = {
    "mesh.mlitb-lm-100m": {"loss_gap": 1.7372897133859968e-07,
                           "grad_gap": 7.085373420307252e-08,
                           "change_gap": 7.556223316659331e-07},
    "mesh.mamba2-780m": {"loss1_gap": 5.729712391929746e-08,
                         "grad_gap": 3.519976516135649e-07,
                         "change_gap": 2.6912779671985837e-05},
    "fleet.mlitb-lm-100m": {"loss_gap": 2.720623264873139e-08,
                            "grad_gap": 2.026127134021614e-08,
                            "change_gap": 6.303632961697506e-09},
}


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_weights_are_the_same_bits(config):
    first = next(w["name"] for w in BENCH["workloads"]
                 if w["config"] == config)
    h = hashlib.sha256()
    for path, leaf in weights.make(small_cell(first).config, SEED,
                                   "cpu").items():
        h.update(path.encode())
        h.update(leaf.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[config]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_per_token_are_the_same(name):
    cell = harness.load_cell(ROOT, name)
    assert flops.train_flops_per_token(cell.config, cell.traffic["seq"]) \
        == FLOPS[name]


@pytest.mark.parametrize("name", sorted(CHECK))
def test_checked_numbers_are_the_same_bits(name):
    got = run_small(name, seed=CHECK_SEED)["check"]
    assert {k: v["value"] for k, v in got.items()} == CHECK[name]
