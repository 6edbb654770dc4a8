"""Activation sharding constraints (the counterpart of
``repro.distributed.activation_sharding``).

In the reference, ``constrain_batch`` pins every block's (B, ..., d)
activations to batch-sharded / otherwise replicated, so that GSPMD
all-gathers the (small) FSDP weights instead of all-reducing the (large)
activations. The port needs no such hint: its sharded step
(``distributed/sharded_step.py``) runs per rank, every rank already holds
only its batch rows, and the weights are gathered explicitly. So
``constrain_batch`` is the identity, and ``activation_sharding`` only
records the batch axes. The port's blocks do not call it.
"""
from __future__ import annotations

import contextlib
from typing import Tuple, Union

_STATE = {"batch": None, "on": False}


@contextlib.contextmanager
def activation_sharding(batch_axes: Union[str, Tuple[str, ...], None]):
    """Record ``batch_axes`` (None = replicated batch) for the block."""
    old = dict(_STATE)
    _STATE.update(batch=batch_axes, on=True)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def constrain_batch(x):
    """The identity: each rank's activations already hold its rows."""
    return x
