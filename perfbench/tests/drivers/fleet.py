"""The fleet driver's cells on the CPU: the traffic as it is, and the
faults an iteration can have.

The fleet's first gradient is the top-k picks' sum, and a pick at the
threshold that flips moves its norm by ~1e-5, so the reference test
holds it to 1e-4."""
from __future__ import annotations

from perfbench.tests.support import still_optimizer

SMALL_TRAFFIC: dict = {}
TOL = {"grad_gap": 1e-4}


def half_batch(monkeypatch):
    """The second half of the on-time replies dropped from each reduce:
    the mean over the rest."""
    from repro_torch.core.reducer import MasterReducer

    real = MasterReducer.reduce_and_step

    def reduce(self, messages, keep=None, defer=None):
        late = set(defer or ())
        on = sorted(w for w in messages if w not in late)
        drop = set(on[(len(on) + 1) // 2:])
        return real(self, {w: m for w, m in messages.items()
                           if w not in drop}, keep=keep, defer=defer)
    monkeypatch.setattr(MasterReducer, "reduce_and_step", reduce)


def altered_answer(monkeypatch):
    """A worker's loss sum off by 1e-3 where it is produced."""
    import repro_torch.core.simulation as sim

    real = sim.make_lm_problem

    def problem(*a, **kw):
        data, grad_fn = real(*a, **kw)

        def altered(params, X, y):
            g, s = grad_fn(params, X, y)
            return g, s * 1.001
        return data, altered
    monkeypatch.setattr(sim, "make_lm_problem", problem)


def wrong_count(monkeypatch):
    """Each worker's reply counts one row more than it computed, where the
    reply is made: the program divides by its own count, the reference
    by the rows it was given."""
    import dataclasses

    from repro_torch.core.simulation import SimulatedCluster

    real = SimulatedCluster.compute

    def compute(self, *a, **kw):
        res = real(self, *a, **kw)
        if res is None or not res.n_vectors:
            return res
        return dataclasses.replace(res, n_vectors=res.n_vectors + 1)
    monkeypatch.setattr(SimulatedCluster, "compute", compute)


FAULTS = {"still": still_optimizer, "half_batch": half_batch,
          "altered_answer": altered_answer, "wrong_count": wrong_count}
