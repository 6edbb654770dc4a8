"""The mesh driver's cells on the CPU: four rows of 32 tokens a step,
and the faults a mesh step can have."""
from __future__ import annotations

from perfbench.tests.support import still_optimizer

SMALL_TRAFFIC = dict(batch=4, seq=32, n_tokens=5000)
TOL: dict = {}


def _wrap_step(monkeypatch, wrap):
    from repro_torch.train import step as step_mod

    real = step_mod.build_train_step

    def build(*a, **kw):
        return wrap(real(*a, **kw))
    monkeypatch.setattr(step_mod, "build_train_step", build)


def half_batch(monkeypatch):
    """The second half of each step's rows masked out: the mean over the
    rest."""
    def wrap(fn):
        def half(state, batch):
            batch = dict(batch)
            mask = batch["mask"].clone()
            mask[mask.shape[0] // 2:] = 0.0
            batch["mask"] = mask
            return fn(state, batch)
        return half
    _wrap_step(monkeypatch, wrap)


def altered_answer(monkeypatch):
    """The step's loss off by 1e-3 where it is produced."""
    def wrap(fn):
        def altered(state, batch):
            state, m = fn(state, batch)
            return state, {**m, "loss": m["loss"] * 1.001}
        return altered
    _wrap_step(monkeypatch, wrap)


FAULTS = {"still": still_optimizer, "half_batch": half_batch,
          "altered_answer": altered_answer}
