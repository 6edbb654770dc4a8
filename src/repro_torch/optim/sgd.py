"""Plain SGD (+ optional momentum); port of ``repro.optim.sgd``."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, leaf_map, step_zero


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        st = {"step": step_zero(params)}
        if momentum:
            st["vel"] = leaf_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        return st

    def update(params, grads, state):
        if momentum:
            vel = leaf_map(lambda v, g: momentum * v + g.float(),
                           state["vel"], grads)
            new_params = leaf_map(
                lambda p, v: (p.float() - lr * v).to(p.dtype), params, vel)
            return new_params, {"vel": vel, "step": state["step"] + 1}
        new_params = leaf_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_params, {"step": state["step"] + 1}

    return Optimizer("sgd", init, update)
