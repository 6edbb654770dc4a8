"""AdaGrad — the paper's optimizer (MLitB §3.6, citing Duchi et al. [31]);
port of ``repro.optim.adagrad``.

    G_t  = G_{t-1} + g_t^2
    w_t  = w_{t-1} - lr * g_t / (sqrt(G_t) + eps)

``init_accum`` is G_0 (default 0.0 keeps the cited formula exact); ``eps``
stays outside the square root. State ``{"accum", "step"}``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, leaf_map, step_zero


def adagrad(lr: float = 0.01, eps: float = 1e-8,
            accum_dtype=None, init_accum: float = 0.0) -> Optimizer:
    def init(params):
        return {"accum": leaf_map(
            lambda p: torch.full(p.shape, init_accum,
                                 dtype=accum_dtype or torch.float32,
                                 device=p.device), params),
            "step": step_zero(params)}

    def update(params, grads, state):
        new_acc32 = leaf_map(lambda acc, g: acc.float() + torch.square(
            g.float()), state["accum"], grads)

        def step(p, g, acc32):
            delta = lr * g.float() / (torch.sqrt(acc32) + eps)
            return (p.float() - delta).to(p.dtype)

        new_params = leaf_map(step, params, grads, new_acc32)
        new_acc = leaf_map(lambda a, old: a.to(old.dtype), new_acc32,
                           state["accum"])
        return new_params, {"accum": new_acc, "step": state["step"] + 1}

    return Optimizer("adagrad", init, update)
