"""Adam (port of ``repro.optim.adam``). State ``{"m", "step", "v"}``."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, leaf_map, step_zero


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": leaf_map(z, params), "v": leaf_map(z, params),
                "step": step_zero(params)}

    def update(params, grads, state):
        t = state["step"] + 1
        tf = t.float()
        m = leaf_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = leaf_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        c1 = 1.0 / (1 - b1 ** tf)
        c2 = 1.0 / (1 - b2 ** tf)

        def step(p, mm, vv):
            upd = (mm * c1) / (torch.sqrt(vv * c2) + eps)
            p32 = p.float()
            if weight_decay:
                upd = upd + weight_decay * p32
            return (p32 - lr * upd).to(p.dtype)

        return leaf_map(step, params, m, v), {"m": m, "v": v, "step": t}

    return Optimizer("adam", init, update)
