"""Weights made from the seed, on the device, in one draw.

Every ``("normal", std)`` leaf of ``reference.models.layout`` is a slice
of ONE ``torch.randn`` of all their entries from a ``torch.Generator``
on the device seeded with ``--seed``, scaled by its std; the rest are
filled. The same seed on the same device gives the same weights, so the
reference makes them again for itself instead of taking the program's.
The program is handed them as its nested parameter tree (``nest``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.reference.models import layout

SEED_MOD = 2 ** 63


def make(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` in float32 (the configurations' precision)."""
    device = torch.device(device)
    spec = layout(cfg)
    sizes = {path: _numel(shape) for path, shape, init in spec
             if init[0] == "normal"}
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    draw = torch.randn(sum(sizes.values()), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for path, shape, init in spec:
        if init[0] == "normal":
            n = sizes[path]
            out[path] = draw[at:at + n].view(shape).mul_(init[1])
            at += n
        elif init[0] == "ones":
            out[path] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif init[0] == "a_log":
            heads = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                             device=device))
            out[path] = heads.expand(shape).contiguous()
        else:
            raise ValueError(f"{path}: unknown init {init!r}")
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return root


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
