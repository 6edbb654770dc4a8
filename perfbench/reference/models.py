"""The model a configuration names, as plain float32 PyTorch: a thin
lookup of its family's module, ``perfbench.reference.families.<arch_type>``
(the interface and the pieces families share are in that package).

``layout(cfg)`` lists every parameter as ``(path, shape, init)``;
``nll_sum(params, cfg, tokens, labels, mask, num)`` is the family's
``Loss`` over the rows given. ``cfg`` is the configuration file's
dictionary (``perfbench/configs``).
"""
from __future__ import annotations

import importlib

from perfbench.reference import families
from perfbench.reference.families import Layout, Loss, Params
from perfbench.reference.numerics import Numerics


def family(cfg: dict):
    """The module of ``cfg``'s ``arch_type``."""
    name = f"{families.__name__}.{cfg['arch_type']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"the reference has no {cfg['arch_type']!r} family: "
                         f"no module {name}") from None


def layout(cfg: dict) -> Layout:
    return family(cfg).layout(cfg)


def nll_sum(p: Params, cfg: dict, tokens, labels, mask,
            num: Numerics) -> Loss:
    return family(cfg).nll_sum(p, cfg, tokens, labels, mask, num)
