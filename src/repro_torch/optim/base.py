"""Minimal functional optimizer interface (port of ``repro.optim.base``).

An Optimizer is (init, update):
  state  = opt.init(params)
  params, state = opt.update(params, grads, state)

``params`` is one tensor (the reducer's flat buffer) or a nested dict of
tensors. Every update rule is elementwise and FUNCTIONAL: it returns new
tensors and never writes to ``params``, ``grads`` or ``state``, so trees
handed out before a step (a worker's params, a published snapshot) keep
their values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.flatbuf import tree_map

PyTree = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]


def leaf_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over a single tensor, or over the leaves of a nested dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree_map(fn, tree, *rest)


def step_zero(params: PyTree) -> torch.Tensor:
    """The int32 step counter, on the parameters' device."""
    leaf = params
    while not isinstance(leaf, torch.Tensor):
        leaf = leaf[sorted(leaf.keys())[0]]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)
