"""Drivers: one module per way of driving the program (``mesh``,
``fleet``), named by a traffic mix's ``driver`` key. Each module's
``Driver(cell, seed, device, trace)`` has

- ``setup()``: builds the program's objects from the seed's weights and
  data and drives its first steps through the window's own call,
  recording what the check compares;
- ``step()``: one whole step or iteration, synchronised, returning a
  ``Step`` (the tokens whose gradients reached the update, and whether
  it failed);
- ``flops_per_token``, ``precision``: what ``train_mfu`` counts against;
- ``spans``: host and CUDA-event timings a trace run reads (name -> ms
  of each call);
- ``release()``: frees the program's state;
- ``check(mode="f32", drop_half=False)``: runs the reference and
  returns ``(program, reference)`` traces (``reference.train.Trace``);
  ``mode="tf32"`` is the control, ``drop_half`` a fault
  (``perfbench/control.py``).
"""
from __future__ import annotations

import dataclasses
import time
import typing
from dataclasses import dataclass
from typing import Dict, List

import torch


def flat_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested tree of tensors as ``{"a/b": leaf}``."""
    out = {}
    for k in tree.keys():
        v = tree[k]
        if isinstance(v, torch.Tensor):
            out[prefix + k] = v
        else:
            out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


@dataclass
class Step:
    tokens: float
    failed: bool = False


def program_config(cfg: dict):
    """The configuration file as the program's ``ArchConfig``."""
    from repro_torch.configs.base import ArchConfig

    return _dataclass(ArchConfig, cfg)


def _dataclass(cls, values: dict):
    """``cls`` from the entries of ``values`` that name its fields, each
    nested group built as the dataclass its field's type names (``ssm``:
    ``SSMConfig``, ``moe``: ``MoEConfig``, ...) and each JSON list of a
    tuple-typed field as a tuple. A field ``values`` does not name keeps
    its default."""
    types = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v, tp = values[f.name], types[f.name]
        sub = dataclass_type(tp)
        if sub and isinstance(v, dict):
            v = _dataclass(sub, v)
        elif isinstance(v, list) and _is_tuple(tp):
            v = _tuple(v)
        kw[f.name] = v
    return cls(**kw)


def dataclass_type(tp):
    """The dataclass a field's type names, itself or inside ``Optional``."""
    for t in (tp, *typing.get_args(tp)):
        if dataclasses.is_dataclass(t):
            return t
    return None


def _is_tuple(tp) -> bool:
    return any(typing.get_origin(t) is tuple
               for t in (tp, *typing.get_args(tp)))


def _tuple(v):
    return tuple(_tuple(x) for x in v) if isinstance(v, list) else v


class Spans:
    """Named timings, one list per name. ``host(name)`` times a call on
    the host clock; ``device(name)`` with CUDA events, read once the
    device is synchronised (``flush``)."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = {}
        self._events: Dict[str, list] = {}

    def host(self, name: str, fn):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms.setdefault(name, []).append(
                    1e3 * (time.perf_counter() - t))
        return timed

    def device(self, name: str, fn):
        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self._events.setdefault(name, []).append(ev)
            return out
        return timed

    def flush(self) -> None:
        for name, evs in self._events.items():
            self.ms.setdefault(name, []).extend(
                a.elapsed_time(b) for a, b in evs)
        self._events.clear()

    def clear(self) -> None:
        self.ms.clear()
        self._events.clear()
