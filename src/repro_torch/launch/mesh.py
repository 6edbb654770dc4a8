"""Production meshes (the counterpart of ``repro.launch.mesh``).

A ``Mesh`` is a description: named axes with sizes, the reference's
(data 16, model 16) and (pod 2, data 16, model 16), so every spec and
per-rank shape of the port can be held against the JAX package's. Ranks
map to coordinates row-major over ``axis_names``, as ``jax.make_mesh``
orders devices. Nothing is allocated and no process group is needed to
describe a mesh, so the dry-runs take the production meshes as they are.

Entering the mesh (``with mesh:``) inside a ``torch.distributed`` world
of ``mesh.size`` ranks gives each set of axes its process group: for a
set of axes, the ranks that share this rank's coordinates on every other
axis. Every rank creates every group, in one order (``new_group`` is
collective). Plain ``new_group`` groups, not a ``DeviceMesh``: one code
path serves gloo (ranks may share one card) and NCCL (a card per
rank). The collectives (``distributed/collectives.py``) and the
sharded train step look the groups up on the mesh; a group of one rank
is never created and never called.
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

AxisEntry = Union[None, str, Tuple[str, ...]]


def axes_of(entry: AxisEntry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: ``None`` -> (), ``"data"`` ->
    ("data",), a tuple as it is."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: "OrderedDict[str, int]" = OrderedDict(
            (a, int(n)) for a, n in zip(axis_names, shape))
        self.size = math.prod(self.shape.values())
        self._groups: Optional[Dict[Tuple[str, ...], object]] = None
        self._rank: Optional[int] = None

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)})")

    # -- coordinates -----------------------------------------------------
    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate on every axis, row-major over
        ``axis_names``."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def axes_size(self, entry: AxisEntry) -> int:
        """How many parts a dim sharded over ``entry`` is cut into."""
        return math.prod(self.shape[a] for a in axes_of(entry))

    def chunk_index(self, entry: AxisEntry, rank: int) -> int:
        """Which part of a dim sharded over ``entry`` ``rank`` holds:
        row-major over the entry's axes, in the entry's order."""
        c = self.coords(rank)
        i = 0
        for a in axes_of(entry):
            i = i * self.shape[a] + c[a]
        return i

    def group_ranks(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks sharing ``rank``'s coordinates off ``axes``, in
        global rank order."""
        c = self.coords(rank)
        axes = set(axes)
        return [r for r in range(self.size)
                if all(v == c[a] for a, v in self.coords(r).items()
                       if a not in axes)]

    # -- process groups ----------------------------------------------------
    @property
    def rank(self) -> int:
        if self._rank is None:
            raise RuntimeError(f"{self!r} is not entered: collectives over "
                               f"it run inside 'with mesh:' in a world of "
                               f"{self.size} ranks")
        return self._rank

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} are not in {self!r}")
        return tuple(a for a in self.axis_names if a in set(axes))

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (``None`` when the
        group holds this rank alone)."""
        self.rank                                   # raises if not entered
        key = self._key(axes)
        if math.prod(self.shape[a] for a in key) == 1:
            return None
        return self._groups[key]

    def _make_groups(self) -> None:
        rank = dist.get_rank()
        groups: Dict[Tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for key in itertools.combinations(self.axis_names, n):
                if math.prod(self.shape[a] for a in key) == 1:
                    continue
                seen = set()
                for r in range(self.size):       # every group, same order
                    members = tuple(self.group_ranks(key, r))
                    if members in seen:
                        continue
                    seen.add(members)
                    g = dist.new_group(list(members))
                    if rank in members:
                        groups[key] = g
        self._groups = groups

    def __enter__(self) -> "Mesh":
        if not dist.is_initialized():
            raise RuntimeError(f"entering {self!r} needs a torch.distributed "
                               f"world of {self.size} ranks; none is "
                               f"initialized")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"{self!r} has {self.size} ranks; the world "
                               f"has {dist.get_world_size()}")
        if self._groups is None:
            self._make_groups()
        self._rank = dist.get_rank()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        if self not in _ACTIVE:
            self._rank = None


# the entered meshes, innermost last (``with mesh:`` nests as jax's does)
_ACTIVE: List[Mesh] = []


def current_mesh() -> Mesh:
    if not _ACTIVE:
        raise RuntimeError("no mesh is entered: run inside 'with mesh:' in "
                           "a torch.distributed world of mesh.size ranks")
    return _ACTIVE[-1]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 1) -> Mesh:
    """A small mesh for tests and one-host runs (``data * model * pod``
    ranks)."""
    if pod > 1:
        return Mesh((pod, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))


# NVIDIA H100 SXM data-sheet figures used by the roofline analysis
PEAK_FLOPS_BF16 = 989e12        # per card, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s per card, HBM3
ICI_BW = 450e9                  # bytes/s per card, NVLink, one direction
CHIPS_PER_POD = 8               # GPUs per NVLink domain (one HGX host)
