"""Flat-buffer layout for gradient/parameter trees (port of
``repro.core.flatbuf``).

The worker->master channel operates on ONE contiguous fp32 buffer per
message instead of leaf-by-leaf tensors: the structure (key paths,
shapes, dtypes, offsets) is resolved once per tree layout and cached, so
the hot path is a single ``torch.cat`` on send and static slices on
receive, and the packed (values, indices) wire format can address the
whole model with one int32 index space.

Layout contract (the JAX package's, so flat indices agree across the two):
  - leaves appear in ``jax.tree.leaves`` order: dict keys SORTED,
    recursively (for the CNN ``conv_b, conv_w, fc_b, fc_w`` — not
    insertion order);
  - each leaf is raveled C-order and cast to fp32;
  - leaf i occupies ``[offsets[i], offsets[i] + sizes[i])``;
  - total length ``n = sum(sizes)``; no padding inside the buffer.

A tree is any nested ``Mapping`` of tensors (plain dicts, or the serving
slice's ``ParamTree``). ``unflatten`` returns plain nested dicts whose
leaves are views of the buffer it was given: callers that hand such a
tree out must never write to that buffer in place (the reducer replaces
its buffer every step instead).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Tuple

import torch

PyTree = Any
Path = Tuple[str, ...]


def _items(tree) -> List[Tuple[str, Any]]:
    return sorted(((k, tree[k]) for k in tree.keys()), key=lambda kv: kv[0])


def _is_node(x) -> bool:
    return hasattr(x, "keys") and not isinstance(x, torch.Tensor)


def tree_paths(tree: PyTree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(key path, leaf) pairs in ``jax.tree.leaves`` order."""
    for k, v in _items(tree):
        if _is_node(v):
            yield from tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree: PyTree, *rest: PyTree) -> Dict[str, Any]:
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``)
    -> a nested plain dict of the results."""
    out: Dict[str, Any] = {}
    for k, v in _items(tree):
        others = [r[k] for r in rest]
        out[k] = (tree_map(fn, v, *others) if _is_node(v)
                  else fn(v, *others))
    return out


def build_tree(paths: Tuple[Path, ...], leaves: List[Any]
               ) -> Dict[str, Any]:
    """The nested dict with ``leaves`` at ``paths``."""
    root: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


@dataclass(frozen=True)
class FlatSpec:
    """Cached ravel/unravel recipe for one tree layout."""
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...] = field(init=False)
    offsets: Tuple[int, ...] = field(init=False)
    n: int = field(init=False)

    def __post_init__(self):
        sizes = []
        for s in self.shapes:
            size = 1
            for d in s:
                size *= int(d)
            sizes.append(size)
        offsets, o = [], 0
        for s in sizes:
            offsets.append(o)
            o += s
        object.__setattr__(self, "sizes", tuple(sizes))
        object.__setattr__(self, "offsets", tuple(offsets))
        object.__setattr__(self, "n", int(o))

    # -- hot path ------------------------------------------------------
    def flatten(self, tree: PyTree) -> torch.Tensor:
        """tree -> a new (n,) fp32 buffer."""
        return torch.cat([torch.as_tensor(x).reshape(-1).float()
                          for x in tree_leaves(tree)])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, Any]:
        """(n,) buffer -> nested dict with the original shapes/dtypes
        (float32 leaves are views of ``flat``)."""
        leaves = [flat[o:o + s].reshape(shape).to(dt)
                  for o, s, shape, dt in
                  zip(self.offsets, self.sizes, self.shapes, self.dtypes)]
        return build_tree(self.paths, leaves)

    def flatten_stacked(self, stacked: PyTree) -> torch.Tensor:
        """tree whose leaves carry a leading axis (W, ...) -> (W, n) fp32
        buffer; row w is exactly ``flatten(tree_w)``."""
        leaves = tree_leaves(stacked)
        W = leaves[0].shape[0]
        return torch.cat([torch.as_tensor(x).reshape(W, -1).float()
                          for x in leaves], dim=1)


_CACHE: Dict[Any, FlatSpec] = {}


def flat_spec(tree: PyTree) -> FlatSpec:
    """FlatSpec for ``tree``'s layout, cached on (paths, shapes, dtypes)
    so repeated calls on every iteration are dict lookups; distinct
    layouts are bounded by model configs, not by data."""
    pairs = list(tree_paths(tree))
    paths = tuple(p for p, _ in pairs)
    shapes = tuple(tuple(torch.as_tensor(x).shape) for _, x in pairs)
    dtypes = tuple(torch.as_tensor(x).dtype for _, x in pairs)
    key = (paths, shapes, dtypes)
    spec = _CACHE.get(key)
    if spec is None:
        spec = FlatSpec(paths, shapes, dtypes)
        _CACHE[key] = spec
    return spec
