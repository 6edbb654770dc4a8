"""Explicit collectives: the paper's reduce as ``torch.distributed`` calls
over a mesh's axis groups (the counterpart of
``repro.distributed.collectives``).

Each rank is a browser "worker" of MLitB; the all-reduce over the data
axes is the master's reduce (paper §3.3 step c), and the §3.5 scaling
fixes are:

  - ``weighted_psum_reduce``: sum of gradient sums / global sample count;
  - ``hierarchical_weighted_reduce``: reduce inside a pod, then across
    pods — the paper's "multiple master processes";
  - ``compressed_reduce``: block-top-k sparsify per worker before the
    wire — "partial communication of gradients" — with error feedback.

Each function is called on every rank of an entered ``Mesh`` with that
rank's local values, as the reference's run inside ``shard_map``.

Every collective goes through ``all_reduce`` / ``all_gather`` below,
which add this rank's wire bytes to ``comm_analysis.COUNTER``. One code
path serves gloo and NCCL: ``all_reduce`` and the list form of
``all_gather`` (gloo has no reduce-scatter; a reduce-scatter here is an
all-reduce and a slice).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.distributed.comm_analysis import COUNTER, wire_bytes
from repro_torch.kernels.topk_compress.ops import block_topk
from repro_torch.launch.mesh import Mesh, axes_of, current_mesh
from repro_torch.optim.base import leaf_map

PyTree = Any
Axes = Union[str, Sequence[str]]
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axes: Axes,
               mesh: Optional[Mesh] = None, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over the ranks of this
    rank's group on ``axes`` (a new tensor)."""
    mesh = mesh or current_mesh()
    y = x.clone(memory_format=torch.contiguous_format)
    group = mesh.group(axes_of(axes))
    if group is None:
        return y
    t0 = COUNTER.start(y)
    dist.all_reduce(y, op=_OPS[op], group=group)
    COUNTER.add("all-reduce", wire_bytes("all-reduce", y.shape, y.dtype), t0)
    return y


def all_gather(x: torch.Tensor, entry: Axes, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The parts of a dim sharded over ``entry``, put back together along
    ``dim`` in chunk order (row-major over the entry's axes)."""
    mesh = mesh or current_mesh()
    axes = axes_of(entry)
    group = mesh.group(axes)
    if group is None:
        return x
    members = mesh.group_ranks(axes, mesh.rank)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in members]
    t0 = COUNTER.start(x)
    dist.all_gather(parts, x, group=group)
    order = sorted(range(len(members)),
                   key=lambda i: mesh.chunk_index(entry, members[i]))
    y = torch.cat([parts[i] for i in order], dim=dim)
    COUNTER.add("all-gather", wire_bytes("all-gather", y.shape, y.dtype), t0)
    return y


# ---------------------------------------------------------------------------
def weighted_psum_reduce(grad_sum: PyTree, n_local: torch.Tensor,
                         axis_names: Axes) -> PyTree:
    """(local gradient SUM, local sample count) -> global mean gradient,
    exactly the master's weighted average."""
    n_global = all_reduce(torch.as_tensor(n_local).float(), axis_names)
    return leaf_map(lambda g: all_reduce(g.float(), axis_names)
                    / torch.clamp(n_global, min=1.0), grad_sum)


def hierarchical_weighted_reduce(grad_sum: PyTree, n_local: torch.Tensor,
                                 intra: str = "data",
                                 inter: str = "pod") -> PyTree:
    """Two-level reduce: over the intra-pod axis first, then across pods.
    Mathematically the flat reduce; mirrors the paper's "increase the
    number of master node processes"."""
    n1 = all_reduce(torch.as_tensor(n_local).float(), intra)
    g1 = leaf_map(lambda g: all_reduce(g.float(), intra), grad_sum)
    n2 = all_reduce(n1, inter)
    return leaf_map(lambda g: all_reduce(g, inter)
                    / torch.clamp(n2, min=1.0), g1)


def reference_picks(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """``x`` times the one-hot of each block's pick, bit for bit the
    reference's ``argmax`` + one-hot, where ``kept`` is kernel 3's output
    on ``x`` (its plain version's on the CPU): one elementwise pass,
    ``x * (kept != 0)``. That is the reference's in every case:

      - a block with a nonzero max: kernel 3 keeps its first max-|.|
        entry, the reference's pick, and ``x * 1`` there; the rest is
        ``x * 0`` in both (-0.0 for a negative, NaN for an infinity);
      - a block holding a NaN: kernel 3 zeros it, so every entry is
        ``x * 0``; the reference's pick is its first NaN, ``NaN * 1``,
        which is NaN as ``NaN * 0`` is, and the rest is ``x * 0``;
      - an all-zero block: kernel 3 keeps nothing nonzero, so every entry
        is ``x * 0``, which is ``x`` itself (a signed zero keeps its
        sign), as the reference's ``x * 1`` at column 0 is."""
    return x * (kept != 0)


def block_topk_sparsify(x: torch.Tensor, block: int) -> torch.Tensor:
    """Keep the top-1 magnitude entry per contiguous block (dense output
    with zeros). On a CUDA tensor kernel 3 (``block_topk``) finds the
    picks; on a CPU tensor its plain version does; ``reference_picks``
    then applies the reference's NaN and zero rule."""
    return reference_picks(x, block_topk(x, block_w=block))


def compressed_reduce(grad_sum: PyTree, n_local: torch.Tensor,
                      residual: PyTree, block: int,
                      axis_names: Axes) -> Tuple[PyTree, PyTree]:
    """Error-feedback block-top-k before the all-reduce. Returns
    (global mean gradient of the SENT payloads, new residual)."""
    corrected = leaf_map(lambda g, r: g.float() + r, grad_sum, residual)
    sent = leaf_map(lambda c: block_topk_sparsify(c, block), corrected)
    new_res = leaf_map(lambda c, s: c - s, corrected, sent)
    n_global = all_reduce(torch.as_tensor(n_local).float(), axis_names)
    reduced = leaf_map(lambda s: all_reduce(s, axis_names)
                       / torch.clamp(n_global, min=1.0), sent)
    return reduced, new_res
