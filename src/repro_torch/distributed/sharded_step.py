"""The sharded train step: the port's counterpart of
``jax.jit(train_step, in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))``.

Run on every rank of an entered ``Mesh`` of ``mesh.size`` ranks:

  - **state**: each rank stores its shards of the params and optimizer
    state, per the ``param_specs(state, cfg, mesh, "train")`` it is given
    (``shard_state``);
  - **rows**: a step takes the global batch and keeps the rank's rows
    (``batch_spec``): split over pod and data, replicated over ``model``;
  - **gradients**: the rank all-gathers each param leaf along its
    sharded dims, computes its rows' masked NLL sum and count, all-reduces
    (sum, count) over the batch axes, takes the gradient of ``local_sum /
    max(global_count, 1)``, all-reduces each gradient over the batch axes
    (a reduce-scatter as an all-reduce and a slice) into its own shards,
    and applies the optimizer to them. AdaGrad, SGD and Adam are
    elementwise, so this is the unsharded update. When the batch is
    replicated nothing is reduced;
  - **metrics**: ``loss``, ``tokens`` (clamped), ``aux_loss`` and
    ``total_loss`` are the global ones, equal on every rank.

``model`` shards storage only: a rank gathers a leaf before it uses it,
so compute is replicated over ``model``. GSPMD's tensor-parallel split
(column / row products with all-reduces after ``wo`` / ``w_down``) is
not in this module (ROADMAP A10c); nor is MoE under a batch split over
more than one rank, whose aux loss and capacity the reference computes
from all tokens: the step raises for it.

``step_collectives`` reckons a step's wire bytes from shapes with the
same ``gather_steps`` and ``wire_bytes`` the step's calls count, so the
dry-run's figures and a real run's counters are one accounting.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.flatbuf import build_tree, tree_paths
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.distributed.comm_analysis import wire_bytes
from repro_torch.distributed.sharding import (P, batch_axis, batch_spec,
                                              local_shape, local_slice)
from repro_torch.launch.mesh import Mesh, axes_of

PyTree = Any


def gather_steps(shape: Sequence[int], spec: P, mesh: Mesh
                 ) -> List[Tuple[int, Any, Tuple[int, ...]]]:
    """The all-gathers that rebuild a leaf of ``shape`` from its shard:
    (dim, axis entry, result shape) per sharded dim, in dim order."""
    cur = list(local_shape(shape, spec, mesh))
    out = []
    for i, entry in enumerate(spec):
        n = mesh.axes_size(entry)
        if n > 1:
            cur[i] *= n
            out.append((i, entry, tuple(cur)))
    return out


def gather_leaf(x: torch.Tensor, full_shape: Sequence[int], spec: P,
                mesh: Mesh) -> torch.Tensor:
    for dim, entry, _ in gather_steps(full_shape, spec, mesh):
        x = all_gather(x, entry, dim, mesh)
    return x


def _full_shape(local: torch.Tensor, spec: P, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(n * (mesh.axes_size(spec[i]) if i < len(spec) else 1)
                 for i, n in enumerate(local.shape))


def _rows(x: torch.Tensor, entry, mesh: Mesh) -> torch.Tensor:
    return local_slice(x, P(entry, *(None,) * (x.dim() - 1)), mesh,
                       mesh.rank)


def step_collectives(params: PyTree, specs: PyTree, mesh: Mesh,
                     batch_entry) -> Dict[str, int]:
    """One rank's wire bytes by op for one step over ``params`` (full
    size, tensors on any device, ``meta`` too) stored per ``specs``: a
    ``ShardedTrainStep``'s when ``batch_entry`` splits the batch (the
    gathers, the (sum, count) and the gradients' all-reduces), else the
    gathers alone (a replicated batch, or a serving step)."""
    out: Dict[str, int] = {}

    def add(op, shape, dtype):
        out[op] = out.get(op, 0) + wire_bytes(op, shape, dtype)

    split = mesh.axes_size(batch_entry) > 1
    if split:
        add("all-reduce", (2,), torch.float32)      # (sum_nll, count)
    spec_of = dict(tree_paths(specs))
    for path, leaf in tree_paths(params):
        for _, _, shape in gather_steps(leaf.shape, spec_of[path], mesh):
            add("all-gather", shape, leaf.dtype)
        if split:
            add("all-reduce", leaf.shape, leaf.dtype)
    return out


class ShardedTrainStep:
    """``step(local_state, global_batch) -> (local_state, metrics)``
    around a ``build_train_step`` function (its ``cfg``, ``optimizer``
    and ``loss_and_grads``)."""

    def __init__(self, train_step, state_specs: PyTree, mesh: Mesh,
                 batch_entry):
        cfg = train_step.cfg
        self.split = mesh.axes_size(batch_entry)
        if cfg.moe is not None and self.split > 1:
            raise NotImplementedError(
                f"{cfg.name}: MoE under a batch split over {self.split} "
                f"ranks: the router's aux loss and the GShard capacity "
                f"would come from each rank's tokens where the reference "
                f"computes them from all tokens (ROADMAP A10c)")
        self.train_step = train_step
        self.specs = state_specs
        self.mesh = mesh
        self.batch_entry = batch_entry
        self.batch_axes = axes_of(batch_entry)

    @classmethod
    def from_shardings(cls, train_step, state_shardings: PyTree,
                       batch_shardings, global_batch: int
                       ) -> "ShardedTrainStep":
        """From ``to_shardings`` trees, as ``jit`` takes them: the state's
        (a tree of ``NamedSharding``) and the batch's (``None``: the
        mesh's ``batch_spec``; a tree whose ``tokens`` or a single
        ``NamedSharding``: its first entry)."""
        pairs = list(tree_paths(state_shardings))
        mesh = pairs[0][1].mesh
        specs = build_tree(tuple(p for p, _ in pairs),
                           [s.spec for _, s in pairs])
        if batch_shardings is None:
            entry = batch_axis(batch_spec(mesh, global_batch))
        else:
            sh = batch_shardings
            if hasattr(sh, "keys"):
                sh = sh["tokens"]
            entry = batch_axis(sh.spec)
        return cls(train_step, specs, mesh, entry)

    # -- state ---------------------------------------------------------------
    def _leaves(self, tree: PyTree):
        spec_of = dict(tree_paths(self.specs))
        return [(p, x, spec_of[p]) for p, x in tree_paths(tree)]

    def shard_state(self, state: PyTree) -> PyTree:
        """This rank's shards of a full state."""
        triples = self._leaves(state)
        return build_tree(tuple(p for p, _, _ in triples),
                          [local_slice(x, s, self.mesh, self.mesh.rank)
                           for _, x, s in triples])

    def gather_state(self, state: PyTree) -> PyTree:
        """The full state from every rank's shards (on every rank)."""
        triples = self._leaves(state)
        return build_tree(
            tuple(p for p, _, _ in triples),
            [gather_leaf(x, _full_shape(x, s, self.mesh), s, self.mesh)
             for _, x, s in triples])

    # -- the step --------------------------------------------------------------
    def _reduce_sums(self, sum_nll, count):
        v = all_reduce(torch.stack([sum_nll.float(), count.float()]),
                       self.batch_axes, self.mesh)
        return v[0], v[1]

    def __call__(self, state: PyTree, batch: Dict[str, torch.Tensor]):
        mesh = self.mesh
        rows = {k: _rows(v, self.batch_entry, mesh) for k, v in batch.items()}
        spec_of = dict(tree_paths(self.specs["params"]))
        local = list(tree_paths(state["params"]))
        paths = tuple(p for p, _ in local)
        full = build_tree(paths, [
            gather_leaf(x, _full_shape(x, spec_of[p], mesh), spec_of[p], mesh)
            for p, x in local])
        grads, metrics = self.train_step.loss_and_grads(
            full, rows, self._reduce_sums if self.split > 1 else None)
        shards = []
        for path, g in tree_paths(grads):
            if self.split > 1:
                g = all_reduce(g, self.batch_axes, mesh)
            shards.append(local_slice(g, spec_of[path], mesh, mesh.rank))
        new_params, new_opt = self.train_step.optimizer.update(
            state["params"], build_tree(paths, shards), state["opt"])
        return {"params": new_params, "opt": new_opt}, metrics
