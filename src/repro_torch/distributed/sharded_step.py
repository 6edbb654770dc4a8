"""The sharded train step: the port's counterpart of
``jax.jit(train_step, in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))``.

Run on every rank of an entered ``Mesh`` of ``mesh.size`` ranks:

  - **state**: each rank stores its shards of the params and optimizer
    state, per the ``param_specs(state, cfg, mesh, "train")`` it is given
    (``shard_state``);
  - **rows**: a step takes the global batch and keeps the rank's rows
    (``batch_spec``): split over pod and data, replicated over ``model``;
  - **compute**: a leaf whose spec splits it over ``model`` for compute
    (``tensor_parallel.split_dim``: heads, FF, vocab, experts) is
    all-gathered over its FSDP axes only, and its block computes this
    rank's share inside ``tensor_parallel.sharded_compute`` (Megatron's
    column / row products, the vocab-parallel embedding and
    cross-entropy, expert parallelism), as GSPMD splits the reference's.
    Every other leaf (SSM projections, norms, the router, dims that
    ``sanitize_spec`` replicated) is gathered whole;
  - **gradients**: the rank computes its rows' masked NLL sum and count,
    all-reduces (sum, count) over the batch axes, takes the gradient of
    ``local_sum / max(global_count, 1)`` (plus its share of the MoE
    load-balance loss, which is global over the batch axes), all-reduces
    each gradient over the batch axes (a reduce-scatter as an all-reduce
    and a slice) into its own shards, and applies the optimizer to them.
    A replicated leaf read inside a split attention (``q_norm`` /
    ``k_norm``, replicated KV projections) has only its local heads'
    share on each rank, so its all-reduce takes ``model`` too
    (``tensor_parallel.partial_leaves``). AdaGrad, SGD and Adam are
    elementwise, so this is the unsharded update. When the batch is
    replicated only the partial leaves are reduced;
  - **metrics**: ``loss``, ``tokens`` (clamped), ``aux_loss`` and
    ``total_loss`` are the global ones, equal on every rank.

``step_collectives`` reckons a step's wire bytes from the leaves' specs
and the activation shape with the same ``gather_steps`` and
``wire_bytes`` the step's calls count, so the dry-run's figures and a
real run's counters are one accounting. Under ``remat`` the recompute
runs each block's forward collectives again (``transformer.forward``
keeps it from stopping early), and the reckoning counts them twice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Dict, FrozenSet, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core.flatbuf import build_tree, tree_paths
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.distributed.comm_analysis import wire_bytes
from repro_torch.distributed.sharding import (P, batch_axis, batch_spec,
                                              local_shape, local_slice)
from repro_torch.distributed.tensor_parallel import (MODEL, partial_leaves,
                                                     sharded_compute,
                                                     split_dim)
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


@dataclass(frozen=True)
class ComputePlan:
    """How a step reads each leaf: ``split`` maps a leaf split over
    ``model`` for compute to that dim; ``gather`` is each leaf's spec
    over the axes it is gathered on (a split leaf's without ``model``);
    ``partial`` the replicated leaves whose gradient is summed over
    ``model``; ``head``: the logits' table is split."""
    split: Dict[Tuple[str, ...], int]
    gather: Dict[Tuple[str, ...], P]
    partial: FrozenSet[Tuple[str, ...]]
    head: bool


def compute_plan(leaves: Iterable[Tuple[Tuple[str, ...], int]],
                 specs: PyTree, mesh: Mesh) -> ComputePlan:
    """The plan for leaves given as (path, ndim), stored per ``specs``."""
    spec_of = dict(tree_paths(specs))
    split, gather = {}, {}
    for path, ndim in leaves:
        spec = spec_of[path]
        dim = split_dim(path, ndim, spec, mesh)
        if dim is not None:
            split[path] = dim
            spec = P(*(None if i == dim else e for i, e in enumerate(spec)))
        gather[path] = spec
    head = ("lm_head",) if ("lm_head",) in gather else ("embed",)
    return ComputePlan(split, gather,
                       frozenset(partial_leaves(gather, frozenset(split))),
                       head in split)


def _model_local(shape: Sequence[int], dim: Optional[int], m: int
                 ) -> Tuple[int, ...]:
    return tuple(n // m if i == dim else n for i, n in enumerate(shape))


def step_collectives(params: PyTree, specs: PyTree, mesh: Mesh,
                     batch_entry, act: Optional[Tuple[Any, int, int]] = None,
                     remat: bool = False) -> Dict[str, int]:
    """One rank's wire bytes by op for one step over ``params`` (full
    size, tensors on any device, ``meta`` too) stored per ``specs``.

    ``act`` = (cfg, batch rows per rank, sequence length): a
    ``ShardedTrainStep``'s step of ``remat``: the gathers over each
    leaf's gather axes, the (sum, count) and gradient all-reduces over
    the batch axes when ``batch_entry`` splits the batch, the partial
    leaves' all-reduces, and the activation collectives
    (``activation_collectives``). Without ``act``, the gathers of whole
    leaves alone (a serving step)."""
    out: Dict[str, int] = {}

    def add(op, shape, dtype):
        out[op] = out.get(op, 0) + wire_bytes(op, shape, dtype)

    leaves = list(tree_paths(params))
    if act is None:
        spec_of = dict(tree_paths(specs))
        for path, leaf in leaves:
            for _, _, shape in gather_steps(leaf.shape, spec_of[path], mesh):
                add("all-gather", shape, leaf.dtype)
        return out
    split = mesh.axes_size(batch_entry) > 1
    plan = compute_plan([(p, x.dim()) for p, x in leaves], specs, mesh)
    m = mesh.shape.get(MODEL, 1)
    if split:
        add("all-reduce", (2,), torch.float32)      # (sum_nll, count)
    for path, leaf in leaves:
        shape = _model_local(leaf.shape, plan.split.get(path), m)
        for _, _, gathered in gather_steps(shape, plan.gather[path], mesh):
            add("all-gather", gathered, leaf.dtype)
        if split or path in plan.partial:
            add("all-reduce", shape, leaf.dtype)
    cfg, rows, seq = act
    activation_collectives(params, plan, cfg, rows, seq, split, remat, add)
    return out


def activation_collectives(params: PyTree, plan: ComputePlan, cfg,
                           rows: int, seq: int, batch_split: bool,
                           remat: bool, add) -> None:
    """``add(op, shape, dtype)`` for each activation collective of one
    step over (rows, seq) tokens per rank, all in f32: per split
    attention, MLP or expert block a forward ``reduce_from_model`` and a
    backward ``copy_to_model`` of its (rows, length, d) input (a
    cross-attention one more of the encoder's states, an MoE block one
    of its (rows, seq, k) gates); per MoE block under a batch split the
    router's statistics (2E + 1) over the batch axes; the split embedding
    one forward all-reduce, the split head one backward and the
    vocab-parallel cross-entropy three of (rows, seq). A block's forward
    ones run twice under ``remat``."""
    f32 = torch.float32
    d = cfg.d_model
    fwd = 2 if remat else 1
    length = seq + (cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0)

    def ar(shape, n):
        for _ in range(n):
            add("all-reduce", shape, f32)
    if ("embed",) in plan.split:
        ar((rows, seq, d), 1)
    if plan.head:
        ar((rows, seq, d), 1)
        ar((rows, seq), 3)
    for path, leaf in tree_paths(params):
        name, parent = path[-1], path[-2] if len(path) > 1 else ""
        lq = cfg.encoder_seq if path[0] == "encoder" else length
        if name == "router" and batch_split:
            E = leaf.shape[-1]
            ar((2 * E + 1,), math.prod(leaf.shape[:-2]) * fwd)
        if path not in plan.split:
            continue
        if name == "wq":
            n = math.prod(leaf.shape[:-3])
            ar((rows, lq, d), n * (fwd + 1))
            if parent == "cross_attn":
                ar((rows, cfg.encoder_seq, d), n)
        elif name == "w_up" and parent == "moe":
            n = math.prod(leaf.shape[:-3])
            ar((rows, seq, d), n * (fwd + 1))
            ar((rows, seq, cfg.moe.experts_per_token), n)
        elif name == "w_up":
            ar((rows, lq, d), math.prod(leaf.shape[:-2]) * (fwd + 1))


class ShardedTrainStep:
    """``step(local_state, global_batch) -> (local_state, metrics)``
    around a ``build_train_step`` function (its ``cfg``, ``optimizer``
    and ``loss_and_grads``)."""

    def __init__(self, train_step, state_specs: PyTree, mesh: Mesh,
                 batch_entry):
        self.train_step = train_step
        self.specs = state_specs
        self.mesh = mesh
        self.split = mesh.axes_size(batch_entry)
        self.batch_entry = batch_entry
        self.batch_axes = axes_of(batch_entry) if self.split > 1 else ()
        self._plan: Optional[ComputePlan] = None

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
        local = list(tree_paths(state["params"]))
        if self._plan is None:
            self._plan = compute_plan([(p, x.dim()) for p, x in local],
                                      self.specs["params"], mesh)
        plan = self._plan
        paths = tuple(p for p, _ in local)
        full = build_tree(paths, [
            gather_leaf(x, _full_shape(x, plan.gather[p], mesh),
                        plan.gather[p], mesh) for p, x in local])
        with sharded_compute(mesh, plan.split, self.batch_axes, plan.head):
            grads, metrics = self.train_step.loss_and_grads(
                full, rows, self._reduce_sums if self.batch_axes else None)
        # each gathered leaf and each unreduced gradient is freed as soon
        # as it is done with: a rank holds one leaf's reduce at a time
        del full
        pairs = list(tree_paths(grads))
        del grads
        shards = []
        for i, (path, g) in enumerate(pairs):
            pairs[i] = None
            axes = self.batch_axes + ((MODEL,) if path in plan.partial
                                      else ())
            if axes:
                g = all_reduce(g, axes, mesh)
            shards.append(local_slice(g, plan.gather[path], mesh, mesh.rank))
            del g
        new_params, new_opt = self.train_step.optimizer.update(
            state["params"], build_tree(paths, shards), state["opt"])
        return {"params": new_params, "opt": new_opt}, metrics
