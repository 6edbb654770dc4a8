"""Sharding rules: parameter / batch / cache partition specs per mesh and
mode (the counterpart of ``repro.distributed.sharding``; the rules are
the reference's, line for line).

Strategy:
  train : FSDP x TP — d_model dims shard over the data(+pod) axes, head/ff/
          expert/vocab dims shard over ``model``. Optimizer state inherits
          param sharding automatically (same tree structure).
  serve : TP only — params replicated across ``data`` (batch) so decode
          steps never all-gather weights.

GQA caveat: when n_kv_heads < |model| the kv projections are REPLICATED
over ``model`` (q heads still shard). Dims an axis does not divide fall
back to replication (``sanitize_spec``).

A spec is a ``P``: one entry per leading dim, each ``None`` (replicated),
an axis name, or a tuple of axis names (the dim is cut into the product
of their sizes, row-major in the tuple's order). A one-axis tuple is
stored as the axis name and an empty tuple as ``None``, so equal
placements compare equal (``P(("data",)) == P("data")``), as jax 0.9's
``PartitionSpec`` normalizes them.

How the port uses a spec: ``local_shape`` / ``local_slice`` give a
rank's shard; ``distributed/sharded_step.py`` stores the shards and
gathers them around the step, a leaf whose compute splits over
``model`` over its FSDP axes only (``tensor_parallel.split_dim``). The spec trees follow ``tree_paths``
order, which is ``jax.tree.leaves`` order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flatbuf import build_tree, tree_map, tree_paths
from repro_torch.launch.mesh import Mesh

PyTree = Any


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class P(tuple):
    """A partition spec: a tuple of per-dim axis entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (what ``jax.sharding.NamedSharding`` names)."""
    mesh: Mesh
    spec: P


def fsdp_axes(mesh: Mesh, layout: frozenset = frozenset()) -> Tuple[str, ...]:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if "fsdp_remap" in layout and "model" in mesh.axis_names:
        axes = axes + ("model",)
    return axes


def batch_axes(mesh: Mesh, layout: frozenset = frozenset()
               ) -> Tuple[str, ...]:
    return fsdp_axes(mesh, layout)


# Layout features (the reference's beyond-paper options):
#   fsdp_remap    : train — no tensor parallelism; the `model` axis joins
#                   the data/FSDP axes
#   serve_fsdp    : decode — params shard over data x model (train-style
#                   2D) instead of TP-only replication over `data`
#   cache_seqshard: decode — KV-cache SEQUENCE dim shards over `model`
#                   when kv heads cannot (GQA kv < |model|)
#   moe_sort      : MoE dispatch via stable-sort buckets instead of the
#                   GShard one-hot einsums (identical drop semantics)
#   ssm_no_tp     : replicate SSM projections over `model`
LAYOUT_FEATURES = ("fsdp_remap", "serve_fsdp", "cache_seqshard",
                   "moe_sort", "ssm_no_tp")


def parse_layout(s: str) -> frozenset:
    if not s or s == "baseline":
        return frozenset()
    feats = frozenset(x for x in s.split(",") if x)
    unknown = feats - set(LAYOUT_FEATURES)
    if unknown:
        raise ValueError(f"unknown layout features {sorted(unknown)}")
    return feats


def _model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


# ---------------------------------------------------------------------------
def param_spec(path: Tuple[str, ...], ndim: int, cfg: ArchConfig,
               mesh: Mesh, mode: str,
               layout: frozenset = frozenset()) -> P:
    """Spec for one parameter leaf, identified by its tree path.

    Leading stacked-layer axes (1 for uniform stacks, 2 for hybrid
    super-stacks) are never sharded; the rules address the trailing
    'semantic' dims."""
    use_fsdp = mode == "train" or (mode == "serve"
                                   and "serve_fsdp" in layout)
    fs = fsdp_axes(mesh, layout) if use_fsdp else ()
    fsdp = fs if fs else None
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    remap = "fsdp_remap" in layout
    msz = 1 if remap else _model_size(mesh)
    kv_shardable = cfg.n_kv_heads and cfg.n_kv_heads % msz == 0
    model = None if remap else "model"

    def lead(n_sem: int) -> Tuple[Optional[str], ...]:
        return (None,) * (ndim - n_sem)

    # ---- embeddings ----
    if name in ("embed", "lm_head"):
        return P(model, fsdp)
    if name == "enc_pos":
        return P(None, fsdp)

    # ---- attention ----
    if name == "wq":
        return P(*lead(3), fsdp, model, None)
    if name in ("wk", "wv"):
        if kv_shardable:
            return P(*lead(3), fsdp, model, None)
        return P(*lead(3), fsdp, None, None)
    if name == "wo":
        return P(*lead(3), model, None, fsdp)
    if name in ("bq",):
        return P(*lead(2), model, None)
    if name in ("bk", "bv"):
        if kv_shardable:
            return P(*lead(2), model, None)
        return P(*lead(2), None, None)

    # ---- dense MLP ----
    if name in ("w_gate", "w_up") and parent != "moe":
        return P(*lead(2), fsdp, model)
    if name == "w_down" and parent != "moe":
        return P(*lead(2), model, fsdp)
    if name == "b_up":
        return P(*lead(1), model)

    # ---- MoE (expert-parallel over `model`) ----
    if parent == "moe" or (len(path) >= 2 and "moe" in path):
        # serve (TP-only): the expert FF dim over `data`; under
        # serve_fsdp the d dim already uses `data`
        ff_ax = "data" if (mode == "serve" and "serve_fsdp" not in layout
                           and "data" in mesh.axis_names) else None
        if name == "router":
            return P(*lead(2), fsdp, None)
        if name in ("w_gate", "w_up"):
            return P(*lead(3), model, fsdp, ff_ax)
        if name == "w_down":
            return P(*lead(3), model, ff_ax, fsdp)

    # ---- SSM (head/packed-inner dims over `model`) ----
    ssm_model = None if "ssm_no_tp" in layout else model
    if name == "in_proj":
        return P(*lead(2), fsdp, ssm_model)
    if name == "out_proj":
        return P(*lead(2), ssm_model, fsdp)
    if name == "conv_w":
        return P(*lead(2), None, ssm_model)
    if name == "conv_b":
        return P(*lead(1), ssm_model)
    if name == "scale" and parent == "gate_norm":
        return P(*lead(1), ssm_model)

    # ---- everything else (norms, scalars, biases) ----
    return P()


def sanitize_spec(spec: P, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop mesh axes from dims they don't divide evenly; the fallback
    is replication on that dim."""
    if len(spec) > len(shape):
        return P(*(None,) * len(shape))
    fixed = []
    for i, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        fixed.append(ax if shape[i] % mesh.axes_size(ax) == 0 else None)
    return P(*fixed)


def _map_paths(rule, tree: PyTree) -> PyTree:
    pairs = list(tree_paths(tree))
    return build_tree(tuple(p for p, _ in pairs),
                      [rule(p, leaf) for p, leaf in pairs])


def param_specs(params: PyTree, cfg: ArchConfig, mesh: Mesh,
                mode: str = "train",
                layout: frozenset = frozenset()) -> PyTree:
    def rule(path, leaf):
        spec = param_spec(path, leaf.dim(), cfg, mesh, mode, layout)
        return sanitize_spec(spec, tuple(leaf.shape), mesh)
    return _map_paths(rule, params)


def param_shardings(params: PyTree, cfg: ArchConfig, mesh: Mesh,
                    mode: str = "train",
                    layout: frozenset = frozenset()) -> PyTree:
    return to_shardings(param_specs(params, cfg, mesh, mode, layout), mesh)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------
def batch_spec(mesh: Mesh, batch_size: int,
               layout: frozenset = frozenset()) -> P:
    """Shard batch over (pod, data[, model if fsdp_remap]) when divisible;
    an indivisible batch replicates (``P(None)``)."""
    keep = []
    prod = 1
    for a in batch_axes(mesh, layout):
        if batch_size % (prod * mesh.shape[a]) == 0:
            keep.append(a)
            prod *= mesh.shape[a]
    return P(tuple(keep))


def batch_axis(spec: P):
    """First (batch) dim entry of a batch spec, ``None`` if replicated."""
    return (spec[0] or None) if len(spec) else None


def train_batch_specs(mesh: Mesh, batch_size: int) -> Dict[str, P]:
    b = batch_axis(batch_spec(mesh, batch_size))
    return {"tokens": P(b, None), "labels": P(b, None),
            "mask": P(b, None)}


def cache_specs(cache: PyTree, cfg: ArchConfig, mesh: Mesh,
                batch_size: int,
                layout: frozenset = frozenset()) -> PyTree:
    """Decode-cache specs. Batch shards over (pod,data) when divisible;
    for long-context batch=1 the kv SEQUENCE axis shards over `data`
    (attention archs) and SSM state heads shard over `model`.
    ``cache_seqshard``: when GQA kv heads cannot shard over `model` the
    SEQUENCE axis shards over it instead."""
    baxis = batch_axis(batch_spec(mesh, batch_size))
    data_free = baxis is None and "data" in mesh.axis_names
    msz = _model_size(mesh)
    kv_shardable = cfg.n_kv_heads and cfg.n_kv_heads % msz == 0
    seq_axes = []
    if data_free:
        seq_axes.append("data")
    if "cache_seqshard" in layout and not kv_shardable \
            and "model" in mesh.axis_names:
        seq_axes.append("model")
    seq_ax = tuple(seq_axes) if seq_axes else None
    ssm_heads = cfg.ssm.n_heads(cfg.d_model) if cfg.ssm else 0
    ssm_shardable = ssm_heads and ssm_heads % msz == 0

    def cache_rule(name, nd):
        if name in ("k", "v"):
            # (L[,P], B, T, K, hd)
            lead = (None,) * (nd - 4)
            return P(*lead, baxis, seq_ax,
                     "model" if kv_shardable else None, None)
        if name == "kpos":
            lead = (None,) * (nd - 1)
            return P(*lead, seq_ax)
        if name == "h":
            # (L[,P], B, nh, hd, N)
            lead = (None,) * (nd - 4)
            return P(*lead, baxis, "model" if ssm_shardable else None,
                     None, None)
        if name == "conv":
            # (L[,P], B, W-1, C)
            lead = (None,) * (nd - 3)
            return P(*lead, baxis, None, "model")
        return P()

    def rule(path, leaf):
        return sanitize_spec(cache_rule(path[-1], leaf.dim()),
                             tuple(leaf.shape), mesh)
    return _map_paths(rule, cache)


def to_shardings(specs: PyTree, mesh: Mesh) -> PyTree:
    def one(s):
        return NamedSharding(mesh, s) if isinstance(s, P) else s
    if isinstance(specs, P):
        return one(specs)
    return tree_map(one, specs)


# ---------------------------------------------------------------------------
# A rank's shard
# ---------------------------------------------------------------------------
def local_shape(shape: Sequence[int], spec: P, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard: each sharded dim divided by the
    product of its axes' sizes (it must divide)."""
    out = list(shape)
    for i, ax in enumerate(spec):
        n = mesh.axes_size(ax)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({out[i]}) does "
                             f"not split into {n} over {ax!r}")
        out[i] //= n
    return tuple(out)


def local_slice(x: torch.Tensor, spec: P, mesh: Mesh, rank: int
                ) -> torch.Tensor:
    """``rank``'s shard of ``x`` (a new contiguous tensor): on each
    sharded dim the part ``mesh.chunk_index(entry, rank)``."""
    shape = local_shape(x.shape, spec, mesh)
    for i, ax in enumerate(spec):
        if ax is not None and mesh.axes_size(ax) > 1:
            x = x.narrow(i, mesh.chunk_index(ax, rank) * shape[i], shape[i])
    return x.clone(memory_format=torch.contiguous_format)

