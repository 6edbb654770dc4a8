"""Tensor and expert parallelism over the mesh's ``model`` axis: the work
GSPMD splits for the reference when ``param_spec`` puts ``model`` on a
leaf's head, FF, vocab or expert dim, written out as Megatron's
collectives. The reference has no such module: under ``jax.jit(...,
in_shardings=)`` the partitioner does this.

A ``ShardedTrainStep`` enters ``sharded_compute`` around its loss and
gradients. Inside it:

  - a leaf in the context's ``split`` set holds this rank's part of its
    ``model`` dim (the step gathers it over its FSDP axes only), and the
    block reading it computes its share. A column-parallel product
    (``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_up``, the experts) reads
    ``copy_to_model`` of its replicated input: the identity forward, an
    all-reduce of the input's gradient in backward. A row-parallel one
    (``wo``, ``w_down``, the experts' combine) gives a partial sum that
    ``reduce_from_model`` adds up: an all-reduce forward, the identity in
    backward. Activations between blocks stay replicated over ``model``;
  - the vocab: ``vocab_parallel_embed`` looks up the rank's rows of the
    table, and ``vocab_parallel_xent`` takes the cross-entropy over the
    rank's columns of the logits;
  - a Mamba2 block (``models/ssm.py``) computes the rank's nh / m heads:
    ``out_proj``'s rows and ``gate_norm``'s scale are split like
    ``wo``; ``in_proj``'s packed [z | x | B | C | dt] columns and the
    conv's [x | B | C] channels do not fall on head boundaries, so those
    leaves are gathered whole and the rank reads its heads' z, x and dt
    columns and B and C whole (shared by the heads), and its heads of
    ``A_log``, ``D`` and ``dt_bias``. Their gradients are the rank's
    share and are all-reduced over ``model`` (``partial_leaves``). The
    gated RMSNorm normalises over the whole d_inner, so its sum of
    squares is all-reduced over ``model`` forward and backward
    (``sum_over_model``);
  - ``batch_axes`` (empty when the batch is whole on every rank): the
    MoE router's load-balance loss is global over them
    (``global_aux``).

Which leaves split follows from their sanitized specs (``split_dim``):
a leaf splits where its spec keeps ``model`` on the dim the rules put it
on and the mesh's ``model`` axis has more than one rank; a Mamba2
block's where, besides, its nh heads divide over ``model`` (else the
block is gathered whole and computed on every rank). The
``fsdp_remap`` layout retires ``model`` from those dims, and
``ssm_no_tp`` from the SSM leaves', so their compute stays replicated.

Outside the context every function here is the identity (or the plain
function it stands in for), so a single-device step is what it was.
Every collective goes through ``distributed/collectives.py``, so
``comm_analysis.COUNTER`` counts it; the host seconds of the activation
collectives also add up in ``ACTIVATION``, which a program reads to
print them apart from the gathers'. Low-precision activations and
gradients are all-reduced in f32 and cast back.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import FrozenSet, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_reduce
from repro_torch.launch.mesh import Mesh

Path = Tuple[str, ...]
MODEL = "model"

# the dim (from the leaf's end) on which ``param_spec`` puts ``model``
TP_DIM = {"wq": -2, "wk": -2, "wv": -2, "bq": -2, "bk": -2, "bv": -2,
          "wo": -3, "w_gate": -1, "w_up": -1, "b_up": -1, "w_down": -2,
          "embed": -2, "lm_head": -2}
EXPERT_DIM = -3                 # an MoE block's stacked experts
KV_REPLICATED = ("wk", "wv", "bk", "bv")
# a Mamba2 block's leaves split over its d_inner rows (the rank's heads)
SSM_TP_DIM = {"out_proj": -2, "scale": -1}
# and those each rank reads in part (its heads' columns, B and C whole):
# gathered whole, their gradient all-reduced over ``model``
SSM_PARTIAL = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")


def is_ssm(path: Path) -> bool:
    """``path`` is a leaf of a Mamba2 block: ``.../ssm/<leaf>`` or
    ``.../ssm/gate_norm/scale``."""
    return path[-2:-1] == ("ssm",) or path[-3:-1] == ("ssm", "gate_norm")


def split_dim(path: Path, ndim: int, spec: Sequence, mesh: Mesh,
              ssm_heads: Optional[int] = None) -> Optional[int]:
    """The dim of a leaf whose compute splits over ``model`` (None: the
    leaf is gathered whole before use). ``ssm_heads``: a Mamba2 leaf's
    block's head count, which must divide over ``model``."""
    m = mesh.shape.get(MODEL, 1)
    if m == 1:
        return None
    name = path[-1]
    if is_ssm(path):
        if ssm_heads is None or ssm_heads % m or not (
                name == "out_proj" or path[-2] == "gate_norm"):
            return None
        rel = SSM_TP_DIM[name]
    elif "moe" in path[:-1] and name in ("w_gate", "w_up", "w_down"):
        rel = EXPERT_DIM
    elif name in TP_DIM:
        rel = TP_DIM[name]
    else:
        return None
    dim = ndim + rel
    return dim if 0 <= dim < len(spec) and spec[dim] == MODEL else None


def partial_leaves(paths: Iterable[Path], split: FrozenSet[Path]
                   ) -> List[Path]:
    """Replicated leaves read inside a split attention block: each rank's
    gradient of them is its local heads' share, so the step all-reduces
    it over ``model``. These are ``q_norm`` / ``k_norm`` (applied per
    local head) and, where the KV heads are not split, ``wk`` / ``wv`` /
    ``bk`` / ``bv`` (sliced to the KV heads the local query heads read).
    A bias added after a ``reduce_from_model`` (``bo``, ``b_down``) and
    the router (its gates go through ``copy_to_model``) get their whole
    gradient on every rank. In a split Mamba2 block, ``SSM_PARTIAL``
    (each rank reads its heads' part and B and C whole)."""
    out = []
    for p in paths:
        if p[-1] in SSM_PARTIAL and is_ssm(p):
            if p[:-1] + ("out_proj",) in split:
                out.append(p)
            continue
        pre = p[:-1]
        if p[-1] == "scale" and len(p) >= 2 and p[-2] in ("q_norm",
                                                           "k_norm"):
            pre = p[:-2]
        elif p[-1] not in KV_REPLICATED or p in split:
            continue
        if pre + ("wq",) in split:
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Context:
    mesh: Mesh
    split: FrozenSet[Path]
    batch_axes: Tuple[str, ...]
    head: bool                  # the head's table (and the logits) split

    @property
    def size(self) -> int:
        return self.mesh.shape.get(MODEL, 1)

    @property
    def index(self) -> int:
        """This rank's part of a dim split over ``model``."""
        return self.mesh.chunk_index(MODEL, self.mesh.rank)


_STATE = {"ctx": None}
# host seconds and calls of the activation collectives since reset(),
# and apart the seconds of the Mamba2 norms' sums of squares
ACTIVATION = {"seconds": 0.0, "calls": 0, "norm_seconds": 0.0}


def reset_activation() -> None:
    ACTIVATION.update(seconds=0.0, calls=0, norm_seconds=0.0)


@contextlib.contextmanager
def sharded_compute(mesh: Mesh, split: Iterable[Path],
                    batch_axes: Sequence[str] = (), head: bool = False):
    """Run the block functions on this rank's share (module docstring).
    ``head``: the table the logits come from is in ``split``."""
    old = _STATE["ctx"]
    _STATE["ctx"] = Context(mesh, frozenset(split), tuple(batch_axes), head)
    try:
        yield
    finally:
        _STATE["ctx"] = old


def current() -> Optional[Context]:
    return _STATE["ctx"]


def is_split(path: Path) -> bool:
    """``path``'s leaf holds this rank's part of its ``model`` dim."""
    ctx = _STATE["ctx"]
    return ctx is not None and tuple(path) in ctx.split


def head_split() -> bool:
    ctx = _STATE["ctx"]
    return ctx is not None and ctx.head


def _reduce(x: torch.Tensor, axes: Sequence[str], op: str = "sum",
            norm: bool = False) -> torch.Tensor:
    """``all_reduce`` of an activation (in f32, cast back), timed into
    ``ACTIVATION`` (``norm``: into its ``norm_seconds`` as well)."""
    ctx = _STATE["ctx"]
    t0 = time.perf_counter()
    y = all_reduce(x.float(), tuple(axes), ctx.mesh, op=op)
    dt = time.perf_counter() - t0
    ACTIVATION["seconds"] += dt
    ACTIVATION["calls"] += 1
    if norm:
        ACTIVATION["norm_seconds"] += dt
    return y if x.dtype == torch.float32 else y.to(x.dtype)


# ---------------------------------------------------------------------------
# Megatron's two functions
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, (MODEL,))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce(x, (MODEL,))

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: the identity, and an
    all-reduce over ``model`` of its gradient."""
    if _STATE["ctx"] is None:
        return x
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: the sum of every rank's
    partial over ``model``; its gradient passes as it is."""
    if _STATE["ctx"] is None:
        return x
    return _ReduceFromModel.apply(x)


# ---------------------------------------------------------------------------
# attention heads, experts
# ---------------------------------------------------------------------------
def local_kv_heads(n_local_q: int, n_kv: int) -> Tuple[List[int], bool]:
    """Where the KV heads are replicated (``n_kv`` of them) and the
    query heads split: the global KV heads the rank's ``n_local_q``
    query heads read (``kv_heads_read``)."""
    ctx = _STATE["ctx"]
    return kv_heads_read(ctx.index * n_local_q, n_local_q,
                         n_local_q * ctx.size // n_kv)


def kv_heads_read(q0: int, n_local_q: int, group: int
                  ) -> Tuple[List[int], bool]:
    """The KV heads that query heads ``q0 .. q0 + n_local_q - 1`` read
    (``group`` query heads per KV head), in order, and whether each of
    them is read by the same number of consecutive local heads (a
    grouped slice; else one KV head per local query head)."""
    per_head = [(q0 + i) // group for i in range(n_local_q)]
    heads = sorted(set(per_head))
    if n_local_q % len(heads) == 0 and per_head == [
            h for h in heads for _ in range(n_local_q // len(heads))]:
        return heads, True
    return per_head, False


def local_heads(n_heads: int) -> Tuple[int, int]:
    """The global range ``[h0, h0 + n_heads / m)`` of a split Mamba2
    block's heads on this rank."""
    n = n_heads // _STATE["ctx"].size
    h0 = _STATE["ctx"].index * n
    return h0, h0 + n


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce(x, (MODEL,), norm=True)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, (MODEL,), norm=True)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """A statistic every rank uses, summed over ``model`` (a split
    Mamba2 block's sum of squares under its gated RMSNorm): an
    all-reduce forward, and of its gradient in backward, since each
    rank's loss reads it through its own share. The identity outside a
    context."""
    if _STATE["ctx"] is None:
        return x
    return _SumOverModel.apply(x)


def local_experts(n_local: int) -> Tuple[int, int]:
    """The global index range ``[e0, e0 + n_local)`` of the rank's
    experts."""
    e0 = _STATE["ctx"].index * n_local
    return e0, e0 + n_local


def global_aux(probs: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e mean(probs)_e *
    mean(top1)_e`` over every token of the batch axes. Its value is the
    global one, equal on every rank; its gradient is this rank's share,
    ``E * sum_e (sum of local probs_e / N) * ce_e`` with the global ``ce``
    held constant, so the step's gradient all-reduce over the batch
    axes adds the global gradient up once. probs / top1: (B, S, E) f32."""
    E = probs.shape[-1]
    local = probs.sum(dim=(0, 1))
    n = torch.full((1,), float(probs.shape[0] * probs.shape[1]),
                   device=probs.device)
    tot = _reduce(torch.cat([local.detach(), top1.sum(dim=(0, 1)), n]),
                  _STATE["ctx"].batch_axes)
    count = tot[2 * E]
    ce = tot[E:2 * E] / count
    share = E * torch.sum(local / count * ce)
    full = E * torch.sum(tot[:E] / count * ce)
    return full + (share - share.detach())


def batch_split() -> bool:
    ctx = _STATE["ctx"]
    return ctx is not None and bool(ctx.batch_axes)


# ---------------------------------------------------------------------------
# the vocab
# ---------------------------------------------------------------------------
def _vocab_rows(n_local: int, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local index, inside) of global ``ids`` on the rank's rows."""
    t = ids.long() - _STATE["ctx"].index * n_local
    inside = (t >= 0) & (t < n_local)
    return torch.where(inside, t, torch.zeros_like(t)), inside


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor
                         ) -> torch.Tensor:
    """``table[tokens]`` where ``table`` holds the rank's rows of the
    vocab: the rank's lookups, zeros elsewhere, then
    ``reduce_from_model``. Without a context, the plain lookup."""
    if _STATE["ctx"] is None:
        return F.embedding(tokens.long(), table)
    t, inside = _vocab_rows(table.shape[0], tokens)
    rows = F.embedding(t, table) * inside[..., None].to(table.dtype)
    return reduce_from_model(rows)


class _VocabXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, labels, mask):
        m = _reduce(z.max(dim=-1).values, (MODEL,), op="max")
        s = _reduce(torch.exp(z - m[..., None]).sum(dim=-1), (MODEL,))
        t, inside = _vocab_rows(z.shape[-1], labels)
        mine = torch.gather(z, -1, t[..., None])[..., 0] * inside
        ll = _reduce(mine, (MODEL,))
        lse = torch.log(s) + m
        ctx.save_for_backward(z, lse, t, inside, mask)
        return torch.sum((lse - ll) * mask)

    @staticmethod
    def backward(ctx, g):
        z, lse, t, inside, mask = ctx.saved_tensors
        p = torch.exp(z - lse[..., None])
        p.scatter_add_(-1, t[..., None], -inside[..., None].to(p.dtype))
        return p.mul_(g * mask[..., None]), None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``layers.softmax_xent`` over logits (B, S, V/m) that hold the
    rank's columns of the vocab: a global max, a global sum of
    exponents and the target logit, each by an all-reduce over
    ``model``. Returns the same (sum of masked NLL, masked count); the
    backward runs on the local logits alone."""
    z = logits.float()
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=z.device)
    mask = mask.float()
    return _VocabXent.apply(z, labels, mask), torch.sum(mask)
