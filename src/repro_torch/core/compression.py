"""Partial gradient communication — MLitB §5.1 "Communication Overhead";
port of ``repro.core.compression``.

"given a fixed bandwidth budget, we want to maximize the information
transferred per iteration. An algorithm could transmit a random subset of
the weight gradients, or send the most informative."

Two implementations of the same channel:

1. **Flat packed path (the hot path).** ``compress_flat`` operates on the
   single contiguous fp32 buffer produced by ``core.flatbuf`` and returns
   the packed ``CompressedMessage`` wire format — ``(values, indices)``
   pairs addressing the whole model with one int32 index space — plus the
   new error-feedback residual:

     - ``topk``     : one global top-|.| over the buffer; ties go to the
                      lowest index (``jax.lax.top_k``'s order), from a
                      stable descending sort — ``torch.topk`` promises no
                      tie order;
     - ``randk``    : k uniform positions, re-drawn EVERY step (the key
                      folds in the step counter);
     - ``blocktopk``: top-k per contiguous ``block_w`` entries through the
                      fused error-feedback kernel (``kernels/topk_compress``:
                      the CUDA kernel for CUDA tensors, its plain version
                      for CPU tensors).

   ``decompress_flat`` scatter-adds a message back to the dense buffer.

2. **Dense leaf-wise path.** ``roundtrip`` keeps the per-leaf mask
   semantics and returns the dense reconstruction; the reducer's
   ``fused=False`` mode uses it. Its topk and block masks equal the JAX
   package's bit for bit (ties: keep the first k; the block argmax over
   ``-1``-padded rows).

Error feedback in both: message = select(g + r); r' = (g + r) - message.

randk's draws: ``jax.random`` cannot be reproduced here, so the subset
comes from the port's counter-based integer hash (``counter_hash``): the
score of entry i under key ``chain_key(seed, step, row)`` is
``u_i = h_i / 2**32`` with ``h_i = mix32(mix32(key ^ i))``, a uniform
draw in [0, 1) — exact integer arithmetic, so the card and the CPU draw
the same subset bit for bit, and a bijection of i, so no two scores tie.
The k largest scores are the subset (``row`` is 0 on ``compress_flat``,
the worker row in the fused reducer, the leaf's index in ``roundtrip``).
The JAX package draws other bits, so the two agree in distribution, not
subset for subset.

NOTE: randk ships the UNSCALED payload. The classical n/k rescaling makes
plain (no-feedback) rand-k unbiased, but combined with error feedback it
amplifies total delivered mass by n/k (the unsent mass re-enters the next
message and is rescaled again), which diverges under SGD; with a residual
in the loop the selection shrinkage is exactly what the feedback corrects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.counter_hash import chain_key, hash_range
from repro_torch.core.flatbuf import tree_leaves, tree_map
from repro_torch.kernels.topk_compress import fused_block_topk

PyTree = Any


def index_add_drop(out: torch.Tensor, idx: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """``out[idx] += vals`` in place over a 1-D ``out``, dropping the
    entries whose index lies outside ``[0, len(out))`` as JAX's
    ``.at[].add(mode="drop")`` does (PyTorch would raise). A dropped entry
    is sent to index 0 with the value -0.0, the exact additive identity,
    so the result needs no data-dependent shape and no host sync."""
    ok = (idx >= 0) & (idx < out.shape[0])
    return out.index_add_(0, torch.where(ok, idx, torch.zeros_like(idx)),
                          torch.where(ok, vals, torch.full_like(vals, -0.0)))


@dataclass(frozen=True, eq=False)   # eq=False: tensor fields break ==/hash
class CompressedMessage:
    """The packed wire format: ``values[i]`` belongs at flat-buffer
    position ``indices[i]``. Entries with value 0.0 are padding (scatter
    no-ops); indices >= n can occur only on such padding and are dropped
    by the reconstruction scatter."""
    values: torch.Tensor         # fp32, any shape (flattened on the wire)
    indices: torch.Tensor        # int32, same shape as values
    n: int                       # flat-buffer length being addressed

    def wire_bytes(self) -> int:
        """4B value + 4B index per kept entry."""
        return 8 * int(self.values.numel())

    def dense(self) -> torch.Tensor:
        return decompress_flat(self.values, self.indices, n=self.n)


def decompress_flat(values: torch.Tensor, indices: torch.Tensor, *,
                    n: int) -> torch.Tensor:
    """Packed message -> dense (n,) fp32 buffer (the master's view)."""
    out = torch.zeros(n, dtype=torch.float32, device=values.device)
    return index_add_drop(out, indices.reshape(-1),
                          values.reshape(-1).float())


def stable_topk_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, largest
    first, ties by the lowest index (``jax.lax.top_k``'s order), int32."""
    order = torch.sort(mag, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def randk_scores(key: int, n: int, device=None) -> torch.Tensor:
    """(n,) int32 scores in the order of the uniform draws
    ``u_i = h_i / 2**32`` (``h = hash_range(key, n)``): ``h - 2**31``, an
    order-preserving shift into int32 that halves the bytes a sort moves.
    All distinct."""
    return (hash_range(key, n, device) - 2 ** 31).to(torch.int32)


def randk_indices(key: int, n: int, k: int, device=None) -> torch.Tensor:
    """The k positions of the largest uniform scores under ``key``,
    largest first, int32."""
    return stable_topk_indices(randk_scores(key, n, device), k)


# ---------------------------------------------------------------------------
# dense leaf-wise masks
# ---------------------------------------------------------------------------
def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = x.reshape(-1).abs()
    if k >= flat.numel():
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    thresh = torch.topk(flat, k).values[-1]
    mask = flat >= thresh
    # break ties deterministically: keep first k
    cum = torch.cumsum(mask.to(torch.int32), 0)
    return (mask & (cum <= k)).reshape(x.shape)


def _randk_mask(x: torch.Tensor, k: int, key: int) -> torch.Tensor:
    n = x.numel()
    if k >= n:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    scores = randk_scores(key, n, x.device)
    thresh = torch.topk(scores, k).values[-1]
    return (scores >= thresh).reshape(x.shape)


def _block_top1_mask(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1).abs()
    n = flat.numel()
    pad = (-n) % block
    fp = torch.cat([flat, flat.new_full((pad,), -1.0)]).reshape(-1, block)
    arg = torch.argmax(fp, dim=1)
    mask = torch.zeros(fp.shape, dtype=torch.bool, device=x.device)
    mask[torch.arange(fp.shape[0], device=x.device), arg] = True
    return mask.reshape(-1)[:n].reshape(x.shape)


@dataclass(frozen=True)
class GradientCompressor:
    method: str = "topk"            # topk | randk | blocktopk
    frac: float = 0.01              # fraction of entries kept
    seed: int = 0
    min_keep: int = 1
    block_w: int = 128              # flat-path block width (blocktopk)

    # ------------------------------------------------------------------
    # flat packed path
    # ------------------------------------------------------------------
    def flat_k(self, n: int, k: Optional[int] = None) -> int:
        """Kept entries for an (n,)-buffer message (incl. packing pads).
        ``k`` is the per-call override; it is snapped onto ``k_lattice``."""
        if k is not None:
            return self.quantize_k(n, k)
        if self.method == "blocktopk":
            rows = -(-n // self.block_w)
            return rows * self._block_k()
        return min(n, max(self.min_keep, int(self.frac * n)))

    def _block_k(self) -> int:
        return min(self.block_w,
                   max(self.min_keep, int(round(self.frac * self.block_w))))

    # -- adaptive-k lattice --------------------------------------------
    def k_lattice(self, n: int) -> Tuple[int, ...]:
        """The per-message totals a per-call ``k`` may take: powers of two
        (plus the exact endpoint). blocktopk quantizes the PER-BLOCK k, so
        its lattice is rows * {1, 2, 4, ..., block_w}."""
        if self.method == "blocktopk":
            rows = -(-n // self.block_w)
            ks, b = [], 1
            while b < self.block_w:
                ks.append(rows * b)
                b *= 2
            ks.append(rows * self.block_w)
            return tuple(ks)
        ks, b = [], 1
        while b < n:
            ks.append(b)
            b *= 2
        ks.append(n)
        return tuple(ks)

    def quantize_k(self, n: int, raw_k: float) -> int:
        """Largest lattice point <= raw_k; the smallest point if raw_k is
        below the whole lattice."""
        lat = self.k_lattice(n)
        out = lat[0]
        for point in lat:
            if point <= raw_k:
                out = point
        return out

    def packed_wire_bytes(self, n: int, k: Optional[int] = None) -> int:
        """Exact bytes ``compress_flat`` puts on the wire for an
        (n,)-buffer — matches ``CompressedMessage.wire_bytes()``."""
        return 8 * self.flat_k(n, k)

    def flat_key(self, step: int, row: int = 0) -> int:
        """randk's subset key for iteration ``step`` (and worker ``row`` of
        a stacked reduce): folding the step counter in makes consecutive
        masks differ."""
        return chain_key(self.seed, step, row)

    def compress_flat(self, grad_flat: torch.Tensor,
                      residual_flat: Optional[torch.Tensor],
                      step: int = 0, k: Optional[int] = None
                      ) -> Tuple[CompressedMessage, torch.Tensor]:
        """(g, r, step) -> (packed message, new residual). The step
        counter feeds randk's key, so the random subset differs every
        iteration. ``k`` overrides the frac-derived keep count for THIS
        call; it is quantized onto ``k_lattice`` first."""
        n = int(grad_flat.numel())
        if k is not None:
            k = self.quantize_k(n, k)
        if residual_flat is None:
            residual_flat = torch.zeros(n, dtype=torch.float32,
                                        device=grad_flat.device)
        vals, idx, res = flat_compress_core(self, n, k)(
            grad_flat, residual_flat, self.flat_key(step))
        return CompressedMessage(vals, idx, n), res

    # ------------------------------------------------------------------
    # dense leaf-wise path
    # ------------------------------------------------------------------
    def _mask_leaf(self, x: torch.Tensor, key: int) -> torch.Tensor:
        k = max(self.min_keep, int(self.frac * x.numel()))
        if self.method == "topk":
            return _topk_mask(x, k)
        if self.method == "randk":
            return _randk_mask(x, k, key)
        if self.method == "blocktopk":
            block = max(1, int(round(1.0 / self.frac)))
            return _block_top1_mask(x, block)
        raise ValueError(self.method)

    def roundtrip(self, grad: PyTree, residual: Optional[PyTree],
                  step: int = 0) -> Tuple[PyTree, PyTree]:
        """(grad, residual) -> (dense reconstruction of the message,
        new residual). Error feedback: message = mask*(g + r);
        r' = (g + r) - message. ``step`` keys randk's subset draw; leaf i
        (``tree_leaves`` order) draws under ``chain_key(seed, step, i)``."""
        if residual is None:
            residual = tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), grad)
        corrected = tree_map(lambda g, r: g.float() + r, grad, residual)
        n_leaves = len(tree_leaves(corrected))
        keys = iter(self.flat_key(step, i) for i in range(n_leaves))
        masks = tree_map(lambda x: self._mask_leaf(x, next(keys)), corrected)
        sent = tree_map(lambda c, m: torch.where(m, c, torch.zeros_like(c)),
                        corrected, masks)
        # the residual excludes what was sent
        new_res = tree_map(
            lambda c, m: torch.where(m, torch.zeros_like(c), c),
            corrected, masks)
        return sent, new_res

    def wire_bytes(self, grad: PyTree) -> int:
        """values(4B) + indices(4B) per kept entry (leaf-wise path)."""
        total = 0
        for leaf in tree_leaves(grad):
            k = max(self.min_keep, int(self.frac * leaf.numel()))
            total += 8 * min(k, leaf.numel())
        return total


def flat_compress_core(comp: GradientCompressor, n: int,
                       k: Optional[int] = None):
    """Flat compressor core: fn(g (n,), r (n,), key) -> (values, indices
    int32, new_residual (n,)); ``key`` is randk's (``flat_key``), unused by
    the others. ``k`` is the (already-quantized) per-call keep total; for
    blocktopk it must be ``rows * block_k`` and selects the per-block k."""
    method = comp.method
    if method == "blocktopk":
        rows = -(-n // comp.block_w)
        k_blk = comp._block_k() if k is None else max(1, k // rows)
        block_w = comp.block_w

        def fn(g, r, key):
            return fused_block_topk(g, r, k=k_blk, block_w=block_w)

        return fn

    k = comp.flat_k(n) if k is None else k
    if method in ("topk", "randk"):

        def fn(g, r, key):
            c = g.float() + r
            idx = (stable_topk_indices(c.abs(), k) if method == "topk"
                   else randk_indices(key, n, k, c.device)).long()
            res = c.clone()
            res[idx] = 0.0
            return c[idx], idx.to(torch.int32), res

        return fn

    raise ValueError(method)


def dense_bytes(grad: PyTree, bytes_per_el: int = 4) -> int:
    return sum(leaf.numel() * bytes_per_el for leaf in tree_leaves(grad))
