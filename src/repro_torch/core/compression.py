"""Partial gradient communication — MLitB §5.1 "Communication Overhead";
port of ``repro.core.compression``'s flat packed path.

"given a fixed bandwidth budget, we want to maximize the information
transferred per iteration. An algorithm could transmit a random subset of
the weight gradients, or send the most informative."

``compress_flat`` operates on the single contiguous fp32 buffer produced
by ``core.flatbuf`` and returns the packed ``CompressedMessage`` wire
format — ``(values, indices)`` pairs addressing the whole model with one
int32 index space — plus the new error-feedback residual:

  - ``topk``     : one global top-|.| over the buffer; ties go to the
                   lowest index (``jax.lax.top_k``'s order), from a stable
                   descending sort — ``torch.topk`` promises no tie order;
  - ``blocktopk``: top-k per contiguous ``block_w`` entries through the
                   fused error-feedback kernel (``kernels/topk_compress``:
                   the CUDA kernel for CUDA tensors, its plain version for
                   CPU tensors).

``decompress_flat`` scatter-adds a message back to the dense buffer.
Error feedback: message = select(g + r); r' = (g + r) - message.

Not ported yet (they raise ``NotImplementedError``): ``randk``, whose
draws come from ``jax.random``, and the dense leaf-wise ``roundtrip`` /
``_mask_leaf`` path of the unfused reducer (ROADMAP A4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.topk_compress import fused_block_topk

_NOT_PORTED = "is not ported yet (ROADMAP A4)"


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

    def compress_flat(self, grad_flat: torch.Tensor,
                      residual_flat: Optional[torch.Tensor],
                      step: int = 0, k: Optional[int] = None
                      ) -> Tuple[CompressedMessage, torch.Tensor]:
        """(g, r) -> (packed message, new residual). ``k`` overrides the
        frac-derived keep count for THIS call; it is quantized onto
        ``k_lattice`` first. ``step`` is randk's (unported) PRNG input."""
        n = int(grad_flat.numel())
        if k is not None:
            k = self.quantize_k(n, k)
        if residual_flat is None:
            residual_flat = torch.zeros(n, dtype=torch.float32,
                                        device=grad_flat.device)
        vals, idx, res = flat_compress_core(self, n, k)(grad_flat,
                                                        residual_flat)
        return CompressedMessage(vals, idx, n), res

    # ------------------------------------------------------------------
    # dense leaf-wise path of the unfused reducer
    # ------------------------------------------------------------------
    def _mask_leaf(self, x, key):
        raise NotImplementedError(f"the leaf-wise mask {_NOT_PORTED}")

    def roundtrip(self, grad, residual, step: int = 0):
        raise NotImplementedError(f"the leaf-wise roundtrip {_NOT_PORTED}")


def flat_compress_core(comp: GradientCompressor, n: int,
                       k: Optional[int] = None):
    """Flat compressor core: fn(g (n,), r (n,)) -> (values, indices int32,
    new_residual (n,)). ``k`` is the (already-quantized) per-call keep
    total; for blocktopk it must be ``rows * block_k`` and selects the
    per-block k."""
    method = comp.method
    if method == "blocktopk":
        rows = -(-n // comp.block_w)
        k_blk = comp._block_k() if k is None else max(1, k // rows)
        block_w = comp.block_w

        def fn(g, r):
            return fused_block_topk(g, r, k=k_blk, block_w=block_w)

        return fn

    k = comp.flat_k(n) if k is None else k
    if method == "topk":

        def fn(g, r):
            c = g.float() + r
            idx = stable_topk_indices(c.abs(), k)
            res = c.clone()
            res[idx.long()] = 0.0
            return c[idx.long()], idx, res

        return fn

    if method == "randk":
        raise NotImplementedError(f"randk {_NOT_PORTED}")
    raise ValueError(method)
