"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings and
the token cross-entropy.

The PyTorch counterpart of ``repro.models.layers``. Parameters live in a
``ParamTree`` — an ``nn.Module`` that holds the same nested names as the
JAX package's parameter dict, so ``p["scale"]`` and ``"bias" in p`` read
the same on both sides and a weight transfer is a plain copy. The math is
plain functions on tensors. Layer-stacked parameters carry a leading
``L`` axis; ``layer(tree, i)`` takes layer ``i``'s views.
"""
from __future__ import annotations

import functools
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.counter_hash import chain_key
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.gemm_3xtf32 import linear

Params = Mapping[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


class ParamTree(nn.Module):
    """Nested parameter dictionary as an ``nn.Module``: tensors become
    (frozen) ``nn.Parameter``s, dicts become child ``ParamTree``s. Index
    it like the dict it was made from."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class Init:
    """Where ``init_params`` gets its leaves. ``normal(path, shape,
    scale, dtype)`` fills a leaf on ``device`` with ``N(0, 1) * scale``:
    the leaf, flattened, is cut into chunks of ``CHUNK`` entries, and
    chunk ``i`` is drawn on the CPU in float32 from its own
    ``torch.Generator`` seeded with ``chain_key(seed, crc32(path), i)``,
    scaled, cast and copied into place. So the numbers depend on the
    seed, the leaf's path and its size only (not on the device, the
    order of the draws or the thread that drew them), the host holds a
    few chunks at a time however wide the model, and the chunks are
    drawn on every core. On the ``meta`` device nothing is drawn (the
    tree's shapes and dtypes only)."""

    CHUNK = 1 << 22

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._pool = None if self.device.type == "meta" else \
            ThreadPoolExecutor(max(1, torch.get_num_threads()))

    def normal(self, path: str, shape: Tuple[int, ...], scale: float,
               dtype: torch.dtype) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if self._pool is None:
            return out
        flat, key = out.view(-1), zlib.crc32(path.encode())

        def chunk(i: int) -> None:
            a = i * self.CHUNK
            n = min(self.CHUNK, flat.numel() - a)
            gen = torch.Generator().manual_seed(chain_key(self.seed, key, i))
            flat[a:a + n].copy_((torch.randn(n, generator=gen) * scale)
                                .to(dtype))
        n_chunks = -(-flat.numel() // self.CHUNK)
        list(self._pool.map(chunk, range(n_chunks)))
        return out

    def full(self, shape: Tuple[int, ...], value: float,
             dtype: torch.dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()


def layer(tree: Union[ParamTree, Params], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a layer-stacked tree: every leaf's ``[i]`` view."""
    return {k: (layer(v, i) if isinstance(v, (ParamTree, dict)) else v[i])
            for k, v in tree.items()}


def f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 — without an op when it already is (the eager
    decode step is bound by the host's cost per op)."""
    return x if x.dtype == torch.float32 else x.float()


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = f32(x)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return as_dtype(x * f32(p["scale"]), orig)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = f32(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = x * f32(p["scale"]) + f32(p["bias"])
    return as_dtype(out, orig)


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


@functools.lru_cache(maxsize=16)
def _cached_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    return rope_freqs(head_dim, theta, device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (..., S, 1, hd/2) for ``positions`` (..., S) —
    computed once and shared by q and k."""
    freqs = _cached_freqs(head_dim, float(theta), positions.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate split HALVES (x[..., :hd/2], x[..., hd/2:]) of x (..., S, H,
    hd), not interleaved pairs, by the angles of ``rope_tables``."""
    x1, x2 = torch.chunk(f32(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return as_dtype(out, x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp(p: Params, x: torch.Tensor, act: str,
        split: bool = False) -> torch.Tensor:
    """The gated (``w_gate``) or plain MLP. ``split``: the FF dim holds
    this rank's part (``distributed/tensor_parallel.py``): ``w_gate`` /
    ``w_up`` column-parallel, ``w_down`` row-parallel, ``b_down`` added
    once after the sum."""
    if split:
        x = tp.copy_to_model(x)
    if "w_gate" in p:
        g = linear(x, p["w_gate"])
        u = linear(x, p["w_up"])
        h = (F.silu(g) if act == "silu"
             else F.gelu(g, approximate="tanh")) * u
        out = linear(h, p["w_down"])
        return tp.reduce_from_model(out) if split else out
    h = linear(x, p["w_up"])
    if "b_up" in p:
        h = h + p["b_up"]
    h = F.gelu(h, approximate="tanh")
    out = linear(h, p["w_down"])
    if split:
        out = tp.reduce_from_model(out)
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor,
          split: bool = False) -> torch.Tensor:
    """``table[tokens]``. ``F.embedding``'s backward sums each row's
    repeated tokens in a fixed order; plain indexing's accumulates them
    in a thread-dependent order, so a training step would not repeat
    bit for bit. ``split``: the table holds this rank's vocab rows
    (``tensor_parallel.vocab_parallel_embed``)."""
    if split:
        return tp.vocab_parallel_embed(table, tokens)
    return F.embedding(tokens.long(), table)


def unembed(table: torch.Tensor, x: torch.Tensor,
            split: bool = False) -> torch.Tensor:
    """table: (V, d), x: (..., d) -> logits (..., V), computed in f32.
    ``split``: the table holds this rank's vocab rows, and so do the
    logits' columns."""
    if split:
        x = tp.copy_to_model(x)
    return linear(f32(x), f32(table).t())


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token cross-entropy in f32. Returns (sum_loss, n_tokens) so callers
    can do the paper's weighted reduce (sum over workers / global count).
    The label pick is a gather (the JAX package contracts with a
    one-hot, which GSPMD splits over the vocab); where the logits hold
    this rank's vocab columns, ``tensor_parallel.vocab_parallel_xent``
    takes the loss."""
    if tp.head_split():
        return tp.vocab_parallel_xent(logits, labels, mask)
    logits = f32(logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    return torch.sum(nll * mask), torch.sum(mask)

