"""Next-token sampling for the serving engine (the port's counterpart of
``repro.serving.engine.ServingEngine._sample``).

``temperature == 0`` is exactly the greedy argmax (first index among tied
maxima, as ``jnp.argmax``). Otherwise each row's draw is a Gumbel-max over
``logits / temperature`` whose noise comes from a counter-based integer
hash of (``seed``, request id, generated-token index, vocabulary index):
plain tensor ops (``repro_torch.counter_hash``), no ``torch.Generator``
state. So a row's draw depends only on those four and its own logits — a request sampled alone equals
itself in any batch, and the CPU and the card draw the same token from
equal logits (the hash is exact integer arithmetic; the noise and the
scores are float64).

``top_k > 0`` keeps EXACTLY k candidates: the first k of a stable
descending sort, so ties with the k-th value are broken by the lowest
index and ``top_k == 1`` equals the greedy argmax. JAX's
``jax.random.categorical`` draws other bits, so the two packages agree in
distribution, not token for token.
"""
from __future__ import annotations

import torch

from repro_torch.counter_hash import M32 as _M32
from repro_torch.counter_hash import mix32

NEG_INF = -1e30


def gumbel_noise(seed: int, rids: torch.Tensor, gidx: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) float64 standard Gumbel noise on ``rids``' device: entry
    (b, v) is a pure function of (seed, rids[b], gidx[b], v)."""
    dev = rids.device
    rids, gidx = rids.to(torch.int64), gidx.to(torch.int64)
    key = mix32(torch.full_like(rids, int(seed) & _M32))
    key = mix32(key ^ (rids & _M32))
    key = mix32(key ^ (gidx & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = mix32(mix32(key[:, None] ^ v[None, :]))
    u = (h.to(torch.float64) + 0.5) * 2.0 ** -32       # in (0, 1), exact
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, rids, gidx, *, temperature: float,
                  top_k: int, seed: int) -> torch.Tensor:
    """Next token per row of ``(B, V)`` logits as an int32 ``(B,)``
    tensor on the logits' device. ``rids`` / ``gidx``: ``(B,)`` integers
    (request id mod 2**31, generated-token index), as tensors or arrays;
    the greedy path never reads them, so never moves them."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    rids = torch.as_tensor(rids, device=logits.device)
    gidx = torch.as_tensor(gidx, device=logits.device)
    lg = logits.float() / temperature
    V = lg.shape[-1]
    if 0 < top_k < V:
        vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
        lg = torch.full_like(lg, NEG_INF).scatter_(
            1, idx[:, :top_k], vals[:, :top_k])
    score = lg.to(torch.float64) + gumbel_noise(seed, rids, gidx, V)
    return torch.argmax(score, dim=-1).to(torch.int32)
