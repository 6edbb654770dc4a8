"""A counter-based integer hash: random-looking draws as a pure function
of integer coordinates, with no generator state.

``mix32`` is a 32-bit integer finalizer (lowbias32) on int64 tensors that
hold values in ``[0, 2**32)``; ``chain_key`` folds a sequence of integer
coordinates (a seed, then counters) into one 32-bit key the same way, on
host ints; ``hash_range`` hashes the indices ``0 .. n-1`` under a key.
Every step is exact integer arithmetic, so the CPU and the card draw the
same bits. Each step is a bijection of 32-bit words, so ``hash_range``
gives ``n`` DISTINCT values for ``n <= 2**32``.

Users: the serving sampler's Gumbel noise (``serving/sampling.py``) and
randk's subset draws (``core/compression.py``).
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in two
    16-bit halves so no intermediate leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32) on int64 tensors holding
    values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    """``mix32`` of one host int in ``[0, 2**32)``."""
    x ^= x >> 16
    x = (x * _C1) & M32
    x ^= x >> 15
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def chain_key(seed: int, *counters: int) -> int:
    """``mix32(seed)``, then ``key = mix32(key ^ c)`` for each counter:
    one 32-bit key per coordinate tuple."""
    key = mix32_int(int(seed) & M32)
    for c in counters:
        key = mix32_int(key ^ (int(c) & M32))
    return key


def hash_range(key: int, n: int, device=None) -> torch.Tensor:
    """(n,) int64 ``mix32(mix32(key ^ i))`` for ``i = 0 .. n-1`` on
    ``device``: distinct values in ``[0, 2**32)`` (n <= 2**32)."""
    if n > 2 ** 32:
        raise ValueError(f"n={n}: the hash indexes at most 2**32 entries")
    i = torch.arange(n, dtype=torch.int64, device=device)
    return mix32(mix32(i ^ (int(key) & M32)))
