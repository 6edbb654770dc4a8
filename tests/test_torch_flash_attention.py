"""Port parity for the flash attention kernel: the plain PyTorch version
(``repro_torch.kernels.flash_attention``, what CPU tensors run) against
the JAX package's Pallas kernel in interpret mode
(``flash_attention(..., interpret=True)``, the kernel body itself) and
its oracle ``attention_ref``, on inputs drawn with numpy from a seed.
Tolerances are the JAX tests' own: 2e-5 in float32, 3e-2 in bfloat16.

The JAX wrapper pads T to a block multiple and masks the padded keys
only through causality, so with ``causal=False`` and a ragged T (or
S > T) its zero keys enter the softmax; the port masks them, and those
cases are held against ``attention_ref`` only.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
this plain version there, on the same cases and at full width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (COUNTER,  # noqa: E402
                                                 attention_ref,
                                                 flash_attention)

# B, H, K, S, T, D, window: the cases of tests/test_kernels_flash.py
CASES = [
    (1, 1, 1, 32, 32, 32, 0),
    (2, 4, 2, 128, 128, 64, 0),
    (1, 8, 1, 64, 64, 128, 0),
    (2, 4, 4, 96, 96, 64, 0),
    (1, 4, 2, 128, 128, 64, 32),
    (1, 2, 2, 256, 256, 32, 96),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _mk(seed, B, H, K, S, T, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, S, D).astype(np.float32),
            rng.randn(B, K, T, D).astype(np.float32),
            rng.randn(B, K, T, D).astype(np.float32))


def _port(q, k, v, dtype="float32", **kw):
    t = [torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    before = COUNTER.count
    out = flash_attention(*t, **kw)
    assert COUNTER.count == before          # CPU tensors never launch
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    return out.float().numpy()


def _jax(fn, q, k, v, dtype="float32", **kw):
    t = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    return np.asarray(fn(*t, **kw).astype(jnp.float32))


def _err(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("B,H,K,S,T,D,win", CASES)
def test_plain_matches_pallas_kernel(B, H, K, S, T, D, win):
    q, k, v = _mk(42, B, H, K, S, T, D)
    want = _jax(j_flash, q, k, v, causal=True, window=win, block_q=32,
                block_k=32, interpret=True)
    got = _port(q, k, v, causal=True, window=win, block_q=32, block_k=32)
    assert _err(got, want) < 2e-5
    assert _err(got, _jax(j_ref, q, k, v, causal=True, window=win)) < 2e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dtypes(dtype):
    q, k, v = _mk(7, 2, 4, 2, 64, 64, 64)
    want = _jax(j_flash, q, k, v, dtype, block_q=32, block_k=32,
                interpret=True)
    assert _err(_port(q, k, v, dtype), want) < TOL[dtype]


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 64), (64, 32), (128, 128)])
def test_block_shape_independence(bq, bk):
    """The port's output does not depend on the tile hints, and equals
    the JAX kernel at every tiling."""
    q, k, v = _mk(3, 1, 2, 2, 128, 128, 32)
    got = _port(q, k, v, block_q=bq, block_k=bk)
    assert _err(got, _port(q, k, v)) < 2e-5
    want = _jax(j_flash, q, k, v, block_q=bq, block_k=bk, interpret=True)
    assert _err(got, want) < 2e-5


# B, H, K, S, T, D, causal, window, block: S != T with T a block multiple
# (no padded keys, so the JAX kernel is right there too)
S_NE_T = [(1, 4, 2, 48, 64, 32, True, 0, 16),
          (2, 2, 1, 96, 32, 64, True, 0, 32),
          (1, 2, 2, 64, 96, 32, False, 24, 32),
          (1, 2, 1, 80, 48, 32, True, 16, 16)]


@pytest.mark.parametrize("B,H,K,S,T,D,causal,win,blk", S_NE_T)
def test_s_ne_t(B, H, K, S, T, D, causal, win, blk):
    q, k, v = _mk(S + T, B, H, K, S, T, D)
    got = _port(q, k, v, causal=causal, window=win)
    want = _jax(j_flash, q, k, v, causal=causal, window=win, block_q=blk,
                block_k=blk, interpret=True)
    assert _err(got, want) < 2e-5
    assert _err(got, _jax(j_ref, q, k, v, causal=causal, window=win)) < 2e-5


@pytest.mark.parametrize("causal,win,S,T", [(True, 1, 32, 32),
                                            (False, 8, 64, 16)])
def test_fully_masked_rows_are_exact_zeros(causal, win, S, T):
    """A tight window leaves rows with one key (causal) or none (the
    non-causal window past the last key): no NaN, exact zeros."""
    q, k, v = _mk(9, 1, 2, 2, S, T, 32)
    got = _port(q, k, v, causal=causal, window=win)
    assert np.isfinite(got).all()
    want = _jax(j_flash, q, k, v, causal=causal, window=win, block_q=16,
                block_k=16, interpret=True)
    assert _err(got, want) < 2e-5
    assert _err(got, _jax(j_ref, q, k, v, causal=causal, window=win)) < 2e-5
    if not causal:
        dead = np.arange(S) > T - 1 + win - 1     # no t with t > s - win
        assert dead.any() and (got[:, :, dead] == 0).all()


@pytest.mark.parametrize("S,T,win", [(40, 40, 0), (24, 40, 0), (40, 24, 12)])
def test_ragged_non_causal_masks_padded_keys(S, T, win):
    """causal=False with T not a block multiple: the JAX kernel lets its
    zero-padded keys into the softmax (ROADMAP D); the port masks them
    and equals ``attention_ref``."""
    q, k, v = _mk(5, 1, 2, 1, S, T, 32)
    got = _port(q, k, v, causal=False, window=win, block_q=16, block_k=16)
    want = _jax(j_ref, q, k, v, causal=False, window=win)
    assert _err(got, want) < 2e-5


# B, G, S, D, window: a fixed sample of tests/test_kernels_flash.py's
# property grid (K = 2 kv heads, S = T)
GRID = [(1, 1, 32, 32, 0), (3, 2, 48, 64, 16), (2, 4, 64, 32, 64),
        (1, 4, 48, 32, 48), (2, 1, 64, 64, 16)]


@pytest.mark.parametrize("B,G,S,D,win", GRID)
def test_property_grid(B, G, S, D, win):
    q, k, v = _mk(B * 101 + S, B, 2 * G, 2, S, S, D)
    want = _jax(j_ref, q, k, v, window=win)
    got = _port(q, k, v, window=win, block_q=16, block_k=16)
    assert _err(got, want) < 3e-5


def test_plain_version_is_attention_ref_and_shapes_are_checked():
    q, k, v = (torch.tensor(a) for a in _mk(1, 1, 4, 2, 16, 24, 32))
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       attention_ref(q, k, v, causal=False))
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q, k[:, :1].expand(1, 3, 24, 32), v[:, :1].expand(
            1, 3, 24, 32))
    with pytest.raises(ValueError, match="window=-1"):
        flash_attention(q, k, v, window=-1)
