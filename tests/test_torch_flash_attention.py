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


# ---------------------------------------------------------------------------
# the CUDA kernel's numeric routes, emulated in plain PyTorch: float32 as
# 3xTF32 on the tensor cores, bfloat16 with P rounded to bf16 before P V
# ---------------------------------------------------------------------------
def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half an ulp of TF32 to the
    magnitude bits, then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's 3xTF32: big = tf32(x), small = tf32(x - big),
    the small products first; each TF32 product is exact in float32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _attention_3xtf32(q, k, v, causal=True, window=0):
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, S, D)
    s = _mm_3xtf32(qf, k.float()[:, :, None].transpose(-1, -2))
    qp = torch.arange(S)[:, None]
    kp = torch.arange(T)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.max(dim=-1, keepdim=True).values
    m = torch.where(m <= -5e29, torch.zeros_like(m), m) * D ** -0.5
    p = torch.exp(s * D ** -0.5 - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    o = _mm_3xtf32(p, v.float()[:, :, None])
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, S, D)


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                         1.0 + 2 * 2.0 ** -10, 3.0])
    assert torch.equal(_tf32(x), want)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = _tf32(r)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert ((r - big).abs() <= r.abs() * 2.0 ** -11).all()
    # big + small carries ~21 of float32's 24 bits
    assert ((r - big - _tf32(r - big)).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("B,H,K,S,T,D,win", CASES)
def test_3xtf32_route_within_f32_tolerance(B, H, K, S, T, D, win):
    """The f32 route's arithmetic (both products in 3xTF32) stays within
    the float32 tolerance of ``attention_ref`` and of the Pallas kernel:
    plain TF32 (one product) would not."""
    q, k, v = _mk(42, B, H, K, S, T, D)
    got = _attention_3xtf32(*(torch.tensor(a) for a in (q, k, v)),
                            window=win).numpy()
    want = _jax(j_flash, q, k, v, causal=True, window=win, block_q=32,
                block_k=32, interpret=True)
    assert _err(got, want) < 2e-5
    assert _err(got, _jax(j_ref, q, k, v, causal=True, window=win)) < 2e-5


def test_plain_tf32_would_miss_the_f32_tolerance():
    q, k, v = (torch.tensor(a) for a in _mk(42, 2, 4, 2, 128, 128, 64, ))
    ref = attention_ref(q, k, v)
    t = [_tf32(x) for x in (q, k, v)]
    one = attention_ref(*t)            # inputs cut to TF32 once
    assert (one - ref).abs().max() > 2e-5
    assert (_attention_3xtf32(q, k, v) - ref).abs().max() < 2e-5


def _attention_bf16_p(q, k, v, BK=64):
    """The bf16 route: scores from bf16 inputs with float32 accumulation,
    online softmax over key tiles of BK with base-2 exponentials, P
    rounded to bf16 before P V, and l summing the rounded P (the kernel's
    order). Causal, S == T."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    sl2 = D ** -0.5 * 1.4426950408889634
    qf = q.float().reshape(B, K, G, S, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    m = torch.full((B, K, G, S, 1), -1e30)
    l = torch.zeros(B, K, G, S, 1)
    o = torch.zeros(B, K, G, S, D)
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, BK):
        s = qf @ kf[..., k0:k0 + BK, :].transpose(-1, -2)
        ok = torch.arange(k0, k0 + BK)[None, :] <= qp
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        mn = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        mref = torch.where(mn <= -5e29, torch.zeros_like(mn), mn * sl2)
        p = torch.exp2(s * sl2 - mref).bfloat16().float()
        alpha = torch.where(m <= -5e29, torch.zeros_like(m),
                            torch.exp2((m - mn) * sl2))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        o = alpha * o + p @ vf[..., k0:k0 + BK, :]
        m = mn
    return (o / l.clamp_min(1e-30)).reshape(B, H, S, D)


def test_bf16_p_route_within_bf16_tolerance_at_a_long_row():
    """P rounded to bf16 before P V, at 2048 keys per row (B 1, H 4, K 1,
    D 128): within 3e-2 of ``attention_ref`` on the same bf16 inputs."""
    q, k, v = (torch.tensor(a).bfloat16()
               for a in _mk(11, 1, 4, 1, 2048, 2048, 128))
    got = _attention_bf16_p(q, k, v)
    assert torch.isfinite(got).all()
    assert (got - attention_ref(q, k, v).float()).abs().max() < 3e-2


def test_bf16_p_route_matches_pallas_kernel():
    q, k, v = _mk(7, 2, 4, 2, 128, 128, 64)
    t = [torch.tensor(a).bfloat16() for a in (q, k, v)]
    got = _attention_bf16_p(*t).numpy()
    want = _jax(j_flash, q, k, v, "bfloat16", block_q=32, block_k=32,
                interpret=True)
    assert _err(got, want) < 3e-2


def _row_err(got, want):
    """Largest ||got - want|| / ||want|| over output rows (D values)."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1)).max())


def test_bf16_rows_within_row_bound_and_a_dropped_tile_is_not():
    """``chip_smoke.py`` also holds bf16 outputs row by row, ||kernel -
    plain|| / ||plain|| <= 2^-6. The bf16-P route with its output rounded
    to bf16 stays within that at 2048 keys per row; the same attention
    with one 128-key tile left out of the last 128 rows is far past it."""
    q, k, v = (torch.tensor(a).bfloat16()
               for a in _mk(11, 1, 4, 1, 2048, 2048, 128))
    want = attention_ref(q, k, v)
    got = _attention_bf16_p(q, k, v, BK=128).bfloat16()
    assert _row_err(got, want) <= 2.0 ** -6
    S = 2048
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    keep = (kp <= qp) & ~((qp >= S - 128) & (kp >= 1024) & (kp < 1024 + 128))
    s = (q.float() @ k.float().transpose(-1, -2)) * 128 ** -0.5
    p = torch.softmax(torch.where(keep, s, torch.full_like(s, -1e30)), -1)
    dropped = (p @ v.float()).bfloat16()
    assert _row_err(dropped, want) > 10 * 2.0 ** -6
