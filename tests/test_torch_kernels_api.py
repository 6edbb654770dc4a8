"""The port's public kernel API as a whole: ``repro_torch.kernels``
exports the names ``repro.kernels`` exports, and each agrees with its
JAX counterpart (Pallas kernels in interpret mode) on one small case of
inputs drawn with numpy from a seed, within the JAX tests' tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as jk  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402

API = ("flash_attention", "flash_decode", "ssd_scan", "block_topk")


def test_exports_match_the_jax_package():
    public = {n for n in dir(jk) if not n.startswith("_")
              and callable(getattr(jk, n))}
    assert public == set(API)
    for name in API:
        assert callable(getattr(tk, name))


def _case(name, rng):
    """(args, kwargs, tolerance) of one small case per kernel."""
    f = np.float32
    if name == "flash_attention":
        return ((rng.randn(1, 4, 48, 32).astype(f),
                 rng.randn(1, 2, 48, 32).astype(f),
                 rng.randn(1, 2, 48, 32).astype(f)),
                dict(window=16, block_q=16, block_k=16), 2e-5)
    if name == "flash_decode":
        B, H, K, D, N, ps, P = 3, 4, 2, 32, 10, 8, 3
        pm = np.full((B, P), N, np.int32)
        pm[0, :2], pm[1, :3], pm[2, :1] = [4, 1], [0, 7, 2], [9]
        return ((rng.randn(B, H, D).astype(f),
                 rng.randn(N, ps, K, D).astype(f),
                 rng.randn(N, ps, K, D).astype(f), pm,
                 np.array([12, 20, 5], np.int32),
                 np.array([1, 1, 0], np.int32)), {}, 2e-5)
    if name == "ssd_scan":
        S, nh, hd, N = 40, 2, 32, 16
        return ((rng.randn(1, S, nh, hd).astype(f),
                 np.log1p(np.exp(rng.randn(1, S, nh))).astype(f),
                 (-np.exp(rng.randn(nh) * 0.5)).astype(f),
                 (rng.randn(1, S, N) * 0.5).astype(f),
                 (rng.randn(1, S, N) * 0.5).astype(f)), dict(chunk=16), 1e-4)
    return (rng.randn(7, 45).astype(f),), dict(block_w=32), 0.0


@pytest.mark.parametrize("name", API)
def test_each_kernel_agrees_with_jax(name):
    args, kw, tol = _case(name, np.random.RandomState(len(name)))
    want = np.asarray(getattr(jk, name)(*(jnp.asarray(a) for a in args),
                                        interpret=True, **kw))
    got = getattr(tk, name)(*(torch.tensor(a) for a in args), **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol
