"""Port parity for the Mamba2 SSD chunked-scan kernel: the plain PyTorch
version (``repro_torch.kernels.ssd_scan``, what CPU tensors run: the
Pallas body's chunked form with torch einsums) against the JAX package's
Pallas kernel in interpret mode (``ssd_scan(..., interpret=True)``), its
sequential oracle ``ssd_ref`` and the model layer's ``ssd_chunked``, on
inputs drawn with numpy from a seed.

Tolerances are the JAX tests' own: 1e-4 against the kernel at the same
chunk and against ``ssd_chunked``; 5e-4 against the sequential oracle,
whose error grows with the accumulation depth (values are O(5) at
S = 256); 0.15 for bfloat16 inputs against the float32 oracle. At
S = 256 (max |y| = 68 here) the port and the JAX kernel are 1.7e-4 and
1.0e-4 from a float64 run of the same recurrence: the float32 rounding
of the in-chunk cumsum of dt * A (|cum| up to ~100, and exp(cum_i -
cum_j) takes the difference of two such values) sets both errors, a
float64 cumsum rounded to float32 gives the same, so the two float32
versions are held to each other there with the depth-scaled 5e-4 too.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
this plain version there, on the same cases and at full width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import (COUNTER, ssd_chunked_ref,  # noqa: E402
                                          ssd_ref, ssd_scan)

# B, S, nh, hd, N, chunk: the cases of tests/test_kernels_ssd.py
CASES = [
    (1, 32, 1, 32, 16, 16),
    (2, 64, 4, 32, 64, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 50, 3, 32, 64, 16),        # padding path (50 % 16 != 0)
    (1, 256, 8, 64, 128, 128),     # mamba2-780m's head and state widths
]


def _mk(seed, B, S, nh, hd, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, nh, hd).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, nh))).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.5)).astype(np.float32)
    Bm = (rng.randn(B, S, N) * 0.5).astype(np.float32)
    Cm = (rng.randn(B, S, N) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _port(args, dtype="float32", chunk=128):
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in args)
    cast = [t.to(getattr(torch, dtype)) for t in (x, dt, Bm, Cm)]
    before = COUNTER.count
    y = ssd_scan(cast[0], cast[1], A, cast[2], cast[3], chunk=chunk)
    assert COUNTER.count == before          # CPU tensors never launch
    assert y.dtype == cast[0].dtype and y.shape == x.shape
    return y.float().numpy()


def _jax_kernel(args, dtype="float32", chunk=128):
    x, dt, A, Bm, Cm = args
    c = [jnp.asarray(a, getattr(jnp, dtype)) for a in (x, dt, Bm, Cm)]
    y = j_ssd_scan(c[0], c[1], jnp.asarray(A), c[2], c[3], chunk=chunk,
                   interpret=True)
    return np.asarray(y.astype(jnp.float32))


def _oracle(args):
    return np.asarray(j_ssd_ref(*(jnp.asarray(a) for a in args)))


def _err(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", CASES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, nh, hd, N, chunk):
    args = _mk(0, B, S, nh, hd, N)
    got = _port(args, chunk=chunk)
    tol = 1e-4 if S <= 128 else 5e-4
    assert _err(got, _jax_kernel(args, chunk=chunk)) < tol
    assert _err(got, _oracle(args)) < 5e-4


@pytest.mark.parametrize("S,chunk", [(80, 128), (50, 16), (17, 16),
                                     (100, 48)])
def test_ragged_chunks(S, chunk):
    """The padding path, and chunks that are not powers of two:
    Q = min(chunk, S), so S = 80 with chunk 128 runs one chunk of 80."""
    args = _mk(S, 2, S, 2, 32, 32)
    got = _port(args, chunk=chunk)
    assert _err(got, _jax_kernel(args, chunk=chunk)) < 1e-4
    assert _err(got, _oracle(args)) < 1e-4


def test_chunk_independence():
    args = _mk(2, 1, 128, 2, 32, 32)
    outs = [_port(args, chunk=c) for c in (16, 32, 64, 128, 80)]
    for o in outs[1:]:
        assert _err(o, outs[0]) < 1e-4


@pytest.mark.parametrize("chunk", [16, 64])
def test_matches_model_chunked(chunk):
    """The port against ``repro.models.ssm.ssd_chunked``, the chunked
    form the JAX model layer trains with."""
    B, S, nh, hd, N = 2, 64, 4, 32, 64
    args = _mk(1, B, S, nh, hd, N)
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in args)
    ym, _ = ssd_chunked(x, dt, A, Bm[:, :, None, :], Cm[:, :, None, :],
                        chunk=chunk)
    ym = np.asarray(ym)
    assert _err(_port(args, chunk=chunk), ym) < 1e-4
    t = [torch.tensor(a) for a in args]
    assert _err(ssd_chunked_ref(*t, chunk=chunk).numpy(), ym) < 1e-4


def test_bf16_inputs():
    args = _mk(3, 1, 64, 2, 32, 32)
    got = _port(args, "bfloat16", chunk=16)
    assert _err(got, _oracle(args)) < 0.15
    assert _err(got, _jax_kernel(args, "bfloat16", chunk=16)) < 0.15


def test_sequential_oracle_matches_jax():
    args = _mk(4, 2, 48, 3, 32, 16)
    got = ssd_ref(*(torch.tensor(a) for a in args)).numpy()
    assert _err(got, _oracle(args)) < 1e-5


# B, S, nh, N, seed: a fixed sample of tests/test_kernels_ssd.py's
# property grid (hd = 32, chunk 16)
GRID = [(1, 17, 1, 16, 0), (2, 32, 2, 32, 7), (1, 48, 2, 16, 42),
        (2, 80, 1, 32, 99)]


@pytest.mark.parametrize("B,S,nh,N,seed", GRID)
def test_property_grid(B, S, nh, N, seed):
    args = _mk(seed, B, S, nh, 32, N)
    assert _err(_port(args, chunk=16), _oracle(args)) < 1e-4


def test_shapes_are_checked():
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _mk(0, 1, 8, 1, 32, 8))
    with pytest.raises(ValueError, match="do not agree"):
        ssd_scan(x, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="chunk=0"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=0)
