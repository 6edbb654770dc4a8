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
this plain version there, on the same cases and at full width. What can
be checked here is its arithmetic: ``ssd_scan_split_ref`` is the
kernel's partition (chunk states from zero, the state pass, C B^T shared
by all heads), held against the Pallas kernel and the oracle alone and
with its four products emulated as the kernel's 3xTF32; plain TF32 is
shown to miss the tolerance ``chip_smoke.py`` applies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import (COUNTER, ssd_chunked_ref,  # noqa: E402
                                          ssd_ref, ssd_scan, ssd_scan_ref,
                                          ssd_scan_split_ref)

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


# ---------------------------------------------------------------------------
# the CUDA kernel's partition and numeric route, in plain PyTorch: chunk
# states from zero, the state pass, the scan with C B^T shared by all
# heads, and the four products as 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------
RAGGED = [(80, 128), (50, 16), (17, 16), (100, 48), (129, 128)]


def _split(args, chunk, mm=torch.matmul):
    t = [torch.tensor(a) for a in args]
    return ssd_scan_split_ref(*t, chunk=chunk, mm=mm).numpy()


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", CASES)
def test_split_ref_matches_pallas_kernel_and_oracle(B, S, nh, hd, N, chunk):
    args = _mk(0, B, S, nh, hd, N)
    got = _split(args, chunk)
    tol = 1e-4 if S <= 128 else 5e-4
    assert _err(got, _jax_kernel(args, chunk=chunk)) < tol
    assert _err(got, _oracle(args)) < 5e-4


@pytest.mark.parametrize("S,chunk", RAGGED)
def test_split_ref_ragged_chunks(S, chunk):
    args = _mk(S, 2, S, 2, 32, 32)
    got = _split(args, chunk)
    tol = 1e-4 if S <= 128 else 5e-4
    assert _err(got, _jax_kernel(args, chunk=chunk)) < tol
    assert _err(got, _oracle(args)) < tol


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


def _mm_tf32(a, b):
    """a @ b with both operands cut to TF32 once (plain TF32)."""
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", CASES)
def test_3xtf32_route_within_f32_tolerance(B, S, nh, hd, N, chunk):
    """The kernel's arithmetic (its partition, all four products in
    3xTF32) stays within the JAX tests' tolerances of the Pallas kernel
    and of the sequential oracle."""
    args = _mk(0, B, S, nh, hd, N)
    got = _split(args, chunk, mm=_mm_3xtf32)
    tol = 1e-4 if S <= 128 else 5e-4
    assert _err(got, _jax_kernel(args, chunk=chunk)) < tol
    assert _err(got, _oracle(args)) < 5e-4


def _scaled_tol(ref):
    """``chip_smoke.py``'s tolerance: 5e-4 x max(1, max|y| / 5)."""
    return 5e-4 * max(1.0, float(np.abs(ref).max()) / 5.0)


def test_plain_tf32_would_miss_the_scaled_tolerance():
    """At one sequence of 1024 steps (4 heads of 64, N 128, chunk 128) one
    TF32 product per float32 product misses the tolerance ``chip_smoke.py``
    holds the kernel to; 3xTF32 keeps well inside it: the reason for the
    route."""
    args = _mk(7, 1, 1024, 4, 64, 128)
    ref = ssd_scan_ref(*(torch.tensor(a) for a in args), chunk=128).numpy()
    tol = _scaled_tol(ref)
    assert _err(_split(args, 128, mm=_mm_tf32), ref) > tol
    assert _err(_split(args, 128, mm=_mm_3xtf32), ref) < tol / 10


def test_mamba2_780m_head_count():
    """``mamba2-780m``'s 48 heads of 64 and N 128 at chunk 128, one
    sequence of 256 steps: the plain version, the kernel's partition and
    its 3xTF32 route within 5e-4 of the oracle, as the Pallas kernel is
    (4.1e-4 here: the float32 cumsum's rounding over 48 x 16 384 outputs
    of up to |y| = 61); so within 1e-3 of the Pallas kernel."""
    args = _mk(11, 1, 256, 48, 64, 128)
    want = _jax_kernel(args, chunk=128)
    oracle = _oracle(args)
    assert _err(want, oracle) < 5e-4
    for got in (_port(args, chunk=128), _split(args, 128),
                _split(args, 128, mm=_mm_3xtf32)):
        assert _err(got, oracle) < 5e-4
        assert _err(got, want) < 1e-3


# ---------------------------------------------------------------------------
# the CUDA route's shape plan (``ops.plan``): hd zero-padded to a built
# width or cut into slices of 128, N zero-padded to a multiple of 4, the
# largest chunk <= 128 that fits shared memory, N cut into slices of 256
# where no chunk of 16 fits, B cut to the grid
# ---------------------------------------------------------------------------
# B, S, nh, hd, N, chunk
PLAN_PALLAS = [(1, 40, 2, 16, 16, 16), (1, 48, 2, 96, 16, 16),
               (1, 40, 1, 160, 8, 16), (2, 40, 2, 32, 6, 16),
               (1, 300, 1, 32, 8, 256), (1, 160, 1, 32, 256, 128)]


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", PLAN_PALLAS)
def test_plain_matches_pallas_kernel_at_unbuilt_shapes(B, S, nh, hd, N,
                                                       chunk):
    """hd 16, 96 and 160, N 6, chunk 256 and N 256 at chunk 128: the
    plain version against the Pallas kernel at the same chunk."""
    args = _mk(hd + N, B, S, nh, hd, N)
    tol = 1e-4 if S <= 128 else 5e-4
    assert _err(_port(args, chunk=chunk),
                _jax_kernel(args, chunk=chunk)) < tol


# B, S, nh, hd, N, chunk, grid limit
PLAN_CASES = [(2, 40, 3, 16, 6, 256, 65535), (1, 300, 2, 160, 6, 256, 65535),
              (1, 200, 2, 96, 256, 128, 65535), (3, 33, 2, 32, 2, 8, 2),
              (1, 70, 1, 32, 1200, 128, 65535)]


@pytest.mark.parametrize("B,S,nh,hd,N,chunk,limit", PLAN_CASES)
def test_shape_plan_driven_by_the_plain_version(B, S, nh, hd, N, chunk,
                                                limit):
    """``plan`` with the plain version as its launch equals the plain
    version at the caller's chunk within the card's tolerance, 5e-4 x
    max(1, max|y| / 5), and each piece it launches is one the kernel
    takes: hd built, N a multiple of 4, a chunk <= 128 within shared
    memory, at most ``limit`` rows."""
    from repro_torch.kernels.ssd_scan.ops import (_SMEM_LIMIT, HEAD_DIMS,
                                                  plan, smem_bytes)
    args = [torch.tensor(a) for a in _mk(hd * N, B, S, nh, hd, N)]
    seen = []

    def launch(x, dt, A, Bm, Cm, q):
        Q = min(q, x.shape[1])
        assert x.shape[-1] in HEAD_DIMS and Bm.shape[-1] % 4 == 0
        assert Q <= 128 and x.shape[0] <= limit
        assert smem_bytes(Q, Bm.shape[-1], x.shape[-1]) <= _SMEM_LIMIT
        seen.append((x.shape[-1], Bm.shape[-1], Q))
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=q)
    got = plan(launch, *args, chunk=chunk, limit=limit)
    want = ssd_scan_ref(*args, chunk=chunk)
    scale = max(1.0, float(want.abs().max()) / 5)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 5e-4 * scale
    assert seen
    if N == 256:
        assert {q for _, _, q in seen} == {64}  # 128 fits at no hd
    if N == 1200:
        assert {n for _, n, _ in seen} == {256, 176}
