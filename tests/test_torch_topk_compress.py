"""Port parity for the block-top-k kernels. The top-1 ``block_topk``
(``_topk_kernel``) and the fused error-feedback block-top-k compressor: the
plain PyTorch version (``repro_torch.kernels.topk_compress``, what CPU
tensors run) against the JAX package's Pallas kernel in interpret mode
(``fused_block_topk(..., interpret=True)`` — the kernel body itself, not
its numpy oracle, which differs on NaN rows), plus the port's
``GradientCompressor`` flat path against ``repro.core.compression``.
Inputs are drawn with numpy from a seed and handed to both sides; every
comparison is bit-exact (``np.array_equal``, NaN == NaN for residuals).

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
this plain version there, bit-exact, on the same cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.compression import GradientCompressor as JComp  # noqa: E402
from repro.core.compression import decompress_flat as j_decompress  # noqa: E402
from repro.kernels.topk_compress import block_topk as j_block_topk  # noqa: E402
from repro.kernels.topk_compress import fused_block_topk as j_fused  # noqa: E402
from repro.kernels.topk_compress import (  # noqa: E402
    fused_block_topk_batched as j_batched)
from repro_torch.core.compression import GradientCompressor  # noqa: E402
from repro_torch.core.compression import decompress_flat  # noqa: E402
from repro_torch.kernels.topk_compress import (  # noqa: E402
    BLOCK_TOPK_COUNTER, COUNTER, block_topk, block_topk_ref,
    fused_block_topk, fused_block_topk_batched)

# the cases of tests/test_kernels_topk.py::test_fused_matches_oracle
CASES = [(128, 8, 1), (1000, 16, 3), (64, 33, 5), (4096, 128, 2),
         (7, 8, 3), (5, 4, 9)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _both_batched(g, r, k, W):
    jv = j_batched(jnp.asarray(g), jnp.asarray(r), k=k, block_w=W,
                   interpret=True)
    tv = fused_block_topk_batched(torch.tensor(g), torch.tensor(r), k=k,
                                  block_w=W)
    return [np.asarray(x) for x in jv], [x.numpy() for x in tv]


@pytest.mark.parametrize("n,W,k", CASES)
def test_plain_matches_pallas_kernel(n, W, k):
    rng = np.random.RandomState(n + W + k)
    g = rng.randn(n).astype(np.float32)
    r = (rng.randn(n) * 0.3).astype(np.float32)
    jv = j_fused(jnp.asarray(g), jnp.asarray(r), k=k, block_w=W,
                 interpret=True)
    before = COUNTER.count
    tv = fused_block_topk(torch.tensor(g), torch.tensor(r), k=k, block_w=W)
    assert COUNTER.count == before          # CPU tensors never launch
    for a, b in zip(jv, tv):
        assert _same(a, b.numpy())
    # conservation: scatter(values) + residual == g + r
    dense = decompress_flat(tv[0], tv[1], n=n) + tv[2]
    np.testing.assert_allclose(dense.numpy(), g + r, atol=1e-6)


@pytest.mark.parametrize("n,W,k", CASES)
def test_batched_matches_pallas_and_per_worker(n, W, k):
    rng = np.random.RandomState(7 * n + k)
    g = rng.randn(3, n).astype(np.float32)
    r = (rng.randn(3, n) * 0.2).astype(np.float32)
    jv, tv = _both_batched(g, r, k, W)
    for a, b in zip(jv, tv):
        assert _same(a, b)
    for w in range(3):
        sv = fused_block_topk(torch.tensor(g[w]), torch.tensor(r[w]), k=k,
                              block_w=W)
        for a, b in zip(tv, sv):
            assert _same(a[w], b.numpy())


def test_nan_zero_and_tie_rows():
    """A NaN row selects nothing and keeps its residual (the Pallas body's
    rule), all-zero rows emit (0.0, first column), and magnitude ties go
    to the lowest column whatever the sign — batched over 3 workers."""
    rows = np.array([
        [0.5, np.nan, -2.0, 1.0],          # NaN: nothing selected
        [0.0, 0.0, 0.0, 0.0],              # all zero
        [3.0, -3.0, 3.0, 1.0],             # ties, both signs
        [-0.0, 0.0, -0.0, 0.0],            # signed zeros
        [1.0, 2.0, -2.0, 2.0],             # tie after the first pick
        [np.inf, -np.inf, 1.0, 0.0],       # infinities tie too
    ], np.float32)
    g = np.stack([rows.reshape(-1), rows[::-1].reshape(-1),
                  np.round(rows.reshape(-1) * 2)])
    r = np.zeros_like(g)
    r[2] = np.where(np.isnan(g[2]), 0.0, 1.0)
    for k in (1, 2, 4, 9):
        jv, tv = _both_batched(g, r, k, 4)
        for a, b in zip(jv, tv):
            assert _same(a, b)
    vals, idx, res = tv                      # k clamped to 4
    assert (vals[0, 0] == 0).all() and (idx[0, 0] == 0).all()
    assert _same(res[0, :4], rows[0])
    assert (idx[0, 1] == 4).all() and (vals[0, 1] == 0).all()
    assert idx[0, 2].tolist() == [8, 9, 10, 11]


def test_integer_rows_full_of_ties():
    rng = np.random.RandomState(5)
    g = rng.randint(-3, 4, size=(3, 999)).astype(np.float32)
    r = rng.randint(-1, 2, size=(3, 999)).astype(np.float32)
    for W, k in ((8, 3), (32, 1), (128, 5)):
        jv, tv = _both_batched(g, r, k, W)
        for a, b in zip(jv, tv):
            assert _same(a, b)


def test_block_w_range_is_checked():
    """The plain version takes any width >= 1; the kernel route (any
    tensor off the CPU) refuses W > 1024 before it launches anything."""
    g = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="block_w=0"):
        fused_block_topk_batched(g, g, k=1, block_w=0)
    with pytest.raises(ValueError, match="k=0"):
        fused_block_topk_batched(g, g, k=0, block_w=8)
    for W in (1024, 1025):
        v, i, res = fused_block_topk_batched(g, g, k=2, block_w=W)
        assert v.shape == (1, 1, 2) and i.tolist() == [[[0, 0]]]
    m = torch.zeros(1, 64, device="meta")
    with pytest.raises(ValueError, match="block_w=1025 .* CUDA kernel"):
        fused_block_topk_batched(m, m, k=1, block_w=1025)


def test_block_w_wider_than_the_kernel_on_the_cpu():
    """W = 2048, wider than the CUDA kernel's 1024: the CPU's plain
    version equals the Pallas kernel bit for bit (2 x 5000 values,
    k = 4)."""
    rng = np.random.RandomState(2048)
    g = rng.randn(2, 5000).astype(np.float32)
    r = (rng.randn(2, 5000) * 0.3).astype(np.float32)
    jv, tv = _both_batched(g, r, 4, 2048)
    assert tv[0].shape == (2, 3, 4)
    for a, b in zip(jv, tv):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# top-1 per block (the Pallas ``_topk_kernel``): bit for bit, signed zeros
# included, against the kernel body in interpret mode
# ---------------------------------------------------------------------------
def _bits(a):
    """The raw bit patterns of a float32 / bfloat16 array (numpy, jax or
    torch), so -0.0 and +0.0 differ."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        return a.numpy().view(np.uint16 if a.element_size() == 2
                              else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _topk_both(x, W, dtype="float32"):
    """x: float32 numpy of any shape -> (JAX kernel's bits, port's bits),
    after both sides cast x to ``dtype``."""
    jy = j_block_topk(jnp.asarray(x, getattr(jnp, dtype)), block_w=W,
                      interpret=True)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    before = BLOCK_TOPK_COUNTER.count
    ty = block_topk(tx, block_w=W)
    assert BLOCK_TOPK_COUNTER.count == before   # CPU tensors never launch
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert str(jy.dtype) == dtype
    return _bits(jy), _bits(ty)


# the shapes of tests/test_kernels_topk.py::test_matches_oracle, and
# W > 1024 (any W: the kernel has no cap)
TOPK_SHAPES = [((128,), 8), ((1000,), 16), ((64, 33), 128), ((3, 5, 7), 8),
               ((4096,), 128), ((2, 2), 8), ((5000,), 2048), ((3, 1500), 1100)]


@pytest.mark.parametrize("shape,W", TOPK_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_bit_exact_with_pallas_kernel(shape, W, dtype):
    rng = np.random.RandomState(int(np.prod(shape)) + W)
    x = rng.randn(*shape).astype(np.float32)
    jb, tb = _topk_both(x, W, dtype)
    assert np.array_equal(jb, tb)


def test_block_topk_special_rows():
    """The first max wins whatever the sign; a row holding a NaN comes
    out all zeros (the Pallas body's rule, not the numpy oracle's); the
    kept value keeps its sign bit (an all-zero row keeps x[0], -0.0
    included); +-inf is kept; the tail padding never wins."""
    rows = np.array([
        [0.5, np.nan, -2.0, 1.0],          # NaN: all zeros
        [0.0, 0.0, 0.0, 0.0],              # all zero: keeps x[0]
        [-0.0, 0.0, -0.0, 0.0],            # keeps x[0] = -0.0
        [3.0, -3.0, 3.0, 1.0],             # first of the ties
        [-3.0, 3.0, 1.0, -0.0],            # first of the ties, negative
        [np.inf, -np.inf, 1.0, 0.0],       # infinities tie too
        [-np.inf, 2.0, np.nan, 0.0],       # NaN beats inf: all zeros
        [1.0, -0.0, -0.0, -5.0],
    ], np.float32)
    for dtype in ("float32", "bfloat16"):
        for x in (rows.reshape(-1), rows.reshape(-1)[:-2],   # ragged tail
                  np.concatenate([rows.reshape(-1), [-0.0]]).astype(
                      np.float32)):
            jb, tb = _topk_both(x, 4, dtype)
            assert np.array_equal(jb, tb)
    y = block_topk(torch.tensor(rows.reshape(-1)), block_w=4).reshape(8, 4)
    assert (_bits(y[0]) == 0).all() and (_bits(y[6]) == 0).all()
    assert _bits(y[2]).tolist() == [0x80000000, 0, 0, 0]
    assert y[3].tolist() == [3.0, 0, 0, 0] and y[4].tolist() == [-3.0, 0, 0, 0]
    assert y[5].tolist() == [np.inf, 0, 0, 0]


@pytest.mark.parametrize("n,W,seed", [(1, 8, 0), (17, 16, 3), (999, 64, 7),
                                      (2000, 128, 50), (1531, 8, 11)])
def test_block_topk_property_grid(n, W, seed):
    """A fixed sample of tests/test_kernels_topk.py's property grid, with
    integer values (ties everywhere) beside Gaussian ones."""
    rng = np.random.RandomState(seed)
    for x in (rng.randn(n).astype(np.float32),
              rng.randint(-3, 4, size=n).astype(np.float32)):
        jb, tb = _topk_both(x, W)
        assert np.array_equal(jb, tb)
    y = block_topk(torch.tensor(x), block_w=W)
    assert int((y != 0).sum()) <= -(-n // W)


def test_block_topk_plain_version_and_checks():
    x = torch.tensor([[1.0, -4.0, 4.0], [0.0, np.nan, 1.0]])
    assert _bits(block_topk_ref(x)).tolist() == [
        [0, _bits(torch.tensor(-4.0)).item(), 0], [0, 0, 0]]
    with pytest.raises(ValueError, match="block_w=0"):
        block_topk(x, block_w=0)


# ---------------------------------------------------------------------------
# the compressor's flat path
# ---------------------------------------------------------------------------
COMPS = [dict(method="blocktopk", frac=1 / 32, block_w=32),
         dict(method="blocktopk", frac=0.01, block_w=128),
         dict(method="topk", frac=0.01), dict(method="topk", frac=0.3)]


@pytest.mark.parametrize("kw", COMPS, ids=lambda kw: f"{kw['method']}-"
                         f"{kw['frac']:.3g}")
def test_keep_counts_lattice_and_wire_bytes(kw):
    jc, tc = JComp(**kw), GradientCompressor(**kw)
    for n in (1, 31, 32, 33, 1000, 31786, 100_682_496):
        assert tc.flat_k(n) == jc.flat_k(n)
        assert tc.k_lattice(n) == jc.k_lattice(n)
        assert tc.packed_wire_bytes(n) == jc.packed_wire_bytes(n)
        for raw in (0, 1, 3, 7.5, n // 3, n, 10 * n):
            assert tc.quantize_k(n, raw) == jc.quantize_k(n, raw)
            assert tc.flat_k(n, raw) == jc.flat_k(n, raw)


@pytest.mark.parametrize("kw", COMPS, ids=lambda kw: f"{kw['method']}-"
                         f"{kw['frac']:.3g}")
@pytest.mark.parametrize("ties", [False, True], ids=["randn", "ties"])
def test_compress_flat_bit_equal(kw, ties):
    rng = np.random.RandomState(11)
    n = 1000
    if ties:        # integer-valued: |c| repeats everywhere
        g = rng.randint(-4, 5, size=n).astype(np.float32)
        r = rng.randint(-1, 2, size=n).astype(np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        r = (rng.randn(n) * 0.1).astype(np.float32)
    jc, tc = JComp(**kw), GradientCompressor(**kw)
    for k in (None, 64, 200):
        jm, jr = jc.compress_flat(jnp.asarray(g), jnp.asarray(r), k=k)
        tm, tr = tc.compress_flat(torch.tensor(g), torch.tensor(r), k=k)
        assert _same(jm.values, tm.values.numpy())
        assert _same(jm.indices, tm.indices.numpy())
        assert _same(jr, tr.numpy())
        assert tm.wire_bytes() == jm.wire_bytes() \
            == tc.packed_wire_bytes(n, k)
        assert _same(j_decompress(jm.values, jm.indices, n=n),
                     tm.dense().numpy())


def test_decompress_drops_out_of_range_indices():
    """JAX drops scatter indices >= n (tail-pad pairs); so must the port."""
    vals = np.array([1.5, 0.0, -2.0, 0.0], np.float32)
    idx = np.array([3, 7, 0, 9], np.int32)
    want = np.asarray(j_decompress(jnp.asarray(vals), jnp.asarray(idx), n=5))
    got = decompress_flat(torch.tensor(vals), torch.tensor(idx), n=5)
    assert _same(want, got.numpy())


def test_unported_methods_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        GradientCompressor("randk").compress_flat(torch.zeros(8), None)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        GradientCompressor("topk").roundtrip({}, None)
