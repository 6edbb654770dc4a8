"""Port parity for randk and the dense reducer path:
``repro_torch.core.compression``'s randk (flat and leaf-wise) and its
leaf-wise masks / ``roundtrip`` / ``wire_bytes``, and
``repro_torch.core.reducer``'s ``weighted_reduce`` and
``MasterReducer(fused=False)``, against the JAX package on the CPU. The
cases mirror ``tests/test_compression.py`` and ``tests/test_reducer.py``.

randk draws from the port's counter hash, not ``jax.random``, so it is
held by invariants: k distinct indices, exact mass conservation, masks
that change from step to step, and a chi-square bound on selection
counts. Tolerances: masks, selections and wire bytes bit-equal; sent and
residual trees bit-equal (a selection of the same float32 sums);
parameters of a 10-step run within 1e-6 absolute (float32 optimizer
arithmetic, as ``tests/test_torch_train.py``); the fused path against the
dense one within the JAX package's own pin, 1e-5
(``tests/test_fused_reduce.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.core import compression as jc  # noqa: E402
from repro.core.reducer import MasterReducer as JReducer  # noqa: E402
from repro.core.reducer import weighted_reduce as j_weighted  # noqa: E402
from repro.optim import get_optimizer as j_opt  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402
from repro_torch.core import MasterReducer, weighted_reduce  # noqa: E402
from repro_torch.core.flatbuf import tree_leaves  # noqa: E402
from repro_torch.kernels.topk_compress import block_topk  # noqa: E402
from repro_torch.optim import get_optimizer, sgd  # noqa: E402

SHAPES = {"a": (32,), "b": {"c": (8, 16), "d": (5,)}}


def _np_tree(rng, shapes=SHAPES, scale=1.0):
    return {k: (_np_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.randn(*v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


def _same_trees(t_tree, j_tree):
    tl, jl = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert _same(a.numpy(), b), (a, b)


# ---------------------------------------------------------------------------
# randk: the counter-hash draw
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,frac", [(300, 0.1), (1000, 0.01), (64, 1.0)])
def test_randk_flat_invariants(n, frac):
    """k distinct indices, scatter(vals) + res == g + r bit for bit, the
    unscaled payload, and the JAX package's wire accounting."""
    rng = np.random.RandomState(0)
    g = torch.tensor(rng.randn(n).astype(np.float32))
    r = torch.tensor(rng.randn(n).astype(np.float32))
    comp = tc.GradientCompressor("randk", frac=frac, seed=3)
    msg, res = comp.compress_flat(g, r, step=5)
    k = comp.flat_k(n)
    idx = msg.indices.numpy()
    assert idx.dtype == np.int32 and len(np.unique(idx)) == k == idx.size
    c = g + r
    assert _same(msg.values.numpy(), c.numpy()[idx])        # unscaled
    assert torch.equal(msg.dense() + res, c)
    assert bool((res[msg.indices.long()] == 0).all())
    jcomp = jc.GradientCompressor("randk", frac=frac, seed=3)
    jm, _ = jcomp.compress_flat(jnp.asarray(g.numpy()), jnp.asarray(r.numpy()),
                                step=5)
    assert msg.wire_bytes() == jm.wire_bytes() == comp.packed_wire_bytes(n)


def test_randk_draw_is_keyed_and_uniform():
    """Masks differ across steps and across worker rows, the same key
    repeats, the scores are all distinct, and the selection counts over
    many steps pass a chi-square test of uniformity (like the sampler's):
    n 64, k 8, 4000 steps — 500 expected per index; 63 degrees of
    freedom, whose 0.999 quantile is 103.4."""
    n, k, steps = 64, 8, 4000
    comp = tc.GradientCompressor("randk", frac=k / n, seed=11)
    sels = [tc.randk_indices(comp.flat_key(s), n, k).numpy()
            for s in range(steps)]
    assert all(len(set(x)) == k for x in sels)
    assert sum(set(sels[s]) != set(sels[s + 1]) for s in range(50)) >= 49
    assert set(tc.randk_indices(comp.flat_key(7, 1), n, k).numpy()) \
        != set(sels[7])
    assert np.array_equal(tc.randk_indices(comp.flat_key(7), n, k).numpy(),
                          sels[7])
    scores = tc.randk_scores(comp.flat_key(0), 100_000)
    assert torch.unique(scores).numel() == 100_000
    counts = np.bincount(np.concatenate(sels), minlength=n)
    expect = steps * k / n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 103.4, chi2


def test_fused_randk_reduce_rows():
    """The fused reducer's randk branch: worker row w of reduce step s
    sends the k largest scores under ``flat_key(s, w)`` (row 0's message
    is ``compress_flat``'s), each row's residual + its sent entries ==
    g + r bit for bit, a deferred row keeps all of g + r, and the update
    is the segment-sum of what was sent over the on-time samples."""
    n, frac = 500, 0.05
    comp = tc.GradientCompressor("randk", frac=frac, seed=4)
    k = comp.flat_k(n)
    rng = np.random.RandomState(12)
    red = MasterReducer({"w": torch.zeros(n)}, sgd(lr=1.0), compressor=comp)
    for step in range(3):
        g = {f"w{i}": torch.tensor(rng.randn(n).astype(np.float32))
             for i in range(3)}
        old = {w: red._residuals.get(w, torch.zeros(n)) for w in g}
        before = red.flat_params
        red.reduce_and_step({w: ({"w": x}, 2) for w, x in g.items()},
                            defer=["w2"])
        total = torch.zeros(n)
        for row, w in enumerate(sorted(g)):
            c = g[w] + old[w]
            if w == "w2":
                assert torch.equal(red._residuals[w], c)
                continue
            idx = tc.randk_indices(comp.flat_key(step, row), n, k).long()
            assert len(set(idx.tolist())) == k
            sent = torch.zeros(n).index_add_(0, idx, c[idx])
            assert torch.equal(red._residuals[w] + sent, c)
            assert bool((red._residuals[w][idx] == 0).all())
            if row == 0:
                msg, res = comp.compress_flat(g[w], old[w], step=step)
                assert torch.equal(msg.indices.long(), idx)
                assert torch.equal(res, red._residuals[w])
            total = total.index_add_(0, idx, c[idx])
        assert torch.allclose(before - red.flat_params, total / 4.0,
                              atol=1e-6)
        assert red.last_wire_bytes == 2 * 8 * k


def test_counter_hash_host_and_tensor_agree():
    """``chain_key`` on host ints equals ``mix32`` chained on tensors (the
    sampler's key chain), and the sampler draws as before."""
    from repro_torch.counter_hash import chain_key, hash_range, mix32
    from repro_torch.serving.sampling import gumbel_noise

    seed, a, b = 123, 7, 2 ** 31 + 5
    t = mix32(torch.tensor([seed], dtype=torch.int64))
    t = mix32(mix32(t ^ a) ^ (b & 0xFFFFFFFF))
    assert int(t) == chain_key(seed, a, b)
    h = hash_range(chain_key(seed, a, b), 16)
    want = mix32(mix32(torch.arange(16) ^ chain_key(seed, a, b)))
    assert torch.equal(h, want)
    u = (h.double() + 0.5) * 2.0 ** -32
    noise = gumbel_noise(seed, torch.tensor([a]), torch.tensor([b]), 16)
    assert torch.equal(noise[0], -torch.log(-torch.log(u)))


# ---------------------------------------------------------------------------
# the leaf-wise masks and roundtrip against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "ties", "zeros", "short"])
def test_topk_and_block_masks_bit_equal(case):
    rng = np.random.RandomState(4)
    x = {"random": rng.randn(200),
         "ties": np.round(rng.randn(200) * 2) / 2,       # many equal |x|
         "zeros": np.zeros(200),
         "short": rng.randn(7)}[case].astype(np.float32)
    for k in (1, 3, 17, 199, 500):
        assert _same(tc._topk_mask(torch.tensor(x), k).numpy(),
                     jc._topk_mask(jnp.asarray(x), k))
    for block in (1, 4, 32, 64, 300):
        assert _same(tc._block_top1_mask(torch.tensor(x), block).numpy(),
                     jc._block_top1_mask(jnp.asarray(x), block))


@pytest.mark.parametrize("method,frac", [("topk", 0.01), ("topk", 0.1),
                                         ("topk", 0.5), ("blocktopk", 1 / 8),
                                         ("blocktopk", 1 / 64)])
def test_roundtrip_bit_equal_over_steps(method, frac):
    """Five error-feedback steps of the leaf-wise channel: sent and
    residual trees bit-equal, and the wire bytes equal."""
    rng = np.random.RandomState(5)
    tcomp = tc.GradientCompressor(method, frac=frac)
    jcomp = jc.GradientCompressor(method, frac=frac)
    tres = jres = None
    for step in range(5):
        g = _np_tree(rng)
        tsent, tres = tcomp.roundtrip(_t(g), tres, step=step)
        jsent, jres = jcomp.roundtrip(_j(g), jres, step=step)
        _same_trees(tsent, jsent)
        _same_trees(tres, jres)
        assert tcomp.wire_bytes(_t(g)) == jcomp.wire_bytes(_j(g))
    assert tc.dense_bytes(_t(g)) == jc.dense_bytes(_j(g))


def test_randk_roundtrip_invariants():
    """Leaf-wise randk: each leaf keeps exactly its k (the scores never
    tie), sent + residual == g + r bit for bit, masks re-drawn per step
    and per leaf, the same step repeats."""
    rng = np.random.RandomState(6)
    g = _t(_np_tree(rng))
    comp = tc.GradientCompressor("randk", frac=0.25, seed=2)
    masks = []
    for step in range(3):
        sent, res = comp.roundtrip(g, None, step=step)
        for s, r, x in zip(tree_leaves(sent), tree_leaves(res),
                           tree_leaves(g)):
            assert int((s != 0).sum()) == max(1, int(0.25 * x.numel()))
            assert torch.equal(s + r, x)
        masks.append([(s != 0) for s in tree_leaves(sent)])
    for a, b in zip(masks[0], masks[1]):
        assert not torch.equal(a, b)
    again, _ = comp.roundtrip(g, None, step=0)
    for a, b in zip(tree_leaves(again), masks[0]):
        assert torch.equal(a != 0, b)
    same = _t({"a": np.ones(32, np.float32), "b": np.ones(32, np.float32)})
    sa, _ = comp.roundtrip(same, None, step=0)
    assert not torch.equal(sa["a"] != 0, sa["b"] != 0)     # keyed per leaf


# mirrors of tests/test_compression.py
def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.3, 0.05])
    sent, res = tc.GradientCompressor("topk", frac=2 / 6).roundtrip(
        {"x": x}, None)
    assert set(torch.nonzero(sent["x"]).reshape(-1).tolist()) == {1, 3}
    assert torch.allclose(sent["x"] + res["x"], x, atol=1e-6)


def test_randk_unscaled_payload():
    x = torch.tensor(np.random.RandomState(0).randn(4096).astype(np.float32))
    sent, res = tc.GradientCompressor("randk", frac=0.25, seed=3).roundtrip(
        {"x": x}, None)
    nz = sent["x"] != 0
    assert abs(float(nz.float().mean()) - 0.25) < 0.05
    assert torch.equal(sent["x"][nz], x[nz])
    assert torch.equal(sent["x"] + res["x"], x)


def test_blocktopk_one_per_block_matches_kernel_api():
    x = torch.tensor(np.random.RandomState(1).randn(1024).astype(np.float32))
    sent, _ = tc.GradientCompressor("blocktopk", frac=1 / 64).roundtrip(
        {"x": x}, None)
    assert ((sent["x"].reshape(-1, 64) != 0).sum(1) == 1).all()
    sent, _ = tc.GradientCompressor("blocktopk", frac=1 / 32).roundtrip(
        {"x": x[:512]}, None)
    assert torch.equal(sent["x"], block_topk(x[:512], block_w=32))


def test_wire_bytes_budget():
    tree = _t(_np_tree(np.random.RandomState(2), {"a": (1000,),
                                                  "b": (50, 20)}))
    c = tc.GradientCompressor("topk", frac=0.01)
    assert c.wire_bytes(tree) == 8 * (10 + 10)
    assert tc.dense_bytes(tree) == 4 * 2000


@pytest.mark.parametrize("method", ["topk", "randk", "blocktopk"])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_error_feedback_mass_conservation(method, frac):
    tree = _t(_np_tree(np.random.RandomState(7)))
    sent, res = tc.GradientCompressor(method, frac=frac, seed=1).roundtrip(
        tree, None)
    for s, r, x in zip(tree_leaves(sent), tree_leaves(res),
                       tree_leaves(tree)):
        assert torch.equal(s + r, x)


# ---------------------------------------------------------------------------
# weighted_reduce and the dense reducer
# ---------------------------------------------------------------------------
def test_weighted_reduce_bit_equal_and_errors():
    rng = np.random.RandomState(8)
    msgs = [(_np_tree(rng), n) for n in (3, 9, 12)]
    got = weighted_reduce([(_t(g), n) for g, n in msgs])
    want = j_weighted([(_j(g), n) for g, n in msgs])
    _same_trees(got, want)
    rev = weighted_reduce([(_t(g), n) for g, n in reversed(msgs)])
    for a, b in zip(tree_leaves(got), tree_leaves(rev)):
        assert torch.allclose(a, b, atol=1e-6)
    with pytest.raises(ValueError, match="no worker messages"):
        weighted_reduce([])
    with pytest.raises(ValueError, match="zero samples"):
        weighted_reduce([({"w": torch.zeros(2)}, 0)])


@pytest.mark.parametrize("method,frac", [(None, 0.0), ("topk", 0.1),
                                         ("blocktopk", 1 / 16)])
def test_dense_reducer_ten_steps_against_jax(method, frac):
    """AdaGrad over three workers with sorted-order channels: params within
    1e-6, the per-worker and total wire bytes equal, the residuals equal,
    and the snapshot layout (``param_leaves``) the JAX package's."""
    rng = np.random.RandomState(9)
    p0 = _np_tree(rng)
    kw = {} if method is None else {"compressor": tc.GradientCompressor(
        method, frac=frac)}
    jkw = {} if method is None else {"compressor": jc.GradientCompressor(
        method, frac=frac)}
    tr = MasterReducer(_t(p0), get_optimizer("adagrad", lr=0.05),
                       fused=False, **kw)
    jr = JReducer(_j(p0), j_opt("adagrad", lr=0.05), fused=False, **jkw)
    assert not tr.fused and tr.flat_n == jr.flat_n
    assert tr.supports_defer == jr.supports_defer == (method is not None)
    for step in range(10):
        msgs = {f"w{i}": (_np_tree(rng), 2 + i) for i in (2, 0, 1)}
        tr.reduce_and_step({w: (_t(g), n) for w, (g, n) in msgs.items()})
        jr.reduce_and_step({w: (_j(g), n) for w, (g, n) in msgs.items()})
        assert tr.last_per_worker_bytes == jr.last_per_worker_bytes
        assert tr.last_wire_bytes == jr.last_wire_bytes
        for a, b in zip(tree_leaves(tr.params), jax.tree.leaves(jr.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    assert tr.step == jr.step == 10
    assert sorted(tr._residuals) == sorted(jr._residuals)
    np.testing.assert_allclose(tr.flat_params.numpy(),
                               np.asarray(jr.flat_params), rtol=0, atol=1e-6)
    st, jst = tr.state_dict(), jr.state_dict()
    assert sorted(st) == sorted(jst)
    assert len(st["param_leaves"]) == len(jst["param_leaves"])


def test_fused_matches_dense_uncompressed():
    """The JAX package's pin (tests/test_fused_reduce.py): the fused path
    equals the dense one within 1e-5 on the uncompressed channel."""
    rng = np.random.RandomState(10)
    p0 = _t(_np_tree(rng))
    dense = MasterReducer(p0, get_optimizer("adagrad", lr=0.02), fused=False)
    fused = MasterReducer(p0, get_optimizer("adagrad", lr=0.02), fused=True)
    for _ in range(3):
        msgs = {f"w{i}": (_t(_np_tree(rng)), 64) for i in range(4)}
        dense.reduce_and_step(msgs)
        fused.reduce_and_step(msgs)
    for a, b in zip(tree_leaves(dense.params), tree_leaves(fused.params)):
        assert torch.allclose(a, b, atol=1e-5)
    assert fused.step == dense.step == 3


def test_dense_path_errors_and_defer():
    red = MasterReducer({"w": torch.zeros(8)}, sgd(lr=0.1),
                        compressor=tc.GradientCompressor("topk", frac=0.5),
                        fused=False)
    msg = {"a": ({"w": torch.ones(8)}, 1)}
    with pytest.raises(ValueError, match="per-worker keep requires "
                                         "fused=True"):
        red.reduce_and_step(msg, keep={"a": 2})
    with pytest.raises(ValueError, match="defer requires fused=True"):
        red.reduce_and_step(msg, defer=["a"])
    with pytest.raises(ValueError, match="apply_outer_delta needs"):
        red.apply_outer_delta(torch.zeros(8))
    # a deferred gradient parks in the residual and ships next time
    red.defer_to_residual("a", {"w": torch.full((8,), 2.0)})
    red.defer_to_residual("a", {"w": torch.full((8,), 1.0)})
    assert torch.equal(red._residuals["a"]["w"], torch.full((8,), 3.0))
    red.reduce_and_step({"a": ({"w": torch.arange(8.0)}, 1)})
    sent = red._residuals["a"]["w"]
    assert float(sent.sum()) == float((torch.arange(8.0) + 3).sum()) - \
        float((torch.arange(8.0) + 3)[4:].sum())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dense_train_state_cross_loads(tmp_path, writer):
    """A dense reducer's snapshot (``param_leaves``, residual leaf lists)
    written by either package loads into the other; the next step
    agrees, and ``serving_params_from_train_state`` reads it."""
    rng = np.random.RandomState(11)
    p0 = _np_tree(rng)
    tr = MasterReducer(_t(p0), get_optimizer("adagrad", lr=0.05),
                       compressor=tc.GradientCompressor("topk", frac=0.2),
                       fused=False)
    jr = JReducer(_j(p0), j_opt("adagrad", lr=0.05),
                  compressor=jc.GradientCompressor("topk", frac=0.2),
                  fused=False)
    src, dst = (jr, tr) if writer == "jax" else (tr, jr)
    for _ in range(3):
        msgs = {f"w{i}": (_np_tree(rng), 4) for i in range(2)}
        cast = _j if writer == "jax" else _t
        src.reduce_and_step({w: (cast(g), n) for w, (g, n) in msgs.items()})
    io_w, io_r = (jio, tio) if writer == "jax" else (tio, jio)
    path = str(tmp_path / "dense.npz")
    io_w.save_train_state(path, io_w.TrainState(loop={
        "step": 3, "reducer": src.state_dict()}))
    st = io_r.load_train_state(path)
    dst.load_state_dict(st.loop["reducer"])
    assert dst.step == 3
    msgs = {f"w{i}": (_np_tree(rng), 4) for i in range(2)}
    tr.reduce_and_step({w: (_t(g), n) for w, (g, n) in msgs.items()})
    jr.reduce_and_step({w: (_j(g), n) for w, (g, n) in msgs.items()})
    for a, b in zip(tree_leaves(tr.params), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    params, step = tio.serving_params_from_train_state(
        tio.load_train_state(path), _t(p0))
    assert step == 3
    for a, b in zip(tree_leaves(params), st.loop["reducer"]["param_leaves"]):
        assert np.array_equal(a.numpy(), np.asarray(b))


# mirrors of tests/test_reducer.py
def test_master_reducer_steps_params_dense_and_fused():
    for fused in (False, True):
        red = MasterReducer({"w": torch.ones(4)}, sgd(lr=0.5), fused=fused)
        red.reduce_and_step({"w0": ({"w": torch.full((4,), 2.0)}, 2)})
        assert torch.allclose(red.params["w"], torch.full((4,), 0.5))
        assert red.step == 1


@pytest.mark.parametrize("method,fused", [("topk", False), ("randk", False),
                                          ("blocktopk", False),
                                          ("topk", True), ("randk", True)])
def test_compressed_channel_converges_quadratic(method, fused):
    """Error feedback drives a quadratic to its optimum through every
    channel (lr 0.1 within the EF-SGD delay bound for 10% kept)."""
    target = torch.tensor(np.random.RandomState(0).randn(64)
                          .astype(np.float32))
    red = MasterReducer({"w": torch.zeros(64)}, sgd(lr=0.1), fused=fused,
                        compressor=tc.GradientCompressor(method, frac=0.1))
    for _ in range(600):
        red.reduce_and_step({"w0": ({"w": red.params["w"] - target}, 1)})
    err = float((red.params["w"] - target).abs().max())
    assert err < 1e-2, err


def test_event_loop_runs_the_dense_reducer_like_jax():
    """``MasterEventLoop`` over a dense reducer with a compressor: late
    workers' mass parks in their residual trees (``defer_to_residual``)
    and the rest reduce leaf-wise; the iteration logs (events, wire
    bytes, vectors) equal the JAX package's, losses within 1e-6
    relative, params within 1e-6."""
    from repro.core import (DeadlineConfig as JDeadline, JoinEvent as JJoin,
                            MasterEventLoop as JLoop, TrainingConfig as JTC,
                            UploadDataEvent as JUpload)
    from repro.core import simulation as jsim
    from repro.core.scheduler import AdaptiveScheduler as JScheduler
    from repro_torch.core import (DeadlineConfig, JoinEvent, MasterEventLoop,
                                  TrainingConfig, UploadDataEvent)
    from repro_torch.core import simulation as tsim
    from repro_torch.core.scheduler import AdaptiveScheduler

    rng = np.random.RandomState(0)
    X = rng.randn(200, 16).astype(np.float32)
    y = (X @ rng.randn(16).astype(np.float32)).astype(np.float32)

    def np_grad(w, Xb, yb):
        r = (Xb @ w - yb).astype(np.float32)
        return (Xb.T @ r).astype(np.float32), float(np.float32(0.5) * (r @ r))

    def j_grad(p, Xb, yb):
        g, loss = np_grad(np.asarray(p["w"]), np.asarray(Xb), np.asarray(yb))
        return {"w": jnp.asarray(g)}, loss

    def t_grad(p, Xb, yb):
        g, loss = np_grad(p["w"].numpy(), Xb.numpy(), yb.numpy())
        return {"w": torch.from_numpy(g)}, loss

    logs = {}
    for side in ("jax", "torch"):
        j = side == "jax"
        mod = jsim if j else tsim
        red = (JReducer({"w": jnp.zeros(16)}, j_opt("sgd", lr=0.002),
                        compressor=jc.GradientCompressor("topk", frac=0.5),
                        fused=False) if j else
               MasterReducer({"w": torch.zeros(16)}, sgd(lr=0.002),
                             compressor=tc.GradientCompressor("topk",
                                                              frac=0.5),
                             fused=False))
        cluster = (mod.SimulatedCluster(grad_fn=j_grad, data=(X, y), seed=0)
                   if j else mod.SimulatedCluster(grad_fn=t_grad, data=(X, y),
                                                  seed=0, device="cpu"))
        loop = (JLoop if j else MasterEventLoop)(
            reducer=red, cluster=cluster,
            scheduler=(JScheduler if j else AdaptiveScheduler)(
                T=0.2, prior_power=300.0),
            training=(JTC if j else TrainingConfig)(T=0.2, deadline=(
                JDeadline if j else DeadlineConfig)(quantile=0.5, slack=1.0)))
        loop.submit((JUpload if j else UploadDataEvent)(range(200)))
        for i in range(3):
            cluster.add_worker(f"w{i}", mod.DeviceProfile(
                f"d{i}", 300.0, 0.01, 0.3, straggle_p=0.4))
            loop.submit((JJoin if j else JoinEvent)(f"w{i}", capacity=200))
        logs[side] = (loop.run(8), red)
    (jl, jr), (tl, tr) = logs["jax"], logs["torch"]
    assert any(e.startswith("late:") for lg in tl for e in lg.events)
    for a, b in zip(jl, tl):
        assert (a.events, a.vectors, a.wire_bytes, a.per_worker_wire_bytes) \
            == (b.events, b.vectors, b.wire_bytes, b.per_worker_wire_bytes)
        assert np.isfinite(a.loss) == np.isfinite(b.loss)
        if np.isfinite(a.loss):
            assert abs(a.loss - b.loss) <= 1e-6 * abs(a.loss)
    np.testing.assert_allclose(tr.params["w"].numpy(),
                               np.asarray(jr.params["w"]), rtol=0, atol=1e-6)
    assert sorted(tr._residuals) == sorted(jr._residuals)
