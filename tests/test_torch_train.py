"""Port parity for the training slice: ``repro_torch``'s flat buffer,
optimizers, conv net, reducer, simulator and master event loop against the
JAX package, on the CPU. Inputs come from numpy with a seed (or the JAX
side's own initialisation, carried across as numpy) and go through both
sides. Tolerances: bit-equal where the reference is driven by selection,
integers or a numpy RNG (flat layouts, block-top-k residuals and indices,
wire bytes, event logs, simulator draws); 1e-6 for optimizer arithmetic
(float32, the same formula in another framework); 1e-5 relative for the
conv net (convolution sums in another order); 1e-3 relative for the loss
of a whole training run and 0.01 for its test error.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import (GradientCompressor as JComp,  # noqa: E402
                        JoinEvent as JJoin, LeaveEvent as JLeave,
                        MasterEventLoop as JLoop, MasterReducer as JReducer,
                        UploadDataEvent as JUpload)
from repro.core.flatbuf import flat_spec as j_flat_spec  # noqa: E402
from repro.core.scheduler import AdaptiveScheduler as JScheduler  # noqa: E402
from repro.core import simulation as jsim  # noqa: E402
from repro.data.datasets import synthetic_lm as j_lm  # noqa: E402
from repro.data.datasets import synthetic_mnist as j_mnist  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro_torch.checkpoint.convert import (cnn_params_from_jax,  # noqa: E402
                                            cnn_params_to_numpy,
                                            params_from_jax)
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import GradientCompressor, MasterReducer  # noqa: E402
from repro_torch.core import TrainingConfig  # noqa: E402
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.core.flatbuf import flat_spec, tree_leaves  # noqa: E402
from repro_torch.data.datasets import synthetic_lm, synthetic_mnist  # noqa: E402
from repro_torch.launch.elastic_sgd import SCHEDULE, run_demo  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    return {k: _t_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_cnn_params(seed=0):
    return _np_tree(j_cnn.init_params(jax.random.PRNGKey(seed)))


def test_datasets_bit_equal():
    for n, seed in ((40, 0), (25, 123)):
        (a, b), (c, d) = j_mnist(n, seed=seed), synthetic_mnist(n, seed=seed)
        assert a.dtype == c.dtype and np.array_equal(a, c)
        assert b.dtype == d.dtype and np.array_equal(b, d)
    assert np.array_equal(j_lm(500, 64, seed=3), synthetic_lm(500, 64, seed=3))
    assert dataclasses.asdict(t_get_config("mlitb-cnn")) \
        == dataclasses.asdict(get_config("mlitb-cnn"))


# ---------------------------------------------------------------------------
# flat buffer and optimizers
# ---------------------------------------------------------------------------
def test_flatspec_cnn_and_lm_trees_bit_equal():
    jp = _jax_cnn_params()
    tp = cnn_params_from_jax(jp, device="cpu")
    js, ts = j_flat_spec(jp), flat_spec(tp)
    assert ts.n == js.n == 31786 and ts.offsets == js.offsets
    assert [p[-1] for p in ts.paths] == ["conv_b", "conv_w", "fc_b", "fc_w"]
    flat = ts.flatten(tp)
    assert np.array_equal(flat.numpy(), np.asarray(js.flatten(jp)))
    back = ts.unflatten(flat)
    for k in jp:
        assert np.array_equal(back[k].numpy(), jp[k])
    # the reduced LM tree: nested dicts, sorted at every level
    cfg = get_config("mlitb-lm-100m").reduced()
    jlm = _np_tree(j_tf.init_params(jax.random.PRNGKey(1), cfg))
    tlm = params_from_jax(jlm, t_get_config("mlitb-lm-100m").reduced(),
                          device="cpu")
    js, ts = j_flat_spec(jlm), flat_spec(tlm)
    flat = ts.flatten(tlm)
    assert np.array_equal(flat.numpy(), np.asarray(js.flatten(jlm)))
    back = ts.unflatten(flat)
    for path, leaf in zip(ts.paths, tree_leaves(back)):
        want = jlm
        for k in path:
            want = want[k]
        assert np.array_equal(leaf.numpy(), want)
    stacked = {"a": np.arange(12.0).reshape(3, 4), "b": np.ones((3, 2))}
    assert np.array_equal(
        flat_spec({"a": torch.zeros(4), "b": torch.zeros(2)})
        .flatten_stacked(_t_tree(stacked)).numpy(),
        np.asarray(j_flat_spec({"a": np.zeros(4), "b": np.zeros(2)})
                   .flatten_stacked(stacked)))


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05)), ("sgd", dict(lr=0.05, momentum=0.9)),
    ("adagrad", dict(lr=0.02)), ("adagrad", dict(lr=0.05, init_accum=0.1)),
    ("adam", dict(lr=1e-2, weight_decay=0.01))])
def test_optimizers_ten_steps(name, kw):
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(7, 5).astype(np.float32),
              "sub": {"b": rng.randn(5).astype(np.float32)}}
    jopt, topt = j_get_optimizer(name, **kw), get_optimizer(name, **kw)
    jp, tp = params, _t_tree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(10):
        g = {"w": rng.randn(7, 5).astype(np.float32),
             "sub": {"b": rng.randn(5).astype(np.float32)}}
        jp, js = jopt.update(jp, g, js)
        tp, ts = topt.update(tp, _t_tree(g), ts)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    ja, ta = jax.tree.leaves(js), tree_leaves(ts)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    # also on a flat buffer, as the reducer uses them
    flat = rng.randn(100).astype(np.float32)
    gflat = rng.randn(100).astype(np.float32)
    a, _ = jopt.update(jnp.asarray(flat), jnp.asarray(gflat),
                       jopt.init(jnp.asarray(flat)))
    b, _ = topt.update(torch.tensor(flat), torch.tensor(gflat),
                       topt.init(torch.tensor(flat)))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


# ---------------------------------------------------------------------------
# the conv net
# ---------------------------------------------------------------------------
def test_cnn_loss_and_grad_with_pool_ties():
    """Same params and batch on both sides; the batch includes blank and
    constant images, whose post-ReLU 2x2 windows are all-equal (ties in
    the max-pool gradient) or all-zero (ReLU's gradient at 0)."""
    jp = _jax_cnn_params(3)
    jp["conv_b"] = np.linspace(-0.5, 0.5, 16).astype(np.float32)
    X, y = synthetic_mnist(12, seed=4)
    X[0] = 0.0
    X[1] = 1.0
    X[2, :14] = 0.0
    jl, jg, jc = j_cnn.loss_and_grad(jp, jnp.asarray(X), jnp.asarray(y))
    tl, tg, tc = cnn.loss_and_grad(cnn_params_from_jax(jp, device="cpu"),
                                   torch.tensor(X), torch.tensor(y))
    assert _rel(tl.numpy(), jl) <= 1e-5
    for k in jp:
        assert _rel(tg[k].numpy(), jg[k]) <= 1e-5, k
    assert int(tc) == int(jc)
    logits = cnn.forward(cnn_params_from_jax(jp, device="cpu"),
                         torch.tensor(X))
    assert _rel(logits.numpy(), j_cnn.forward(jp, jnp.asarray(X))) <= 1e-5
    back = cnn_params_to_numpy(cnn_params_from_jax(jp, device="cpu"))
    assert all(np.array_equal(back[k], jp[k]) for k in jp)
    with pytest.raises(ValueError, match="fc_w has shape"):
        cnn_params_from_jax({**jp, "fc_w": jp["fc_w"].T}, device="cpu")


# ---------------------------------------------------------------------------
# the reducer
# ---------------------------------------------------------------------------
_SHAPES = {"a": (37, 5), "b": (100,), "c": {"d": (3, 7, 11)}}


def _grad(rng, scale=1.0):
    return {"a": (rng.randn(37, 5) * scale).astype(np.float32),
            "b": (rng.randn(100) * scale).astype(np.float32),
            "c": {"d": (rng.randn(3, 7, 11) * scale).astype(np.float32)}}


def _reducer_schedule():
    """20 steps: the fleet grows 1 -> 2 -> 3 -> 5 (W_cap 1, 2, 4, 8),
    then shrinks to 2; a deferred set and per-worker keeps in between."""
    fleets = ([["w0"]] * 3 + [["w0", "w1"]] * 3
              + [["w0", "w1", "w2"]] * 4
              + [["w0", "w1", "w2", "w3", "w4"]] * 5 + [["w1", "w3"]] * 5)
    defer = {7: ["w1"], 12: ["w0", "w4"], 17: ["w3"]}
    keep = {8: {"w0": 34}, 11: {"w2": 68, "w3": 17}, 13: {"w4": 1000}}
    return fleets, defer, keep


def test_reducer_blocktopk_twenty_steps_bit_equal():
    rng = np.random.RandomState(0)
    params = _grad(rng)
    comp = dict(method="blocktopk", frac=1 / 32, block_w=32)
    jr = JReducer(params, j_get_optimizer("adagrad", lr=0.02),
                  compressor=JComp(**comp))
    tr = MasterReducer(_t_tree(params), get_optimizer("adagrad", lr=0.02),
                       compressor=GradientCompressor(**comp))
    assert tr.flat_n == jr.flat_n == 516          # 516 % 32 != 0: a tail
    fleets, defer, keep = _reducer_schedule()
    prev = set()
    for s, fleet in enumerate(fleets):
        for w in sorted(prev - set(fleet)):
            jr.drop_worker(w)
            tr.drop_worker(w)
        prev = set(fleet)
        msgs = {w: (_grad(rng), int(rng.randint(1, 50))) for w in fleet}
        if s == 5:                                # the aliasing check
            held = tr.params
            copy = [v.clone() for v in tree_leaves(held)]
        jr.reduce_and_step(msgs, keep=keep.get(s), defer=defer.get(s))
        tr.reduce_and_step({w: (_t_tree(g), n) for w, (g, n) in msgs.items()},
                           keep=keep.get(s), defer=defer.get(s))
        if s == 5:
            assert all(torch.equal(v, c)
                       for v, c in zip(tree_leaves(held), copy))
        assert tr.last_wire_bytes == jr.last_wire_bytes
        assert tr.last_per_worker_bytes == jr.last_per_worker_bytes
        np.testing.assert_allclose(tr.flat_params.numpy(),
                                   np.asarray(jr.flat_params), atol=1e-6)
        assert sorted(tr._residuals) == sorted(jr._residuals)
        for w in jr._residuals:
            # residual = c with the picks zeroed: equal picks <=> equal
            assert np.array_equal(tr._residuals[w].numpy(),
                                  np.asarray(jr._residuals[w]))
    assert tr.trace_count == jr.trace_count
    assert tr._w_cap == jr._w_cap == 8
    st_t, st_j = tr.state_dict(), jr.state_dict()
    assert {k: st_t[k] for k in ("step", "w_cap", "last_wire_bytes")} \
        == {k: st_j[k] for k in ("step", "w_cap", "last_wire_bytes")}
    for a, b in zip(st_t["opt_leaves"], st_j["opt_leaves"]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6)
    # resume: a fresh reducer loaded from the snapshot steps bit-equal
    tr2 = MasterReducer(_t_tree(params), get_optimizer("adagrad", lr=0.02),
                        compressor=GradientCompressor(**comp))
    tr2.load_state_dict(st_t)
    msgs = {w: (_t_tree(_grad(rng)), 3) for w in ("w1", "w3")}
    tr.reduce_and_step(msgs)
    tr2.reduce_and_step(msgs)
    assert torch.equal(tr.flat_params, tr2.flat_params)
    assert tr2.trace_count == 1


@pytest.mark.parametrize("comp", [None, dict(method="topk", frac=0.05)],
                         ids=["uncompressed", "topk"])
def test_reducer_other_channels_match(comp):
    """The uncompressed channel (plain and, with a deferred worker, the
    live-masked variant) and the global top-k channel."""
    rng = np.random.RandomState(1)
    params = _grad(rng)
    jr = JReducer(params, j_get_optimizer("sgd", lr=0.1),
                  compressor=JComp(**comp) if comp else None)
    tr = MasterReducer(_t_tree(params), get_optimizer("sgd", lr=0.1),
                       compressor=GradientCompressor(**comp) if comp
                       else None)
    for s in range(6):
        fleet = ["w0", "w1", "w2"][:1 + s % 3]
        msgs = {w: (_grad(rng), 1 + s) for w in fleet}
        d = ["w1"] if s == 4 else None
        jr.reduce_and_step(msgs, defer=d)
        tr.reduce_and_step({w: (_t_tree(g), n) for w, (g, n) in msgs.items()},
                           defer=d)
        np.testing.assert_allclose(tr.flat_params.numpy(),
                                   np.asarray(jr.flat_params), atol=1e-6)
        assert tr.last_wire_bytes == jr.last_wire_bytes
        assert sorted(tr._residuals) == sorted(jr._residuals)
        for w in jr._residuals:
            np.testing.assert_allclose(tr._residuals[w].numpy(),
                                       np.asarray(jr._residuals[w]),
                                       atol=1e-6)
    assert tr.trace_count == jr.trace_count
    delta = rng.randn(tr.flat_n).astype(np.float32)
    jr.apply_outer_delta(delta)
    tr.apply_outer_delta(delta)
    np.testing.assert_allclose(tr.flat_params.numpy(),
                               np.asarray(jr.flat_params), atol=1e-6)
    for path, leaf in zip(flat_spec(tr.params).paths,
                          tree_leaves(tr.params)):
        want = jr.params
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want), atol=1e-6)


def test_unported_training_options_raise():
    p = {"w": torch.zeros(4)}
    # the dense reducer (A4) and the two-tier hierarchy (A5) are ported
    dense = MasterReducer(p, get_optimizer("sgd"), fused=False)
    assert not dense.fused and dense.params is p
    from repro_torch.core import HierarchyConfig
    hier = HierarchyConfig(n_regions=2)
    assert TrainingConfig(hierarchy=hier).hierarchy is hier
    with pytest.raises(ValueError, match="n_regions=1 with gossip enabled"):
        HierarchyConfig(n_regions=1)
    from repro_torch.launch import train, train_serve
    # the train->serve loop (A7) and its speculative decoding (C4) are
    # ported: a bad speculative setting meets the reference's validation
    from repro_torch.serving import SpeculativeConfig
    with pytest.raises(ValueError, match="window=2 must exceed k=2"):
        SpeculativeConfig(draft_params={}, draft_cfg=None, k=2, window=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        train.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="deadline_quantile=1.5"):
        TrainingConfig.from_flat(deadline_quantile=1.5)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------
def _drive_cluster(sim, make_grad, n_calls=30):
    """Seeded churn: profiles with stalls and deaths, a fault profile,
    scripted kill/straggle/poison, real-mode gradients on recorded
    subsets. Returns every observable of every call."""
    seen = []

    def grad_fn(params, X, y):
        seen.append(np.asarray(X).reshape(-1).astype(np.int64).tolist())
        return make_grad(), float(np.asarray(y).sum())

    X = np.arange(400, dtype=np.float32)[:, None]
    y = np.arange(400, dtype=np.int32)
    kw = dict(grad_fn=grad_fn, data=(X, y), mode="real", seed=5)
    c = sim.SimulatedCluster(**kw) if sim is jsim \
        else sim.SimulatedCluster(**kw, device="cpu")
    flaky = sim.DeviceProfile("flaky", 60.0, 0.05, 0.5, reliability=0.9,
                              straggle_p=0.3)
    for i, prof in enumerate([sim.WORKSTATION, sim.LAPTOP, sim.PHONE,
                              flaky, sim.GRID_NODE]):
        c.add_worker(f"w{i}", prof)
    c.set_faults("w1", sim.FaultProfile(nan_p=0.2, garbage_p=0.2,
                                        stale_p=0.2, drop_p=0.3))
    out = []
    for t in range(n_calls):
        if t == 4:
            c.kill("w2")
        if t == 6:
            c.straggle("w0", 5.0, iters=3)
        if t == 9:
            c.poison("w4", "nan", iters=2)
        if t == 15:
            c.add_worker("w2", sim.PHONE)
        w = f"w{t % 5}"
        if w not in c.workers:
            continue
        idx = list(range((t * 37) % 300, 400))
        r = c.compute(w, None, 0.05 + 0.1 * (t % 4), idx)
        if r is None:
            out.append((t, None))
            continue
        leaves = [np.asarray(x) for x in (jax.tree.leaves(r.grad_sum)
                                          if sim is jsim
                                          else tree_leaves(r.grad_sum))]
        out.append((t, r.n_vectors, r.compute_time, r.latency, r.loss_sum,
                    [x.tolist() for x in leaves]))
    st = c.state_dict()
    return out, seen, st


def test_simulated_cluster_draws_bit_equal():
    j_out, j_seen, j_st = _drive_cluster(
        jsim, lambda: {"g": np.ones(3, np.float32)})
    t_out, t_seen, t_st = _drive_cluster(
        tsim, lambda: {"g": torch.ones(3)})
    assert len(j_out) == len(t_out) and any(o[1] is None for o in j_out)
    assert str(j_out) == str(t_out)       # NaN-aware, float-repr exact
    assert j_seen == t_seen
    for w in j_st["workers"]:
        a, b = j_st["workers"][w], t_st["workers"][w]
        assert a["profile"] == b["profile"]
        assert np.array_equal(a["rng"][1], b["rng"][1]) \
            and a["rng"][2:] == b["rng"][2:]
    assert j_st["straggle"] == t_st["straggle"] \
        and j_st["poison"] == t_st["poison"]
    assert tsim.DeviceProfile is __import__(
        "repro_torch.serving.requests", fromlist=["x"]).DeviceProfile


def test_simulated_cluster_state_round_trip():
    """A cluster loaded from another's snapshot draws exactly what the
    original goes on to draw; a snapshot missing a key is refused."""
    def fleet():
        c = tsim.SimulatedCluster(mode="synthetic", seed=3, device="cpu")
        for i, prof in enumerate([tsim.WORKSTATION, tsim.PHONE,
                                  tsim.LAPTOP]):
            c.add_worker(f"w{i}", prof)
        return c

    a = fleet()
    a.set_faults("w1", tsim.FaultProfile(stale_p=0.3, drop_p=0.4))
    a.straggle("w0", 4.0, iters=5)
    a.poison("w2", "drop", iters=3)
    a.kill("w3")
    for t in range(7):
        a.compute(f"w{t % 3}", None, 0.2, list(range(100)))
    st = a.state_dict()
    b = tsim.SimulatedCluster(mode="synthetic", seed=99, device="cpu")
    b.load_state_dict(st)
    assert str(b.state_dict()) == str(st)
    for t in range(12):
        w = f"w{t % 3}"
        ra, rb = (c.compute(w, None, 0.1 + 0.05 * t, list(range(100)))
                  for c in (a, b))
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert (ra.n_vectors, ra.compute_time, ra.latency) \
                == (rb.n_vectors, rb.compute_time, rb.latency)
    del st["poison"]
    with pytest.raises(KeyError):
        fleet().load_state_dict(st)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------
def _jax_demo(iterations, n_data, params):
    """examples/elastic_sgd_demo.py's scenario in JAX, at ``n_data``."""
    init_p, grad_fn, eval_fn = jsim.make_cnn_problem()
    X, y = j_mnist(n_data, seed=0)
    Xt, yt = j_mnist(500, seed=123)
    red = JReducer(jax.tree.map(jnp.asarray, params),
                   j_get_optimizer("adagrad", lr=0.02),
                   compressor=JComp("blocktopk", frac=1 / 32, block_w=32))
    cluster = jsim.SimulatedCluster(grad_fn=grad_fn, data=(X, y),
                                    mode="real")
    loop = JLoop(reducer=red, cluster=cluster,
                 scheduler=JScheduler(T=1.0))
    loop.submit(JUpload(range(n_data)))
    cluster.add_worker("desk0", jsim.WORKSTATION)
    loop.submit(JJoin("desk0", capacity=3000))
    logs, errs = [], []
    for it in range(iterations):
        for kind, w, prof in SCHEDULE.get(it, []):
            if kind == "join":
                cluster.add_worker(w, getattr(jsim, prof.name.upper()))
                loop.submit(JJoin(w, capacity=3000))
            else:
                loop.submit(JLeave(w))
        logs.append(loop.iteration())
        errs.append(eval_fn(red.params, Xt, yt))
    return logs, errs


def test_event_loop_matches_jax_demo():
    """The port's elastic-SGD scenario (CPU, the plain kernel) against the
    JAX example's at 1000 samples and 6 iterations; the conv net stays at
    full width and both start from the same weights."""
    params = _jax_cnn_params(0)
    j_logs, j_errs = _jax_demo(6, 1000, params)
    run = run_demo(iterations=6, n_data=1000, device="cpu",
                   init_params=cnn_params_from_jax(params, device="cpu"))
    assert run.launches == 0                     # CPU: the plain version
    for a, b in zip(j_logs, run.logs):
        assert (a.step, a.events, a.n_workers, a.vectors, a.wire_bytes,
                a.per_worker_wire_bytes, a.n_late) \
            == (b.step, b.events, b.n_workers, b.vectors, b.wire_bytes,
                b.per_worker_wire_bytes, b.n_late)
        assert a.wall_time == b.wall_time and a.power == b.power
        assert abs(a.loss - b.loss) <= 1e-3 * abs(a.loss)
    assert max(abs(a - b) for a, b in zip(j_errs, run.test_err)) <= 0.01
    assert [lg.n_workers for lg in run.logs] == [1, 1, 3, 3, 5, 5]
    assert run.loop.reducer.trace_count == 3     # W_cap 1, 4, 8


def test_launcher_prints_iterations_and_trace_on_cpu(capsys):
    from repro_torch.launch import elastic_sgd
    assert elastic_sgd.main(["--device", "cpu", "--iterations", "3",
                             "--n-data", "300", "--trace"]) == 0
    out = capsys.readouterr().out
    assert out.count("test-err") == 3 and "iter  3 workers 3" in out
    assert "fused_compress kernel launches 0" in out
    assert "trace: wall" in out and "host ms per iteration" in out
