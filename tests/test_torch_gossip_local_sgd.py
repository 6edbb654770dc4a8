"""Port parity for gossip averaging, local SGD, power-aware minibursts and
tracking mode (``repro_torch.core.gossip`` / ``local_sgd`` / ``power`` /
``tracking``) against the JAX package, on the CPU. The cases mirror
``tests/test_tracking_power_gossip.py`` and ``tests/test_local_sgd.py``.

Tolerances: matchings, gossip averages, duty cycles, budgets and tracker
cadence bit-equal (a numpy RNG, the same float32 formula, pure Python);
local-SGD parameters within 1e-6 absolute of the JAX round and of the
synchronized weighted step (float32, sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jg  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core import tracking as jtracking  # noqa: E402
from repro.core.local_sgd import build_local_sgd_round as j_round  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.core import (JoinEvent, MasterEventLoop,  # noqa: E402
                              MasterReducer, UploadDataEvent,
                              weighted_reduce)
from repro_torch.core import gossip as tg  # noqa: E402
from repro_torch.core.local_sgd import (build_local_sgd_round,  # noqa: E402
                                        communication_ratio)
from repro_torch.core.power import (DeviceState, PowerAwareScheduler,  # noqa: E402
                                    PowerPolicy)
from repro_torch.core.scheduler import AdaptiveScheduler  # noqa: E402
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.core.tracking import (ExecutorTracker,  # noqa: E402
                                       StatTracker, attach_trackers)
from repro_torch.data.datasets import synthetic_mnist  # noqa: E402
from repro_torch.optim import adagrad, sgd  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 5, 8])
def test_matchings_and_rounds_bit_equal(n):
    """Twelve rounds over n replicas (dict trees and bare tensors), with
    sample-count weights: every matching and every average equals the
    JAX package's bit for bit."""
    rng = np.random.RandomState(n)
    reps = [rng.randn(16).astype(np.float32) for _ in range(n)]
    weights = [float(w) for w in rng.randint(0, 50, n)]
    assert tg.random_matching(n, np.random.RandomState(3)) \
        == jg.random_matching(n, np.random.RandomState(3))
    jr = [{"w": jnp.asarray(x)} for x in reps]
    tr = [{"w": torch.tensor(x)} for x in reps]
    flat = [torch.tensor(x) for x in reps]
    jrng, trng, frng = (np.random.RandomState(1) for _ in range(3))
    for _ in range(12):
        jr = jg.gossip_round(jr, jrng, weights)
        tr = tg.gossip_round(tr, trng, weights)
        flat = tg.gossip_round(flat, frng, weights)
        for a, b, c in zip(jr, tr, flat):
            assert _same(b["w"].numpy(), a["w"]) and _same(c.numpy(), a["w"])
    assert tg.replica_spread(tr) == jg.replica_spread(jr)
    assert tg.replica_spread(flat) == jg.replica_spread(jr)


def test_gossip_preserves_mean_and_contracts_spread():
    rng = np.random.RandomState(0)
    reps = [{"w": torch.tensor(rng.randn(16).astype(np.float32))}
            for _ in range(8)]
    mean0 = np.mean([r["w"].numpy() for r in reps], axis=0)
    spread0 = tg.replica_spread(reps)
    grng = np.random.RandomState(1)
    for _ in range(12):
        reps = tg.gossip_round(reps, grng)
    mean1 = np.mean([r["w"].numpy() for r in reps], axis=0)
    assert np.abs(mean0 - mean1).max() < 1e-5
    assert tg.replica_spread(reps) < 0.05 * spread0


def test_gossip_odd_count_and_zero_weights():
    rng = np.random.RandomState(4)
    reps = [{"w": torch.tensor(rng.randn(8).astype(np.float32))}
            for _ in range(5)]
    before = [r["w"].numpy().copy() for r in reps]
    out = tg.gossip_round(reps, np.random.RandomState(7))
    untouched = [i for i in range(5)
                 if np.array_equal(out[i]["w"].numpy(), before[i])]
    assert len(untouched) == 1, untouched
    a = {"w": torch.tensor([2.0, 4.0])}
    b = {"w": torch.tensor([4.0, 8.0])}
    out = tg.gossip_round([a, b], np.random.RandomState(0),
                          weights=[0.0, 0.0])
    for r in out:
        assert r["w"].tolist() == [3.0, 6.0]
    out = tg.gossip_round([a, b], np.random.RandomState(0),
                          weights=[1e-13, 3.0])
    jout = jg.gossip_round([{"w": jnp.asarray([2.0, 4.0])},
                            {"w": jnp.asarray([4.0, 8.0])}],
                           np.random.RandomState(0), weights=[1e-13, 3.0])
    for r, j in zip(out, jout):
        assert _same(r["w"].numpy(), j["w"])


def test_gossip_sgd_converges_decentralized_and_matches():
    target = np.random.RandomState(2).randn(8).astype(np.float32)
    noise = np.random.RandomState(3).randn(120, 8).astype(np.float32)

    def t_step(p, i, r):
        g = p["w"] - torch.tensor(target) + 0.05 * torch.tensor(noise[r])
        return {"w": p["w"] - 0.3 * g}

    def j_step(p, i, r):
        g = p["w"] - jnp.asarray(target) + 0.05 * jnp.asarray(noise[r])
        return {"w": p["w"] - 0.3 * g}

    reps = tg.gossip_sgd([{"w": torch.zeros(8)} for _ in range(6)], t_step,
                         n_rounds=60, gossip_every=2)
    jreps = jg.gossip_sgd([{"w": jnp.zeros(8)} for _ in range(6)], j_step,
                          n_rounds=60, gossip_every=2)
    err = max(float((r["w"] - torch.tensor(target)).abs().max())
              for r in reps)
    assert err < 0.15, err
    assert tg.replica_spread(reps) < 0.15
    for a, b in zip(reps, jreps):
        np.testing.assert_allclose(a["w"].numpy(), np.asarray(b["w"]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------
def _quadratic_grad(target, lib):
    def grad_fn(params, mb):
        n = mb["x"].shape[0]
        return ({"w": params["w"] - target + mb["x"].mean(0)},
                lib.asarray(n, dtype=lib.float32))
    return grad_fn


def test_h1_equals_synchronized_weighted_sgd():
    d, W, lr = 8, 4, 0.2
    target = np.random.RandomState(0).randn(d).astype(np.float32)
    xs = (np.random.RandomState(1).randn(W, 1, 3, d) * 0.1).astype(np.float32)
    round_fn = build_local_sgd_round(
        _quadratic_grad(torch.tensor(target), torch), sgd(lr=lr))
    new_params, info = round_fn({"w": torch.zeros(d)},
                                {"x": torch.tensor(xs)})
    msgs = [({"w": (torch.zeros(d) - torch.tensor(target)
                    + torch.tensor(xs[wk, 0]).mean(0)) * 3}, 3.0)
            for wk in range(W)]
    gbar = weighted_reduce(msgs)
    ref = -lr * gbar["w"]
    assert float((new_params["w"] - ref).abs().max()) < 1e-6
    assert int(info["comm_rounds"]) == 1 and info["workers"] == W
    assert float(info["samples"]) == 3.0 * W
    jnew, _ = j_round(_quadratic_grad(jnp.asarray(target), jnp),
                      j_sgd(lr=lr))({"w": jnp.zeros(d)},
                                    {"x": jnp.asarray(xs)})
    np.testing.assert_allclose(new_params["w"].numpy(),
                               np.asarray(jnew["w"]), rtol=0, atol=1e-6)


def test_h_steps_converge_cut_communication_and_match():
    d, W, H = 16, 4, 8
    target = np.random.RandomState(2).randn(d).astype(np.float32)
    round_fn = build_local_sgd_round(
        _quadratic_grad(torch.tensor(target), torch), sgd(lr=0.2))
    jround = jax.jit(j_round(_quadratic_grad(jnp.asarray(target), jnp),
                             j_sgd(lr=0.2)))
    rng = np.random.RandomState(3)
    params, jparams, comm = {"w": torch.zeros(d)}, {"w": jnp.zeros(d)}, 0
    for _ in range(10):
        xs = (rng.randn(W, H, 2, d) * 0.05).astype(np.float32)
        params, info = round_fn(params, {"x": torch.tensor(xs)})
        jparams, _ = jround(jparams, {"x": jnp.asarray(xs)})
        comm += int(info["comm_rounds"])
    err = float((params["w"] - torch.tensor(target)).abs().max())
    assert err < 0.05, err
    assert comm == 10 and communication_ratio(H) == 1.0 / H
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=0, atol=1e-6)


def test_local_sgd_on_real_lm():
    """The reduced LM: loss drops over local-SGD rounds (H 4, 4 workers)."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatbuf import build_tree, tree_paths
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import softmax_xent

    cfg = get_config("mlitb-lm-100m").reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")

    def grad_fn(p, mb):
        paths, leaves = zip(*[(k, x.detach().requires_grad_(True))
                              for k, x in tree_paths(p)])
        logits, _ = tf.forward(build_tree(paths, leaves), cfg, mb["tokens"],
                               remat=False)
        s, c = softmax_xent(logits, mb["labels"])
        grads = torch.autograd.grad(s / torch.clamp(c, min=1.0), leaves)
        return build_tree(paths, list(grads)), c

    round_fn = build_local_sgd_round(grad_fn, sgd(lr=0.3))
    W, H, B, S = 4, 4, 2, 16
    toks = torch.tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (W, H, B, S + 1)))
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def eval_loss(p):
        with torch.no_grad():
            logits, _ = tf.forward(p, cfg, toks[0, 0, :, :-1], remat=False)
            s, c = softmax_xent(logits, toks[0, 0, :, 1:])
        return float(s / c)

    l0 = eval_loss(params)
    for _ in range(3):
        params, _ = round_fn(params, batches)
    l1 = eval_loss(params)
    assert l1 < l0 and np.isfinite(l1), (l0, l1)


# ---------------------------------------------------------------------------
# power-aware minibursts
# ---------------------------------------------------------------------------
STATES = [dict(), dict(plugged=False, battery_frac=0.1),
          dict(temperature_c=70.0), dict(user_active=True),
          dict(plugged=False, battery_frac=0.6),
          dict(plugged=False, battery_frac=0.9, temperature_c=50.0),
          dict(temperature_c=47.5, user_active=True)]


def test_duty_cycle_policy_equals_reference():
    pol, jpol = PowerPolicy(), jpower.PowerPolicy()
    for st in STATES:
        assert pol.duty(DeviceState(**st)) == \
            jpol.duty(jpower.DeviceState(**st))
    assert pol.duty(DeviceState()) == 1.0
    assert pol.duty(DeviceState(user_active=True)) == pol.user_active_duty
    mid = pol.duty(DeviceState(plugged=False, battery_frac=0.6))
    assert pol.min_duty < mid < 1.0


def test_power_aware_budgets_are_minibursts():
    s = PowerAwareScheduler(T=4.0, min_budget=0.05)
    js = jpower.PowerAwareScheduler(T=4.0, min_budget=0.05)
    for i, st in enumerate(STATES):
        s.add_worker(f"d{i}")
        js.add_worker(f"d{i}")
        if i:                      # d0 reports nothing: the base budget
            s.report_state(f"d{i}", DeviceState(**st))
            js.report_state(f"d{i}", jpower.DeviceState(**st))
    for i in range(len(STATES)):
        assert s.budget(f"d{i}") == js.budget(f"d{i}")
        assert s.stats[f"d{i}"].last_budget == js.stats[f"d{i}"].last_budget
    assert s.budget("d0") > 3.0
    assert 0.05 <= s.budget("d3") < 1.1


# ---------------------------------------------------------------------------
# tracking mode
# ---------------------------------------------------------------------------
def test_stat_tracker_follows_training():
    init_p, grad_fn, eval_fn = tsim.make_cnn_problem(device="cpu")
    X, y = synthetic_mnist(600, seed=0)
    Xt, yt = synthetic_mnist(200, seed=9)
    red = MasterReducer(init_p(seed=0), adagrad(lr=0.02))
    cluster = tsim.SimulatedCluster(grad_fn=grad_fn, data=(X, y),
                                    mode="real", device="cpu")
    loop = MasterEventLoop(reducer=red, cluster=cluster,
                           scheduler=AdaptiveScheduler(T=1.0,
                                                       prior_power=113))
    loop.submit(UploadDataEvent(range(600)))
    for i in range(3):
        cluster.add_worker(f"w{i}", tsim.GRID_NODE)
        loop.submit(JoinEvent(f"w{i}", capacity=3000))
    tracker = StatTracker("test_error", lambda p: eval_fn(p, Xt, yt))
    execer = ExecutorTracker(lambda p, x: p)
    with pytest.raises(RuntimeError, match="no parameters"):
        execer(None)
    loop.run(6, callback=attach_trackers(loop, [tracker, execer]))
    assert len(tracker.history) == 6
    assert tracker.history[-1].value < tracker.history[0].value
    assert tracker.latest is tracker.history[-1]
    assert execer.params_step == 6 and execer(None) is red.params


def test_tracker_eval_cadence_equals_reference():
    t = StatTracker("x", lambda p: 0.0, eval_cost_s=10.0)
    jt = jtracking.StatTracker("x", lambda p: 0.0, eval_cost_s=10.0)
    for step, clock in [(1, 1.0), (2, 2.0), (3, 12.0), (4, 13.0),
                        (5, 22.5)]:
        t.observe({}, step, clock)
        jt.observe({}, step, clock)
    assert [(p.step, p.clock, p.value) for p in t.history] == \
        [(p.step, p.clock, p.value) for p in jt.history]
    assert [p.step for p in t.history] == [1, 3, 5]
