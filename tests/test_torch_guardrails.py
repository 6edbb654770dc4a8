"""Port parity for the training guardrails and the adaptive per-worker
keep: ``repro_torch.core.guardrails`` (screen, strikes, divergence
rollback, ``CanaryGate``, ``make_lm_probe``), ``core.adaptive_frac`` and
the event loop's hooks for both, against the JAX package on the CPU.

Every decision is held bit-equal: quarantines, evictions, rollbacks,
canary refusals, keep buckets and the wire bytes they give. Losses match
within 1e-3 relative (a whole run), probe losses within 1e-6. Weights
are the JAX side's ``jax.random`` draw carried across with
``params_from_jax``; the fleets draw from the same seeded numpy streams.
Every worker owns more vectors than its budget would compute, so both
sides see a few batch shapes only (the JAX side compiles one program per
shape).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import AdaptiveFracController as JCtl  # noqa: E402
from repro.core import GradientCompressor as JComp  # noqa: E402
from repro.core import (JoinEvent as JJoin,  # noqa: E402
                        MasterEventLoop as JLoop, MasterReducer as JReducer,
                        TrainingConfig as JTC, UploadDataEvent as JUpload)
from repro.core import simulation as jsim  # noqa: E402
from repro.core.guardrails import (CanaryGate as JCanary,  # noqa: E402
                                   GuardrailConfig as JGC,
                                   TrainingGuardrails as JGuard,
                                   make_lm_probe as j_probe,
                                   tree_finite as j_finite)
from repro.core.scheduler import AdaptiveScheduler as JSched  # noqa: E402
from repro.core.scheduler import WorkerStats as JStats  # noqa: E402
from repro.launch.train_serve import build_training as j_build  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import adagrad as j_adagrad  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.core import (AdaptiveFracController,  # noqa: E402
                              AdaptiveScheduler, CanaryGate,
                              GradientCompressor, GuardrailConfig,
                              JoinEvent, MasterEventLoop, MasterReducer,
                              TrainingConfig, TrainingGuardrails,
                              UploadDataEvent)
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.core.flatbuf import tree_map  # noqa: E402
from repro_torch.core.guardrails import make_lm_probe, tree_finite  # noqa: E402
from repro_torch.core.scheduler import WorkerStats  # noqa: E402
from repro_torch.launch.train_serve import build_training  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402
from repro_torch.optim import adagrad, sgd  # noqa: E402

T = 1.5          # every worker's budget covers all its allocated vectors



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: torch's intra-op thread pool
    costs more than it saves, and beside other test workers it
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray,
                        j_tf.init_params(jax.random.PRNGKey(0), j_tiny()))


def _tparams(jparams):
    return params_from_jax(jparams, tiny_cfg(), device="cpu")


def _same_logs(jl, tl, loss_rtol=1e-3):
    for a, b in zip(jl, tl, strict=True):
        assert (a.step, a.events, a.n_workers, a.vectors, a.n_quarantined,
                a.rolled_back, a.wire_bytes, a.per_worker_wire_bytes) \
            == (b.step, b.events, b.n_workers, b.vectors, b.n_quarantined,
                b.rolled_back, b.wire_bytes, b.per_worker_wire_bytes)
        assert a.wall_time == b.wall_time and a.max_upload == b.max_upload
        assert math.isfinite(a.loss) == math.isfinite(b.loss)
        if math.isfinite(a.loss):
            assert abs(a.loss - b.loss) <= loss_rtol * abs(a.loss)


# ---------------------------------------------------------------------------
# layer 1 and 2 units
# ---------------------------------------------------------------------------
def test_screen_strikes_and_divergence_decisions():
    """The same message / loss sequence through both watchdogs."""
    cfg = dict(max_loss_ratio=3.0, loss_window=4, min_history=2,
               strikes_to_evict=2)
    jg, tg = JGuard(JGC(**cfg)), TrainingGuardrails(GuardrailConfig(**cfg))
    rng = np.random.RandomState(0)
    for step in range(12):
        msgs = {}
        for w in ("a", "b", "c"):
            x = rng.randn(5).astype(np.float32)
            if rng.rand() < 0.3:
                x[rng.randint(5)] = [np.nan, np.inf, -np.inf][step % 3]
            msgs[w] = ({"x": x, "y": {"z": np.ones(2, np.float32)}}, 3)
        jc, joff = jg.screen(msgs)
        tc, toff = tg.screen({w: (tree_map(torch.tensor, g), n)
                              for w, (g, n) in msgs.items()})
        assert joff == toff and sorted(jc) == sorted(tc)
        assert [jg.record_offense(w) for w in joff] \
            == [tg.record_offense(w) for w in toff]
        loss = float([5.0, 4.0, 3.9, 13.0, 11.0, np.nan, 2.0, 7.0, 6.5,
                      np.inf, 3.0, 8.9][step])
        div = jg.check_divergence(loss)
        assert div == tg.check_divergence(loss)
        if not div:
            jg.observe_healthy(loss)
            tg.observe_healthy(loss)
    assert j_finite({"x": np.ones(2)}) == tree_finite({"x": torch.ones(2)})
    assert tree_finite({}) and not tree_finite(
        {"a": torch.ones(2), "b": {"c": torch.tensor([1.0, np.nan])}})
    js, ts = jg.state_dict(), tg.state_dict()
    assert js == ts and ts["evicted"] and ts["n_quarantined"] > 2
    assert not tg.can_rollback and tg.rollback(reducer=None) is False


# ---------------------------------------------------------------------------
# the chaos fleet: screen, eviction, rollback inside the event loop
# ---------------------------------------------------------------------------
def _chaos(side, jparams, iterations=8):
    kw = dict(seed=0, churny=False)
    if side == "jax":
        loop, cluster, _ = j_build(
            j_tiny(), training=JTC(T=T, guardrails=JGC(strikes_to_evict=2)),
            optimizer=j_sgd(lr=0.05),
            fault_profiles={"w1": jsim.FaultProfile(nan_p=0.3)}, **kw)
    else:
        loop, cluster, _ = build_training(
            tiny_cfg(), training=TrainingConfig(
                T=T, guardrails=GuardrailConfig(strikes_to_evict=2)),
            optimizer=sgd(lr=0.05),
            fault_profiles={"w1": tsim.FaultProfile(nan_p=0.3)},
            device="cpu", init_params=_tparams(jparams), **kw)
    logs = []
    for it in range(iterations):
        if it == 2:
            cluster.poison("w2", "garbage", iters=1)
        logs.append(loop.iteration())
    return logs, loop


def test_chaos_fleet_decisions_bit_equal(jparams):
    jl, jloop = _chaos("jax", jparams)
    tl, tloop = _chaos("torch", jparams)
    _same_logs(jl, tl)
    assert sum(lg.n_quarantined for lg in tl) >= 2
    assert sum(lg.rolled_back for lg in tl) == 1
    assert any("evict:w1" in lg.events for lg in tl)
    js, ts = jloop.guardrails.state_dict(), tloop.guardrails.state_dict()
    for k in ("strikes", "evicted", "n_quarantined", "n_rollbacks",
              "last_good_step", "healthy_since_snapshot"):
        assert js[k] == ts[k], k
    np.testing.assert_allclose(ts["losses"], js["losses"], rtol=1e-3)
    assert tree_finite(tloop.reducer.params)


# ---------------------------------------------------------------------------
# layer 3: the canary
# ---------------------------------------------------------------------------
def test_canary_gate_decisions(jparams):
    rng = np.random.RandomState(9)
    X = rng.randint(0, 128, (4, 16)).astype(np.int32)
    y = rng.randint(0, 128, (4, 16)).astype(np.int32)
    jgate = JCanary(j_probe(j_tiny(), X, y))
    tgate = CanaryGate(make_lm_probe(tiny_cfg(), X, y, device="cpu"))

    def scaled(s, leaf="embed"):
        return {**jparams, leaf: jparams[leaf] * np.float32(s)}

    nan = jax.tree.map(lambda a: np.full_like(a, np.nan), jparams)
    def final_norm(v):
        return {**jparams, "final_norm": {"scale": np.full_like(
            jparams["final_norm"]["scale"], v)}}

    # finite weights whose activations overflow: a finite params tree
    # with a non-finite probe loss
    cands = [jparams, scaled(1.01), nan, scaled(60.0), final_norm(3e38),
             scaled(0.99), final_norm(np.inf)]
    for v, c in enumerate(cands):
        tc = params_from_jax(c, tiny_cfg(), device="cpu")
        assert jgate.check(c, version=v) == tgate.check(tc, version=v)
        jbest, tbest = jgate.best, tgate.best
        assert abs(tbest - jbest) <= 1e-6 * abs(jbest)
    assert jgate.refusals == tgate.refusals
    assert {r for _, r in tgate.refusals} == {
        "non-finite params", "non-finite probe loss", "diverged probe loss"}
    assert (jgate.n_passed, jgate.n_refused) \
        == (tgate.n_passed, tgate.n_refused) == (3, 4)
    jl = j_probe(j_tiny(), X, y)(jparams)
    tl = make_lm_probe(tiny_cfg(), X, y, device="cpu")(_tparams(jparams))
    assert abs(tl - jl) <= 1e-6 * jl


# ---------------------------------------------------------------------------
# the adaptive per-worker keep controller
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,n", [("topk", 22688), ("topk", 1000),
                                      ("blocktopk", 344704)])
def test_controller_keeps_bit_equal_on_seeded_sweeps(method, n):
    """Random walks of (bandwidth, latency) per worker, plus points just
    inside and just outside each hysteresis edge of the worker's held
    bucket: every assignment, target and the final memory equal."""
    kw = dict(T=0.5, comm_frac=0.5, frac_min=1 / 2048, frac_max=0.2)
    comp = dict(method=method, frac=0.1, block_w=128)
    jc, tc = JCtl(**kw), AdaptiveFracController(**kw)
    jcomp, tcomp = JComp(**comp), GradientCompressor(**comp)
    assert jcomp.k_lattice(n) == tcomp.k_lattice(n)
    rng = np.random.RandomState(n % 97)
    bw = {w: 10 ** rng.uniform(3.5, 6.5) for w in "abcd"}
    lat = {w: rng.uniform(0.0, 0.3) for w in "abcd"}
    held, n_edge = {}, 0
    for step in range(60):
        stats = {}
        for w in "abcd":
            bw[w] *= math.exp(rng.randn() * 0.3)
            lat[w] = min(0.6, max(0.0, lat[w] + rng.randn() * 0.02))
            b = bw[w]
            if w in held and step % 3 == 0:
                # raw target on an edge of the held bucket's dead band
                budget = kw["comm_frac"] * max(kw["T"] - lat[w],
                                               tc.min_comm)
                edge = [held[w] * (1 - tc.hysteresis_down),
                        2 * held[w] * (1 + tc.hysteresis_up)][step % 2]
                b = edge * (1 + [-1e-9, 1e-9][(step // 3) % 2]) * 8 / budget
                n_edge += 1
            stats[w] = (b, lat[w])
            assert jc.frac_for(n, b, lat[w]) == tc.frac_for(n, b, lat[w])
        ja = jc.assign(jcomp, n, {w: JStats(bandwidth=b, latency=lt)
                                  for w, (b, lt) in stats.items()})
        ta = tc.assign(tcomp, n, {w: WorkerStats(bandwidth=b, latency=lt)
                                  for w, (b, lt) in stats.items()})
        assert ja == ta and all(k in tcomp.k_lattice(n) for k in ta.values())
        held = dict(ta)
        if step == 30:
            jc.drop_worker("c")
            tc.drop_worker("c")
    assert n_edge >= 40 and jc.state_dict() == tc.state_dict()
    with pytest.raises(ValueError, match="frac_min"):
        AdaptiveFracController(frac_min=0.5, frac_max=0.1)


def _keep_loop(side, jparams, comp, iterations=6):
    """build_training's LM problem on a fleet of three uplinks, with the
    controller sizing each worker's message."""
    ctl = dict(T=0.5, comm_frac=0.5, frac_min=1 / 2048, frac_max=0.12)
    sim, bws = (jsim if side == "jax" else tsim), (6e4, 2e4, 6e3)
    if side == "jax":
        (X, y), grad_fn = jsim.make_lm_problem(j_tiny(), seed=0)
        red = JReducer(jax.tree.map(jax.numpy.asarray, jparams),
                       j_adagrad(lr=0.1), compressor=JComp(**comp))
        cluster = jsim.SimulatedCluster(grad_fn=grad_fn, data=(X, y),
                                        mode="real", seed=0)
        loop = JLoop(reducer=red, cluster=cluster, frac_controller=JCtl(**ctl),
                     scheduler=JSched(T=0.5, prior_power=1000.0,
                                      prior_bandwidth=6e3),
                     training=JTC(T=0.5))
        join, upload = JJoin, JUpload
    else:
        (X, y), grad_fn = tsim.make_lm_problem(tiny_cfg(), seed=0,
                                               device="cpu")
        red = MasterReducer(_tparams(jparams), adagrad(lr=0.1),
                            compressor=GradientCompressor(**comp))
        cluster = tsim.SimulatedCluster(grad_fn=grad_fn, data=(X, y),
                                        mode="real", seed=0, device="cpu")
        loop = MasterEventLoop(
            reducer=red, cluster=cluster,
            frac_controller=AdaptiveFracController(**ctl),
            scheduler=AdaptiveScheduler(T=0.5, prior_power=1000.0,
                                        prior_bandwidth=6e3),
            training=TrainingConfig(T=0.5))
        join, upload = JoinEvent, UploadDataEvent
    loop.submit(upload(range(len(X))))
    for i, bw in enumerate(bws):
        cluster.add_worker(f"w{i}", sim.DeviceProfile(
            f"d{i}", 1000.0, 0.005, 0.05, uplink_bps=bw))
        loop.submit(join(f"w{i}", capacity=len(X)))
    return loop.run(iterations), loop


@pytest.mark.parametrize("comp", [
    dict(method="topk", frac=0.05),
    dict(method="blocktopk", frac=1 / 8, block_w=32)],
    ids=["topk", "blocktopk"])
def test_event_loop_with_controller_matches_jax(jparams, comp):
    jl, jloop = _keep_loop("jax", jparams, comp)
    tl, tloop = _keep_loop("torch", jparams, comp)
    _same_logs(jl, tl)
    last = tl[-1].per_worker_wire_bytes
    sizes = [last[f"w{i}"] for i in range(3)]
    assert sizes == sorted(sizes, reverse=True) and len(set(sizes)) >= 2
    assert jloop.frac_controller.state_dict() \
        == tloop.frac_controller.state_dict()
    assert tloop.frac_controller.T == 0.5


def test_controller_needs_a_fused_compressed_reducer():
    red = MasterReducer({"w": torch.zeros(4)}, sgd(lr=0.1))
    with pytest.raises(ValueError, match="fused compressed"):
        MasterEventLoop(reducer=red, cluster=None,
                        frac_controller=AdaptiveFracController())
    red = MasterReducer({"w": torch.zeros(4)}, sgd(lr=0.1),
                        compressor=GradientCompressor("topk", frac=0.5))
    ctl = AdaptiveFracController()
    MasterEventLoop(reducer=red, cluster=None, frac_controller=ctl,
                    scheduler=AdaptiveScheduler(T=0.25))
    assert ctl.T == 0.25


# ---------------------------------------------------------------------------
# snapshot and resume with the controller and the guardrails
# ---------------------------------------------------------------------------
def _resumable(jparams):
    loop, cluster, _ = build_training(
        tiny_cfg(), training=TrainingConfig(
            T=T, guardrails=GuardrailConfig(strikes_to_evict=5)),
        seed=1, device="cpu", init_params=_tparams(jparams),
        fault_profiles={"w0": tsim.FaultProfile(nan_p=0.3)})
    red = MasterReducer(_tparams(jparams), adagrad(lr=0.1),
                        compressor=GradientCompressor("blocktopk",
                                                      frac=1 / 8,
                                                      block_w=32))
    loop = MasterEventLoop(reducer=red, cluster=cluster,
                           scheduler=loop.scheduler,
                           frac_controller=AdaptiveFracController(T=T),
                           training=loop.training)
    loop.submit(UploadDataEvent(range(512)))
    for w in sorted(cluster.workers):
        loop.submit(JoinEvent(w, capacity=512))
    return loop, cluster


def test_snapshot_resume_with_controller_and_guardrails(jparams):
    a, ca = _resumable(jparams)
    a.run(3)
    st, cst = a.state_dict(), ca.state_dict()
    assert set(st) >= {"frac_controller", "guardrails"}
    b, cb = _resumable(jparams)
    b.load_state_dict(st)
    cb.load_state_dict(cst)
    la, lb = a.run(3), b.run(3)
    _same_logs(la, lb, loss_rtol=0.0)
    assert torch.equal(a.reducer.flat_params, b.reducer.flat_params)
    assert a.frac_controller.state_dict() == b.frac_controller.state_dict()
    assert a.guardrails.state_dict()["strikes"] \
        == b.guardrails.state_dict()["strikes"]
    assert sum(lg.n_quarantined for lg in a.history) >= 1
    c = MasterEventLoop(reducer=b.reducer, cluster=cb,
                        training=TrainingConfig(T=T))
    with pytest.raises(ValueError, match="frac_controller mismatch"):
        c.load_state_dict(st)
