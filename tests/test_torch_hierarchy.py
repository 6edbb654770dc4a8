"""Port parity for the two-tier hierarchy: ``repro_torch.core.hierarchy``
(regional sub-masters, the compressed CHOCO-style WAN gossip, regional
churn, the two-tier TrainState), the regional network model, the
``build_training`` two-tier branch and ``launch.train --regions`` against
the JAX package, on the CPU. The cases mirror ``tests/test_hierarchy.py``
on its 24-feature linear problem, built in both packages from the same
numpy data; the problem's gradient is computed by the same numpy code on
both sides, so what is compared is the machinery under it.

Tolerances: OuterLog clocks, vectors, WAN bytes, region steps and events
equal (the seeded simulator, the matching stream, integer accounting);
loss, spread and params within 1e-6 absolute (the bound
``tests/test_torch_train.py`` uses for optimizer arithmetic); a resumed
run equals the uninterrupted one bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.core import (DeadlineConfig as JDeadline,  # noqa: E402
                        GradientCompressor as JComp,
                        HierarchicalMaster as JHier,
                        HierarchyConfig as JHierCfg, JoinEvent as JJoin,
                        MasterEventLoop as JLoop, MasterReducer as JReducer,
                        TrainingConfig as JTraining,
                        UploadDataEvent as JUpload)
from repro.core.scheduler import AdaptiveScheduler as JScheduler  # noqa: E402
from repro.core import simulation as jsim  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.core import (DeadlineConfig, GradientCompressor,  # noqa: E402
                              HierarchicalMaster, HierarchyConfig,
                              JoinEvent, MasterEventLoop, MasterReducer,
                              TrainingConfig, UploadDataEvent)
from repro_torch.core.config import PublishConfig  # noqa: E402
from repro_torch.core.scheduler import AdaptiveScheduler  # noqa: E402
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

N_FEAT = 24
N_DATA = 240
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU ops: torch's intra-op pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.RandomState(0)
    w_true = rng.randn(N_FEAT).astype(np.float32)
    X = rng.randn(N_DATA, N_FEAT).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    return X, y


def _np_grad(w, Xb, yb):
    """(grad_SUM, loss_SUM) of 0.5 * ||X w - y||^2 in float32 numpy: the
    same bits for both packages."""
    r = (Xb @ w - yb).astype(np.float32)
    return (Xb.T @ r).astype(np.float32), float(np.float32(0.5) * (r @ r))


def _j_grad(params, Xb, yb):
    g, loss = _np_grad(np.asarray(params["w"]), np.asarray(Xb),
                       np.asarray(yb))
    return {"w": jnp.asarray(g)}, loss


def _t_grad(params, Xb, yb):
    g, loss = _np_grad(params["w"].numpy(), Xb.numpy(), yb.numpy())
    return {"w": torch.from_numpy(g)}, loss


def _profile(mod, i):
    return mod.DeviceProfile(f"dev{i}", 300.0, 0.01, 0.05, uplink_bps=5e4)


def _region_loop(jax_side, name, cluster, n_workers=2, frac=0.5, T=0.2,
                 shard=None):
    if jax_side:
        red = JReducer({"w": jnp.zeros(N_FEAT)}, j_sgd(lr=0.005),
                       compressor=JComp("topk", frac=frac), fused=True)
        loop = JLoop(reducer=red, cluster=cluster,
                     scheduler=JScheduler(T=T, prior_power=300.0),
                     training=JTraining(T=T, deadline=JDeadline(
                         quantile=0.9, slack=2.0)))
        join, upload, mod = JJoin, JUpload, jsim
    else:
        red = MasterReducer({"w": torch.zeros(N_FEAT)}, sgd(lr=0.005),
                            compressor=GradientCompressor("topk", frac=frac),
                            fused=True)
        loop = MasterEventLoop(
            reducer=red, cluster=cluster,
            scheduler=AdaptiveScheduler(T=T, prior_power=300.0),
            training=TrainingConfig(T=T, deadline=DeadlineConfig(
                quantile=0.9, slack=2.0)))
        join, upload, mod = JoinEvent, UploadDataEvent, tsim
    loop.submit(upload(shard if shard is not None else range(N_DATA)))
    for i in range(n_workers):
        w = f"{name}:w{i}"
        cluster.add_worker(w, _profile(mod, i), region=name)
        loop.submit(join(w, capacity=N_DATA))
    return loop


def _cluster(jax_side, seed=0):
    X, y = _data()
    if jax_side:
        return jsim.SimulatedCluster(grad_fn=_j_grad, data=(X, y),
                                     mode="real", seed=seed,
                                     network=jsim.RegionalNetworkModel())
    return tsim.SimulatedCluster(grad_fn=_t_grad, data=(X, y), mode="real",
                                 seed=seed, device="cpu",
                                 network=tsim.RegionalNetworkModel())


def _build(jax_side, n_regions=3, seed=0, gossip_frac=1.0, inner_steps=2,
           gossip=True, gossip_lr=1.0, publish=None):
    cluster = _cluster(jax_side, seed)
    regions = {f"r{i}": _region_loop(jax_side, f"r{i}", cluster,
                                     shard=range(i, N_DATA, n_regions))
               for i in range(n_regions)}
    kw = dict(n_regions=n_regions, inner_steps=inner_steps, gossip=gossip,
              gossip_frac=gossip_frac, gossip_lr=gossip_lr, gossip_seed=seed)
    if jax_side:
        master = JHier(regions=regions, config=JHierCfg(**kw),
                       network=jsim.RegionalNetworkModel(), publish=publish)
    else:
        master = HierarchicalMaster(regions=regions,
                                    config=HierarchyConfig(**kw),
                                    network=tsim.RegionalNetworkModel(),
                                    publish=publish)
    return master, cluster


def _both(**kw):
    return _build(True, **kw)[0], _build(False, **kw)[0]


def _flat(master, r):
    return np.asarray(master.regions[r].reducer.flat_params)


def _same_logs(jlogs, tlogs):
    """OuterLogs: integer and clock fields equal, loss/spread within TOL."""
    assert len(jlogs) == len(tlogs)
    for a, b in zip(jlogs, tlogs):
        assert (a.outer_step, a.clock, a.vectors, a.wan_bytes, a.wan_time,
                a.region_steps, a.events) == \
            (b.outer_step, b.clock, b.vectors, b.wan_bytes, b.wan_time,
             b.region_steps, b.events)
        assert np.isfinite(a.loss) == np.isfinite(b.loss)
        if np.isfinite(a.loss):
            assert abs(a.loss - b.loss) <= TOL, (a.loss, b.loss)
        assert abs(a.spread - b.spread) <= TOL, (a.spread, b.spread)


def _same_params(jm, tm):
    assert jm.live_regions == tm.live_regions
    for r in jm.regions:
        np.testing.assert_allclose(_flat(tm, r), _flat(jm, r), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(tm.consensus_flat().numpy(),
                               np.asarray(jm.consensus_flat()), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the degenerate case: one region, no gossip == the flat loop, bit-exact
# ---------------------------------------------------------------------------
def test_single_region_no_gossip_is_bit_identical_to_flat_loop():
    H, outer = 2, 3
    flat_loop = _region_loop(False, "r0", _cluster(False))
    flat_loop.run(H * outer)
    jm, tm = _both(n_regions=1, gossip=False, inner_steps=H)
    _same_logs(jm.run(outer), tm.run(outer))
    hier = _flat(tm, "r0")
    np.testing.assert_array_equal(hier, flat_loop.reducer.flat_params.numpy())
    np.testing.assert_array_equal(tm.consensus_flat().numpy(), hier)
    _same_params(jm, tm)
    assert tm.wan_bytes == jm.wan_bytes == 0
    assert tm.summary() == jm.summary()
    assert tm.summary()["wan_bytes_frac"] == 0.0


# ---------------------------------------------------------------------------
# gossip_frac=1.0: the outer step is exact weighted averaging
# ---------------------------------------------------------------------------
def test_full_frac_gossip_is_exact_weighted_pairwise_average():
    jm, tm = _both(n_regions=2, gossip_frac=1.0, inner_steps=1)
    _same_logs([jm.iteration()], [tm.iteration()])
    np.testing.assert_allclose(_flat(tm, "r0"), _flat(tm, "r1"), rtol=0,
                               atol=1e-6)
    assert tm.history[-1].spread <= 1e-6
    _same_params(jm, tm)


def test_gossip_contracts_spread_and_loss_decreases():
    jm, tm = _both(n_regions=4, gossip_frac=1.0, inner_steps=2)
    jlogs, logs = jm.run(8), tm.run(8)
    _same_logs(jlogs, logs)
    _same_params(jm, tm)
    losses = [lg.loss for lg in logs]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.9, losses
    assert logs[-1].spread < 10.0 * max(logs[0].spread, 1e-9)
    # ablation: without the outer exchange the shards pull regions apart
    g, ng = _build(False, gossip_frac=1.0)[0], _build(False, gossip=False)[0]
    g.run(5)
    ng.run(5)
    assert ng.history[-1].spread > g.history[-1].spread


# ---------------------------------------------------------------------------
# WAN accounting: only compressed deltas cross regions
# ---------------------------------------------------------------------------
def test_wan_bytes_match_compressed_fanout_and_stay_minor():
    R, frac = 3, 0.25
    jm, tm = _both(n_regions=R, gossip_frac=frac, inner_steps=2)
    jlogs, logs = jm.run(4), tm.run(4)
    _same_logs(jlogs, logs)
    _same_params(jm, tm)
    per_msg = 8 * tm.compressor.flat_k(N_FEAT)
    expect_round = per_msg * (R - 1) * R
    for lg in logs:
        assert lg.wan_bytes == expect_round and lg.wan_time > 0.0
    s = tm.summary()
    assert s == jm.summary()
    assert s["wan_bytes"] == expect_round * len(logs)
    assert s["intra_bytes"] > 0 and s["wan_bytes_frac"] < 0.5
    assert s["communication_ratio"] == 0.5


def test_compressed_gossip_tracks_full_frac_gossip():
    full = _build(False, n_regions=2, gossip_frac=1.0, inner_steps=1)[0]
    jcomp, comp = _both(n_regions=2, gossip_frac=0.25, inner_steps=1)
    full.run(8)
    _same_logs(jcomp.run(8), comp.run(8))
    _same_params(jcomp, comp)
    assert comp.wan_bytes < full.wan_bytes
    d = float((full.consensus_flat() - comp.consensus_flat()).abs().max())
    assert d < 1.0, d
    assert np.isfinite(comp.history[-1].loss)


# ---------------------------------------------------------------------------
# regional churn
# ---------------------------------------------------------------------------
def test_region_leave_and_rejoin_reseeds_to_consensus():
    jm, tm = _both(n_regions=3, gossip_frac=1.0, inner_steps=2)
    for m in (jm, tm):
        m.run(2)
        m.leave_region("r1")
    assert tm.live_regions == ["r0", "r2"]
    stale = _flat(tm, "r1")
    jlogs, logs = jm.run(2), tm.run(2)
    _same_logs(jlogs, logs)
    assert "region-leave:r1" in logs[0].events
    assert sorted(logs[-1].region_steps) == ["r0", "r2"]
    for m in (jm, tm):
        m.join_region("r1")
    consensus_at_join = tm.consensus_flat().numpy()
    back = _flat(tm, "r1")
    assert not np.array_equal(back, stale), "rejoin kept stale params"
    np.testing.assert_allclose(back, consensus_at_join, atol=1e-5)
    assert tm.regions["r1"].clock >= tm.clock - 1e-9
    _same_params(jm, tm)
    jl, log = jm.iteration(), tm.iteration()
    _same_logs([jl], [log])
    assert "region-join:r1" in log.events
    assert sorted(log.region_steps) == ["r0", "r1", "r2"]
    _same_params(jm, tm)
    # leaving all but one region: gossip is skipped, nothing crosses
    jm, tm = _both(n_regions=2, gossip_frac=1.0, inner_steps=1)
    for m in (jm, tm):
        m.leave_region("r1")
    jl, log = jm.iteration(), tm.iteration()
    _same_logs([jl], [log])
    assert log.wan_bytes == 0 and log.spread == 0.0
    assert tm.live_regions == ["r0"]


# ---------------------------------------------------------------------------
# checkpoint: the whole two-tier stack round-trips bit-exactly
# ---------------------------------------------------------------------------
def test_two_tier_checkpoint_resume_is_bit_exact(tmp_path):
    total, cut = 6, 3
    base, _ = _build(False, n_regions=3, gossip_frac=0.5, inner_steps=2)
    base.run(total)
    part, part_cluster = _build(False, n_regions=3, gossip_frac=0.5,
                                inner_steps=2)
    part.run(cut)
    path = str(tmp_path / "hier.npz")
    tio.save_train_state(path, tio.TrainState.capture(part, part_cluster))
    resumed, resumed_cluster = _build(False, n_regions=3, gossip_frac=0.5,
                                      inner_steps=2)
    tio.load_train_state(path).restore(resumed, resumed_cluster)
    assert resumed.outer_step == cut
    resumed.run(total - cut)
    np.testing.assert_array_equal(base.consensus_flat().numpy(),
                                  resumed.consensus_flat().numpy())
    for r in base.regions:
        np.testing.assert_array_equal(_flat(base, r), _flat(resumed, r))
        assert base.regions[r].step == resumed.regions[r].step
    assert base.clock == resumed.clock
    assert base.wan_bytes == resumed.wan_bytes
    assert [lg.spread for lg in base.history] == \
        [lg.spread for lg in resumed.history]
    # and the uninterrupted JAX run agrees with both
    jbase, _ = _build(True, n_regions=3, gossip_frac=0.5, inner_steps=2)
    jbase.run(total)
    _same_logs(jbase.history, resumed.history)
    _same_params(jbase, resumed)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_two_tier_train_state_cross_loads(tmp_path, writer):
    """A two-tier TrainState written by either package resumes in the
    other, and the continued runs agree."""
    cut, more = 2, 2
    src_jax = writer == "jax"
    src, src_cluster = _build(src_jax, n_regions=3, gossip_frac=0.5,
                              inner_steps=2)
    src.run(cut)
    path = str(tmp_path / "hier.npz")
    io_w, io_r = (jio, tio) if src_jax else (tio, jio)
    io_w.save_train_state(path, io_w.TrainState.capture(src, src_cluster))
    dst, dst_cluster = _build(not src_jax, n_regions=3, gossip_frac=0.5,
                              inner_steps=2)
    io_r.load_train_state(path).restore(dst, dst_cluster)
    assert dst.outer_step == cut
    a, b = src.run(more), dst.run(more)
    jm, tm = (src, dst) if src_jax else (dst, src)
    _same_logs(*((a, b) if src_jax else (b, a)))
    _same_logs(jm.history, tm.history)
    _same_params(jm, tm)


def test_serving_params_reads_two_tier_snapshot(tmp_path):
    tm, cluster = _build(False, n_regions=2, gossip_frac=1.0, inner_steps=1)
    tm.run(2)
    path = str(tmp_path / "hier.npz")
    tio.save_train_state(path, tio.TrainState.capture(tm, cluster))
    template = {"w": torch.zeros(N_FEAT)}
    got, version = tio.serving_params_from_train_state(
        tio.load_train_state(path), template)
    assert torch.equal(got["w"], tm.params["w"])
    assert torch.equal(got["w"], tm.consensus_flat())
    assert version == max(lp.step for lp in tm.regions.values())
    # the JAX package reads the same file to the same params and version
    jgot, jversion = jio.serving_params_from_train_state(
        jio.load_train_state(path), {"w": jnp.zeros(N_FEAT)})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), got["w"].numpy())
    assert jversion == version


def test_resume_refuses_region_mismatch():
    master, _ = _build(False, n_regions=2, gossip_frac=1.0)
    master.run(1)
    other, _ = _build(False, n_regions=3, gossip_frac=1.0)
    with pytest.raises(ValueError, match="region mismatch"):
        other.load_state_dict(master.state_dict())


# ---------------------------------------------------------------------------
# construction validation names the offending value
# ---------------------------------------------------------------------------
def test_constructor_validation():
    cluster = _cluster(False)
    with pytest.raises(ValueError, match="at least one"):
        HierarchicalMaster(regions={},
                           config=HierarchyConfig(gossip=False))
    loop = _region_loop(False, "r0", cluster)
    with pytest.raises(ValueError, match="needs >= 2"):
        HierarchicalMaster(regions={"r0": loop},
                           config=HierarchyConfig(n_regions=2))
    unfused = MasterReducer({"w": torch.zeros(N_FEAT)}, sgd(lr=0.01),
                            compressor=GradientCompressor("topk", frac=0.5),
                            fused=False)
    bad = MasterEventLoop(reducer=unfused, cluster=cluster,
                          scheduler=AdaptiveScheduler(T=0.2))
    with pytest.raises(ValueError, match="fused"):
        HierarchicalMaster(regions={"r0": bad},
                           config=HierarchyConfig(gossip=False))
    master, _ = _build(False, n_regions=2, gossip_frac=1.0)
    with pytest.raises(ValueError, match="unknown region"):
        master.join_region("r9")
    # HierarchyConfig's messages are the JAX package's, word for word
    for kw in (dict(n_regions=0), dict(inner_steps=0),
               dict(n_regions=1, gossip=True), dict(gossip_frac=0.0),
               dict(n_regions=2, gossip_lr=1.5)):
        with pytest.raises(ValueError) as want:
            JHierCfg(**kw)
        with pytest.raises(ValueError) as got:
            HierarchyConfig(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# build_training's two-tier branch, the outer publish hook, the launcher
# ---------------------------------------------------------------------------
def test_build_training_two_tier_branch():
    from repro.launch.train_serve import build_training as j_build
    from repro.launch.train_serve import tiny_cfg as j_tiny
    from repro.models import transformer as j_tf
    from repro_torch.checkpoint.convert import params_from_jax
    from repro_torch.launch.train_serve import build_training, tiny_cfg

    hier = dict(n_regions=2, inner_steps=2, gossip_frac=0.5)
    jmaster, _, _ = j_build(j_tiny(), training=JTraining(
        T=0.2, hierarchy=JHierCfg(**hier)), seed=0, churny=False, n_data=64)
    jp = jax.tree.map(np.asarray, j_tf.init_params(jax.random.PRNGKey(0),
                                                   j_tiny()))
    master, cluster, _ = build_training(
        tiny_cfg(), training=TrainingConfig(
            T=0.2, hierarchy=HierarchyConfig(**hier)),
        seed=0, churny=False, n_data=64, device="cpu",
        init_params=params_from_jax(jp, tiny_cfg(), device="cpu"))
    assert isinstance(master, HierarchicalMaster)
    assert master.live_regions == ["r0", "r1"]
    assert cluster.region_of("r0:w0") == "r0"
    assert sorted(cluster.workers) == sorted(
        f"r{r}:w{i}" for r in range(2) for i in range(3))
    jlog, log = jmaster.iteration(), master.iteration()
    for ri, r in enumerate(master.live_regions):     # each region's shard
        held = set().union(*(a.allocated for a in
                             master.regions[r].allocator.workers.values()))
        assert held == set(range(ri, 64, 2))
    assert np.isfinite(log.loss) and log.wan_bytes > 0
    assert (log.clock, log.vectors, log.wan_bytes, log.region_steps,
            log.events) == (jlog.clock, jlog.vectors, jlog.wan_bytes,
                            jlog.region_steps, jlog.events)
    assert abs(log.loss - jlog.loss) <= 1e-3 * abs(jlog.loss)


def test_outer_publish_hook_fires_on_consensus():
    from repro.core.config import PublishConfig as JPublish

    published, jpub = [], []
    tm, _ = _build(False, n_regions=2, inner_steps=1, gossip_frac=1.0,
                   publish=PublishConfig(
                       every=2, fn=lambda p, v, t: published.append(
                           (v, t, p["w"].numpy().copy()))))
    jm, _ = _build(True, n_regions=2, inner_steps=1, gossip_frac=1.0,
                   publish=JPublish(every=2, fn=lambda p, v, t: jpub.append(
                       (v, t, np.asarray(p["w"])))))
    tm.run(5)
    jm.run(5)
    assert [v for v, _, _ in published] == [2, 4]
    clocks = [t for _, t, _ in published]
    assert clocks == sorted(clocks) and clocks[0] > 0.0
    assert [(v, t) for v, t, _ in jpub] == [(v, t) for v, t, _ in published]
    for (_, _, a), (_, _, b) in zip(published, jpub):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_launcher_regions_reduced_on_cpu(capsys):
    """``launch.train --simulate --regions 2 --reduced --device cpu``
    prints the JAX launcher's two lines: its clock, WAN bytes and share
    and communication ratio equal the JAX run's (the seeded fleet and
    the top-k byte count), its loss the port's own seeded weights'."""
    from repro.launch import train as j_train

    argv = ["--simulate", "--regions", "2", "--reduced", "--steps", "4"]
    assert j_train.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert t_train.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 2
    assert got[0].split("loss ")[0] == want[0].split("loss ")[0]
    assert got[0].startswith("hierarchy: 2 regions x 4 inner, 1 outer "
                             "steps, clock=")
    assert got[1] == want[1]
    first, last = (float(x) for x in got[0].split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
