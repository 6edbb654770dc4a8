"""Port parity for the single-device training path: ``repro_torch``'s
``make_train_state`` / ``build_train_step`` and ``ElasticMeshSGD``
against the JAX package's on the CPU, at ``.reduced()`` widths. JAX
weights are carried across with ``params_from_jax``; batches are numpy
arrays from a seed, fed to both sides.

Tolerances (float32): ``loss``, ``aux_loss`` and ``total_loss`` within
1e-5 absolute, ``tokens`` exact; with ``sgd``, every param leaf within
1e-5 absolute after the steps. The engine's work masks bit for bit,
``tokens`` and ``n_live`` exact; losses within 1e-5 with ``sgd`` and
1e-3 relative with AdaGrad lr 0.05, whose first step is lr * sign(g)
(a gradient entry near zero can flip sign under rounding noise, so
AdaGrad runs are held on losses only). The port's own properties (masked
rows, mask weighting, remat) within 1e-5, as ``tests/test_train_step.py``
holds the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.mesh_engine import ElasticMeshSGD as JEngine  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import adagrad as j_adagrad  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro.train.step import make_train_state as j_state  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.flatbuf import tree_paths  # noqa: E402
from repro_torch.core.mesh_engine import ElasticMeshSGD  # noqa: E402
from repro_torch.distributed.sharding import (param_specs,  # noqa: E402
                                              to_shardings)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.transformer import \
    init_params as t_init_params  # noqa: E402
from repro_torch.optim import adagrad, sgd  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                    make_train_state)

TOL = 1e-5
# one reduced config per family
FAMILIES = ["qwen3-4b", "llama4-scout-17b-a16e", "mamba2-780m",
            "zamba2-7b", "paligemma-3b", "whisper-large-v3"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        j_tf.init_params(jax.random.PRNGKey(seed), cfg))


def _batch(cfg, B, S, seed, mask=None):
    """tokens / labels (int32) and mask (float32) from one RandomState,
    plus a VLM's ``prefix`` or the audio family's ``frames``."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (np.ones((B, S), np.float32) if mask is None
                    else np.asarray(mask, np.float32))}
    extra = {"vlm": ("prefix", cfg.n_prefix_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    if extra:
        name, n = extra
        out[name] = (rs.standard_normal((B, n, cfg.d_model)) * 0.02
                     ).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_close(t_params, j_params, tol=TOL):
    want = dict(jax.tree_util.tree_flatten_with_path(j_params)[0])
    got = list(tree_paths(t_params))
    assert len(got) == len(want)
    worst = 0.0
    for (path, leaf), (jpath, jleaf) in zip(
            got, jax.tree_util.tree_flatten_with_path(j_params)[0]):
        assert path == tuple(k.key for k in jpath), (path, jpath)
        d = np.abs(leaf.detach().numpy().astype(np.float64)
                   - np.asarray(jleaf, np.float64))
        worst = max(worst, float(d.max()) if d.size else 0.0)
        assert worst <= tol, (path, worst)
    return worst


def _pair(name, opt_pair, B=4, S=16, **kw):
    """The two packages' train steps and states on the same weights."""
    jcfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    jp = _jax_params(jcfg)
    jopt, topt = opt_pair
    jstep = jax.jit(j_build(jcfg, jopt, **kw))
    tstep = build_train_step(tcfg, topt, **kw)
    return (jcfg, tcfg, jstep, tstep, j_state(jp, jopt),
            make_train_state(params_from_jax(jp, tcfg, device="cpu"), topt))


# ---------------------------------------------------------------------------
# build_train_step against repro
# ---------------------------------------------------------------------------
def test_train_step_sgd_matches_reference_two_steps():
    jcfg, _, jstep, tstep, js, ts = _pair(
        "qwen3-4b", (j_sgd(lr=0.1), sgd(lr=0.1)), remat=False)
    for i in range(2):
        b = _batch(jcfg, 4, 16, seed=10 + i)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _t(b))
        for k in ("loss", "aux_loss", "total_loss"):
            assert abs(float(tm[k]) - float(jm[k])) <= TOL, k
        assert float(tm["tokens"]) == float(jm["tokens"]) == 64.0
    _leaves_close(ts["params"], js["params"])
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 2


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_every_family_matches_reference(name):
    """Two sgd steps with aux_weight 0.01 and a masked row. MoE: the
    router's top-k picks are the same in both packages here, so its
    params hold 1e-5 as well."""
    jcfg, _, jstep, tstep, js, ts = _pair(
        name, (j_sgd(lr=0.1), sgd(lr=0.1)), remat=False, aux_weight=0.01)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0.0
    for i in range(2):
        b = _batch(jcfg, 2, 8, seed=20 + i, mask=mask)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _t(b))
        for k in ("loss", "aux_loss", "total_loss"):
            assert abs(float(tm[k]) - float(jm[k])) <= TOL, (k, tm[k], jm[k])
        assert float(tm["tokens"]) == float(jm["tokens"]) == 13.0
    if jcfg.arch_type == "moe":
        assert float(tm["aux_loss"]) > 0.0
    _leaves_close(ts["params"], js["params"])


def test_all_masked_batch_reports_one_token():
    jcfg, _, jstep, tstep, js, ts = _pair(
        "qwen3-4b", (j_sgd(lr=0.1), sgd(lr=0.1)), remat=False)
    b = _batch(jcfg, 2, 8, seed=3, mask=np.zeros((2, 8)))
    js, jm = jstep(js, b)
    ts, tm = tstep(ts, _t(b))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 1.0
    assert float(tm["loss"]) == float(jm["loss"]) == 0.0
    # nothing to learn from: sgd leaves every param where it was
    _leaves_close(ts["params"], js["params"], tol=0.0)


# ---------------------------------------------------------------------------
# the reference's train-step properties, held by the port
# ---------------------------------------------------------------------------
def _setup(name="qwen3-4b", lr=0.1, **kw):
    cfg = t_get_config(name).reduced()
    params = params_from_jax(_jax_params(get_config(name).reduced()), cfg,
                             device="cpu")
    opt = sgd(lr=lr)
    kw.setdefault("aux_weight", 0.0)
    return cfg, params, opt, build_train_step(cfg, opt, remat=False, **kw)


def _max_leaf_diff(a, b):
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(tree_paths(a), tree_paths(b)))


def test_masked_rows_equal_smaller_batch():
    cfg, params, opt, step = _setup()
    b = _t(_batch(cfg, 4, 16, seed=1))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])[:, None] * torch.ones(4, 16)
    st1, m1 = step(make_train_state(params, opt), dict(b, mask=mask))
    st2, m2 = step(make_train_state(params, opt),
                   {"tokens": b["tokens"][:2], "labels": b["labels"][:2],
                    "mask": torch.ones(2, 16)})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < TOL
    assert _max_leaf_diff(st1["params"], st2["params"]) < TOL


def test_heterogeneous_masks_weight_correctly():
    cfg, params, opt, step = _setup()
    b = _t(_batch(cfg, 4, 8, seed=2))
    full = torch.ones(4, 8)
    _, m_full = step(make_train_state(params, opt), b)
    half_a, half_b = full.clone(), full.clone()
    half_a[2:] = 0.0
    half_b[:2] = 0.0
    _, m_a = step(make_train_state(params, opt), dict(b, mask=half_a))
    _, m_b = step(make_train_state(params, opt), dict(b, mask=half_b))
    combined = (float(m_a["loss"]) * float(m_a["tokens"])
                + float(m_b["loss"]) * float(m_b["tokens"])) \
        / (float(m_a["tokens"]) + float(m_b["tokens"]))
    assert abs(combined - float(m_full["loss"])) < TOL


def test_adagrad_loss_decreases_lm():
    cfg, params, _, _ = _setup()
    opt = adagrad(lr=0.05, init_accum=0.1)
    step = build_train_step(cfg, opt, remat=False)
    st = make_train_state(params, opt)
    b = _t(_batch(cfg, 4, 16, seed=3))
    losses = []
    for _ in range(5):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["qwen3-4b", "llama4-scout-17b-a16e"])
def test_remat_matches_no_remat(name):
    """``torch.utils.checkpoint`` around each block gives the loss and
    params of the plain backward; the MoE block returns (x, aux)."""
    cfg, params, opt, _ = _setup(name)
    b = _t(_batch(cfg, 2, 16, seed=4))
    outs = []
    for remat in (False, True):
        step = build_train_step(cfg, opt, remat=remat, aux_weight=0.01)
        st, m = step(make_train_state(params, opt), b)
        outs.append((float(m["total_loss"]), float(m["aux_loss"]),
                     st["params"]))
    assert abs(outs[0][0] - outs[1][0]) < TOL
    assert abs(outs[0][1] - outs[1][1]) < TOL
    assert _max_leaf_diff(outs[0][2], outs[1][2]) < TOL


# ---------------------------------------------------------------------------
# ElasticMeshSGD against repro on one device
# ---------------------------------------------------------------------------
B, S = 8, 16


def _engines(jopt, topt):
    jcfg, tcfg = get_config("qwen3-4b").reduced(), \
        t_get_config("qwen3-4b").reduced()
    jp = _jax_params(jcfg)
    je = JEngine(train_step=j_build(jcfg, jopt, remat=False),
                 state=j_state(jp, jopt), n_workers=4, global_batch=B)
    te = ElasticMeshSGD(
        train_step=build_train_step(tcfg, topt, remat=False),
        state=make_train_state(params_from_jax(jp, tcfg, device="cpu"),
                               topt), n_workers=4, global_batch=B)
    rs = np.random.RandomState(1)
    batch = {"tokens": rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    return je, te, batch


def _churn_scenario(je, te, batch, power=None):
    """4 steps, leave(2), a step, join(2), a step (the reference's
    multi-device scenario without the mesh); ``power`` is fed to every
    step after the first. Returns (jax metrics, port metrics)."""
    jm, tm = [], []

    def step(i):
        pw = power if (power and i > 0) else None
        np.testing.assert_array_equal(te.work_mask(S).numpy(),
                                      np.asarray(je.work_mask(S)))
        jm.append(je.step({k: jnp.asarray(v) for k, v in batch.items()}, pw))
        tm.append(te.step(batch, pw))

    for i in range(4):
        step(i)
    je.leave(2)
    te.leave(2)
    step(4)
    je.join(2)
    te.join(2)
    step(5)
    np.testing.assert_array_equal(te.work_mask(S).numpy(),
                                  np.asarray(je.work_mask(S)))
    for a, b in zip(tm, jm):
        assert a["tokens"] == b["tokens"] and a["n_live"] == b["n_live"]
    return jm, tm


def test_mesh_engine_churn_matches_reference_sgd():
    je, te, batch = _engines(j_sgd(lr=0.1), sgd(lr=0.1))
    jm, tm = _churn_scenario(je, te, batch)
    assert [m["n_live"] for m in tm] == [4, 4, 4, 4, 3, 4]
    assert [m["tokens"] for m in tm] == [128.0] * 4 + [96.0, 128.0]
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= TOL
    assert tm[3]["loss"] < tm[0]["loss"]
    _leaves_close(te.state["params"], je.state["params"])
    assert te.history == tm


def test_mesh_engine_churn_matches_reference_adagrad():
    je, te, batch = _engines(j_adagrad(lr=0.05), adagrad(lr=0.05))
    jm, tm = _churn_scenario(je, te, batch)
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-3 * abs(b["loss"])


def test_mesh_engine_power_feed_keeps_masks_equal():
    """Measured powers reshape the scheduler's budgets (worker 0 gets
    more rows than its slice holds, worker 3 fewer): masks and tokens
    stay equal to the reference's."""
    je, te, batch = _engines(j_sgd(lr=0.1), sgd(lr=0.1))
    power = {"vw0": 400.0, "vw1": 100.0, "vw2": 100.0, "vw3": 20.0}
    jm, tm = _churn_scenario(je, te, batch, power)
    assert tm[-1]["tokens"] < 128.0
    assert {w: s.power for w, s in te.scheduler.stats.items()} == \
        {w: s.power for w, s in je.scheduler.stats.items()}
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= TOL


def test_mesh_engine_refuses_shardings_and_ragged_batch():
    """Shardings run only inside an entered mesh (the sharded engine's
    own tests spawn its worlds: tests/test_torch_mesh_dist.py); a
    ``jit_kwargs`` key the port does not take raises by name."""
    cfg = t_get_config("qwen3-4b").reduced()
    opt = sgd(lr=0.1)
    st = {"params": {"w": torch.zeros(2)}, "opt": {}}
    full = make_train_state(t_init_params(cfg, device="cpu"), opt)
    mesh = make_host_mesh(2, 2)
    sh = to_shardings(param_specs(full, cfg, mesh, "train"), mesh)
    with pytest.raises(RuntimeError, match="is not entered"):
        ElasticMeshSGD(train_step=build_train_step(cfg, opt), state=full,
                       n_workers=4, global_batch=8,
                       jit_kwargs={"in_shardings": (sh, None)})
    with pytest.raises(TypeError, match="static_argnums"):
        ElasticMeshSGD(train_step=build_train_step(cfg, opt), state=st,
                       n_workers=4, global_batch=8,
                       jit_kwargs={"static_argnums": (1,)})
    with pytest.raises(ValueError, match="multiple of n_workers=3"):
        ElasticMeshSGD(train_step=build_train_step(cfg, opt), state=st,
                       n_workers=3, global_batch=8)
