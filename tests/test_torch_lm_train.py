"""Port parity for LM training: ``repro_torch``'s token cross-entropy,
full-sequence attention, the dense training forward, ``make_lm_problem``,
``build_training`` and ``launch.train --simulate`` against the JAX
package, on the CPU, at ``mlitb-lm-100m.reduced()`` (2 layers, d 128,
4 heads, 1 KV head, vocab 512) and at ``tiny_cfg()``. Weights are the
JAX side's ``jax.random`` draw carried across with ``params_from_jax``;
token data comes from the same numpy stream on both sides.

Tolerances: the loss within 1e-6 relative and every gradient leaf within
1e-5 relative to its largest entry (float32, sums in another order);
attention outputs 1e-5 relative; the simulated run's events, worker
counts, vectors and wire bytes equal (they follow the seeded simulator
and the selection), its loss within 1e-3 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import simulation as jsim  # noqa: E402
from repro.launch.train_serve import build_training as j_build  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.core.flatbuf import build_tree, tree_paths  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.train_serve import build_training  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCH = "mlitb-lm-100m"
CFGS = {"reduced": (lambda: get_config(ARCH).reduced(),
                    lambda: t_get_config(ARCH).reduced()),
        "tiny": (j_tiny, tiny_cfg)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, j_tf.init_params(jax.random.PRNGKey(seed),
                                                     cfg))



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: torch's intra-op thread pool
    costs more than it saves, and beside other test workers it
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module", params=sorted(CFGS))
def lm(request):
    jcfg, tcfg = (f() for f in CFGS[request.param])
    jp = _jax_params(jcfg)
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg, device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """``repro``'s ``build_training`` at the reduced size, 4 iterations
    (shared by the run and launcher tests: it is the JAX side's cost)."""
    cfg = get_config(ARCH).reduced()
    loop, _, params = j_build(cfg, seed=0)
    return loop.run(4), jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the pieces of the forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(masked):
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32) if masked else None
    js, jn = j_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None
                                   else jnp.asarray(mask))
    ts, tn = t_layers.softmax_xent(torch.tensor(logits), torch.tensor(labels),
                                   None if mask is None
                                   else torch.tensor(mask))
    assert _rel(ts.numpy(), js) <= 1e-6 and float(tn) == float(jn)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 4),
                                           (False, 0)])
def test_make_mask_and_full_sequence_attention(causal, window):
    cfg = get_config(ARCH).reduced()
    tcfg = t_get_config(ARCH).reduced()
    jp = _jax_params(cfg, seed=1)
    tp = params_from_jax(jp, tcfg, device="cpu")
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    jm = j_attn.make_mask(jnp.asarray(pos), jnp.asarray(pos), causal, window)
    tm = t_attn.make_mask(torch.tensor(pos), torch.tensor(pos), causal,
                          window)
    assert tuple(tm.shape) == jm.shape
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = t_layers.layer(tp["blocks"], 0)["attn"]
    want = j_attn.attention(ja, jnp.asarray(x), jnp.asarray(pos),
                            causal=causal, window=window)
    got = t_attn.attention(ta, torch.tensor(x), torch.tensor(pos),
                           causal=causal, window=window)
    assert _rel(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# the LM problem: loss and every gradient leaf
# ---------------------------------------------------------------------------
def test_lm_problem_loss_and_gradients(lm):
    jcfg, tcfg, jp, tp = lm
    (jX, jy), j_grad = jsim.make_lm_problem(jcfg, n_data=64, seed=5)
    (tX, ty), t_grad = tsim.make_lm_problem(tcfg, n_data=64, seed=5,
                                            device="cpu")
    assert np.array_equal(jX, tX) and np.array_equal(jy, ty)
    assert tX.dtype == np.int32 and tX.shape == (64, 16)
    idx = np.random.RandomState(6).choice(64, 9, replace=False)
    jg, jl = j_grad(jp, jX[idx], jy[idx])
    tg, tl = t_grad(tp, torch.from_numpy(tX[idx]), torch.from_numpy(ty[idx]))
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = list(tree_paths(tg))
    assert [tuple(k.key for k in p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]          # jax.tree.leaves order
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert b.shape == a.shape and not b.requires_grad
        assert _rel(b.numpy(), a) <= 1e-5, path


def test_forward_remat_gives_the_same_gradient(lm):
    _, tcfg, _, tp = lm
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    grads = []
    for remat in (False, True):
        paths, leaves = zip(*[(p, x.detach().requires_grad_(True))
                              for p, x in tree_paths(tp)])
        logits, aux = t_tf.forward(build_tree(paths, leaves), tcfg, toks,
                                   remat=remat)
        assert float(aux) == 0.0
        s, _ = t_layers.softmax_xent(logits, toks)
        grads.append(torch.autograd.grad(s, leaves))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the simulated fleet end to end
# ---------------------------------------------------------------------------
def test_build_training_run_matches_jax(jax_run):
    j_logs, jp = jax_run
    tcfg = t_get_config(ARCH).reduced()
    loop, cluster, params = build_training(
        tcfg, seed=0, device="cpu",
        init_params=params_from_jax(jp, tcfg, device="cpu"))
    t_logs = loop.run(4)
    for a, b in zip(j_logs, t_logs):
        assert (a.step, a.events, a.n_workers, a.vectors, a.wire_bytes,
                a.per_worker_wire_bytes, a.n_late, a.n_quarantined,
                a.rolled_back) \
            == (b.step, b.events, b.n_workers, b.vectors, b.wire_bytes,
                b.per_worker_wire_bytes, b.n_late, b.n_quarantined,
                b.rolled_back)
        assert a.wall_time == b.wall_time and a.deadline == b.deadline
        assert abs(a.loss - b.loss) <= 1e-3 * abs(a.loss)
    assert sum(lg.n_late for lg in t_logs) >= 1      # the deadline bites
    assert len(cluster.workers) == 4 and loop.reducer.step == 4


def test_build_training_defaults_and_construction_surface():
    from repro_torch.core import GuardrailConfig, TrainingConfig
    cfg = tiny_cfg()
    loop, cluster, params = build_training(cfg, device="cpu")
    comp = loop.reducer.compressor
    assert (comp.method, comp.frac) == ("topk", 0.1)
    assert loop.reducer.optimizer.name == "adagrad"
    assert (loop.scheduler.T, loop.scheduler.prior_power,
            loop.scheduler.min_budget) == (0.5, 300.0, 0.05)
    assert loop.deadline_quantile == 0.5 and loop.guardrails is None
    assert sorted(cluster.workers) == ["w0", "w1", "w2", "w3"]
    assert cluster.data[0].shape == (512, 16)
    loop, cluster, _ = build_training(cfg, churny=False, device="cpu")
    assert loop.deadline_quantile is None and len(cluster.workers) == 3
    with pytest.warns(DeprecationWarning, match="flat kwargs"):
        loop, _, _ = build_training(cfg, T=0.3, guardrails=GuardrailConfig(),
                                    device="cpu")
    assert loop.scheduler.T == 0.3 and loop.guardrails is not None
    with pytest.raises(ValueError, match="not both"):
        build_training(cfg, training=TrainingConfig(), T=0.3, device="cpu")
    # the two-tier branch (A5): one sub-master per region, the same fleet
    from repro_torch.core import HierarchicalMaster, HierarchyConfig
    master, cluster, _ = build_training(cfg, training=TrainingConfig(
        hierarchy=HierarchyConfig(n_regions=2)), device="cpu")
    assert isinstance(master, HierarchicalMaster)
    assert master.live_regions == ["r0", "r1"]
    assert sorted(cluster.workers) == [f"r{r}:w{i}" for r in range(2)
                                       for i in range(4)]
    assert cluster.region_of("r1:w3") == "r1"


def test_launcher_simulate_reduced_on_cpu(jax_run, capsys):
    """The ``--simulate --reduced --device cpu`` printout: its clock is the
    JAX package's (the seeded fleet's walls), its loss falls from the
    port's own seeded weights."""
    j_logs, _ = jax_run
    assert t_train.main(["--simulate", "--reduced", "--steps", "3",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    clock = sum(lg.wall_time for lg in j_logs[:3])
    assert out[-1].startswith(f"flat: 3 iterations, clock={clock:.2f}s, "
                              f"loss ")
    first, last = (float(x) for x in out[-1].split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
    assert "host ms per iteration" not in capsys.readouterr().out
    # --regions > 1 trains the two-tier hierarchy (A5)
    assert t_train.main(["--simulate", "--reduced", "--regions", "2",
                         "--steps", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2].startswith("hierarchy: 2 regions x 4 inner, 1 outer "
                              "steps, clock=")
    assert out[-1].startswith("wan: ") and out[-1].endswith(
        "comm ratio 0.250")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        t_train.main(["--reduced", "--device", "cpu"])


def test_lm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    cfg = tiny_cfg()
    for call in (lambda: tsim.make_lm_problem(cfg),
                 lambda: build_training(cfg),
                 lambda: t_train.main(["--simulate", "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
