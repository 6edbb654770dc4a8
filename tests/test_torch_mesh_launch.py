"""Port parity for the mesh path's data and launcher: ``repro_torch``'s
sharded pipelines, ``launch.train``'s ``data_stream`` / ``parse_churn``
/ ``main`` without ``--simulate``, and the quickstart flow (train under
churn, save a research closure, reload it, serve it), against the JAX
package on the CPU.

The pipelines' batches and ``data_stream``'s are numpy-driven, so they
must equal the reference's bit for bit. ``main`` runs with the JAX
side's weights (``params_from_jax`` in place of the port's
``init_params``) and ``sgd``: churn lines, tokens and live counts equal,
every step's loss within 1e-5 absolute, the two closures' params within
1e-5 absolute, each closure loading in the other package.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.allocator import DataAllocator as JAlloc  # noqa: E402
from repro.core.closure import ResearchClosure as JClosure  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.data.datasets import synthetic_lm, synthetic_mnist  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.allocator import DataAllocator  # noqa: E402
from repro_torch.core.closure import ResearchClosure, torchify  # noqa: E402
from repro_torch.core.flatbuf import tree_paths  # noqa: E402
from repro_torch.core.mesh_engine import ElasticMeshSGD  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.data.datasets import synthetic_lm as t_lm  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                    make_train_state)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(ops):
    """Run ``ops(Alloc, pipe_module)`` once per package."""
    return ops(JAlloc, j_pipe), ops(DataAllocator, t_pipe)


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the sharded pipelines: the four reference scenarios, outputs equal
# ---------------------------------------------------------------------------
def test_pipeline_worker_batches_respect_ownership():
    X, y = synthetic_mnist(100, seed=0)

    def ops(Alloc, pipe_mod):
        alloc = Alloc()
        for w in ("a", "b"):
            alloc.add_worker(w, capacity=100)
        pipe = pipe_mod.ShardedBatchPipeline(X, y, alloc)
        a = pipe.worker_batch("a", 30)
        alloc.add_worker("c", capacity=5)
        return a, pipe.worker_batch("c", 30)

    j, t = _both(ops)
    _equal(j, t)
    assert t[0][2] == 30 and t[1][2] == 5


def test_pipeline_global_batch_mask_layout():
    X, y = synthetic_mnist(40, seed=1)

    def ops(Alloc, pipe_mod):
        alloc = Alloc()
        alloc.add_worker("w0", capacity=100)
        alloc.add_worker("w1", capacity=2)
        pipe = pipe_mod.ShardedBatchPipeline(X, y, alloc)
        return pipe.global_batch(rows_per_worker=8), \
            pipe.global_batch(rows_per_worker=8)

    j, t = _both(ops)
    _equal(j, t)
    mask = t[0][2]
    assert mask[:8].sum() == 8 and mask[8:].sum() == 2


def test_pipeline_churn_reallocates_equally():
    X, y = synthetic_mnist(60, seed=2)

    def ops(Alloc, pipe_mod):
        alloc = Alloc()
        for w in ("a", "b", "c"):
            alloc.add_worker(w, capacity=60)
        pipe = pipe_mod.ShardedBatchPipeline(X, y, alloc)
        first = pipe.global_batch(rows_per_worker=10)
        alloc.remove_worker("b")
        alloc.check_invariants()
        after = pipe.global_batch(rows_per_worker=10)
        alloc.add_worker("d", capacity=30)
        rejoined = pipe.global_batch(rows_per_worker=10)
        owners = {w: sorted(a.allocated) for w, a in alloc.workers.items()}
        return first, after, rejoined, owners

    j, t = _both(ops)
    _equal(j[:3], t[:3])
    assert j[3] == t[3]
    assert t[1][0].shape[0] == 20 and t[2][0].shape[0] == 30


def test_lm_pipeline_matches_reference():
    toks = synthetic_lm(5000, vocab=64, seed=0)

    def ops(Alloc, pipe_mod):
        alloc = Alloc()
        alloc.add_worker("w0", capacity=1000)
        alloc.add_worker("w1", capacity=40)
        pipe = pipe_mod.ShardedLMPipeline(toks, seq_len=32, allocator=alloc)
        first = pipe.global_batch(rows_per_worker=4)
        alloc.remove_worker("w0")
        return first, pipe.global_batch(rows_per_worker=4)

    j, t = _both(ops)
    _equal(j, t)
    batch = t[0]
    assert batch["tokens"].shape == (8, 32) and batch["tokens"].dtype == \
        np.int32
    for r in range(8):
        assert (batch["tokens"][r][1:] == batch["labels"][r][:-1]).all()


# ---------------------------------------------------------------------------
# the launcher's pieces
# ---------------------------------------------------------------------------
def test_data_stream_matches_reference():
    js = j_train.data_stream(512, 4, 16, seed=3)
    ts = t_train.data_stream(512, 4, 16, seed=3, device="cpu")
    for _ in range(3):
        jb, tb = next(js), next(ts)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_array_equal(t_lm(1000, 512, seed=3),
                                  synthetic_lm(1000, 512, seed=3))


def test_parse_churn_matches_reference():
    for spec in ("", "10:leave:1,15:join:1", "3:leave:0,3:leave:2,7:join:0"):
        assert t_train.parse_churn(spec) == j_train.parse_churn(spec)
    for bad in ("10:leave", "x:leave:1", "10:leave:1:2"):
        with pytest.raises(ValueError):
            j_train.parse_churn(bad)
        with pytest.raises(ValueError):
            t_train.parse_churn(bad)


ARGS = ["--arch", "qwen3-4b", "--reduced", "--steps", "6", "--batch", "8",
        "--seq", "32", "--optimizer", "sgd", "--churn", "2:leave:1,4:join:1",
        "--log-every", "1"]
STEP = re.compile(r"^step +(\d+) loss \S+ tokens (\d+) live (\d+) ")


def _lines(text):
    churn = [ln for ln in text.splitlines() if ": worker " in ln]
    steps = [STEP.match(ln).groups() for ln in text.splitlines()
             if STEP.match(ln)]
    return churn, steps


def test_main_matches_reference_and_closures_cross_load(tmp_path, capsys,
                                                         monkeypatch):
    jcfg = get_config("qwen3-4b").reduced()

    def jax_weights(cfg, *, seed=0, device="cuda"):
        jp = j_tf.init_params(jax.random.PRNGKey(seed), jcfg)
        return params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                               device=device)

    monkeypatch.setattr(t_train, "init_params", jax_weights)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    j_train.main(ARGS + ["--closure-out", jpath])
    j_out = capsys.readouterr().out
    assert t_train.main(ARGS + ["--closure-out", tpath,
                                "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert t_out.splitlines()[0] == "arch=qwen3-4b params=0.3M device=cpu"
    assert _lines(t_out) == _lines(j_out)
    assert _lines(t_out)[0] == ["step 2: worker 1 leaves (3/4 live)",
                                "step 4: worker 1 joins (4/4 live)"]
    assert [s[1:] for s in _lines(t_out)[1]] == \
        [("256", "4")] * 2 + [("192", "3")] * 2 + [("256", "4")] * 2
    # each package reads the other's closure
    j_by_t, t_by_j = ResearchClosure.load(jpath), JClosure.load(tpath)
    assert j_by_t.config == t_get_config("qwen3-4b").reduced()
    assert t_by_j.config == jcfg
    assert t_by_j.algorithm == j_by_t.algorithm == {
        "optimizer": "sgd", "lr": 0.1, "reduce": "weighted-mean",
        "steps": 6}
    assert t_by_j.step == j_by_t.step == 6
    for a, b in zip(t_by_j.metrics, j_by_t.metrics):
        assert a["step"] == b["step"] and abs(a["loss"] - b["loss"]) <= TOL
    want = dict(jax.tree_util.tree_flatten_with_path(j_by_t.params)[0])
    got = jax.tree_util.tree_flatten_with_path(t_by_j.params)[0]
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf, want[path], rtol=0, atol=TOL,
                                   err_msg=str(path))


def test_lr_defaults_per_path(tmp_path, monkeypatch, capsys):
    """``--lr`` defaults to None: the mesh path resolves it per optimizer
    (the closure records it), ``--simulate`` trains at 0.1 as before."""
    for opt, lr in (("adagrad", 0.05), ("adam", 3e-4), ("sgd", 0.1)):
        path = str(tmp_path / f"{opt}.json")
        assert t_train.main(["--arch", "qwen3-4b", "--reduced", "--steps",
                             "1", "--seq", "8", "--optimizer", opt,
                             "--closure-out", path, "--device", "cpu"]) == 0
        assert ResearchClosure.load(path).algorithm["lr"] == lr
    capsys.readouterr()
    sim = ["--simulate", "--reduced", "--steps", "2", "--device", "cpu"]
    assert t_train.main(sim) == 0
    default = capsys.readouterr().out
    assert t_train.main(sim + ["--lr", "0.1"]) == 0
    assert capsys.readouterr().out == default
    seen = {}
    monkeypatch.setattr(t_train, "run_simulated",
                        lambda cfg, **kw: seen.update(kw) or 0)
    assert t_train.main(sim) == 0 and seen["lr"] == 0.1


def test_quickstart_flow_on_cpu(tmp_path):
    """``examples/quickstart.py`` through the port: 30 AdaGrad steps of
    the reduced qwen3 with worker 2 leaving at 10 and rejoining at 20,
    a research closure saved and reloaded, 8 greedy tokens served from
    the reloaded params equal to those of the in-memory params."""
    cfg = t_get_config("qwen3-4b").reduced()
    opt = adagrad(lr=0.1)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=False),
        state=make_train_state(init_params(cfg, seed=0, device="cpu"), opt),
        n_workers=4, global_batch=8)
    toks = t_lm(100_000, vocab=cfg.vocab_size, seed=0)
    rng = np.random.RandomState(0)
    for i in range(30):
        if i == 10:
            eng.leave(2)
        if i == 20:
            eng.join(2)
        s = rng.randint(0, len(toks) - 65, size=8)
        eng.step({"tokens": np.stack([toks[j:j + 64] for j in s]),
                  "labels": np.stack([toks[j + 1:j + 65] for j in s])})
    h = eng.history
    assert [m["n_live"] for m in h] == [4] * 10 + [3] * 10 + [4] * 10
    assert {m["tokens"] for m in h[10:20]} == {384.0}
    assert all(np.isfinite(m["loss"]) for m in h)
    assert h[-1]["loss"] < h[0]["loss"]
    path = str(tmp_path / "quickstart.json")
    ResearchClosure(arch=cfg.name, config=cfg,
                    algorithm={"optimizer": "adagrad", "lr": 0.1,
                               "reduce": "weighted-mean"},
                    params=eng.state["params"], step=30).save(path)
    clo = ResearchClosure.load(path)
    assert clo.config == cfg
    for (p, a), (q, b) in zip(tree_paths(torchify(clo.params, "cpu")),
                              tree_paths(eng.state["params"])):
        assert p == q and torch.equal(a, b)
    prompt = toks[:32][None, :]
    out = serve_batch(torchify(clo.params, "cpu"), clo.config, prompt, gen=8)
    assert out.shape == (1, 8) and out.dtype == torch.int32
    assert torch.equal(out, serve_batch(eng.state["params"], cfg, prompt,
                                        gen=8))
