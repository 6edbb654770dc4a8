"""Port parity for checkpoints and research closures (``repro_torch``'s
``checkpoint/io.py`` and ``core/closure.py`` against ``repro``'s), on
the CPU at ``tiny_cfg()``:

  - a ``TrainState`` written by ``repro`` after 3 iterations resumes in
    the port, and the port's next 3 iterations equal ``repro``'s
    uninterrupted run in events, worker counts, vectors and wire bytes,
    loss within 1e-3 relative;
  - a ``TrainState`` written by the port resumes in ``repro`` the same
    way, and a closure (JSON + npz sidecar) written by the port loads in
    ``repro`` with the same bytes ``repro`` would write; a closure
    written by ``repro`` loads in the port;
  - the port's own snapshot and resume is bit-exact (losses, the flat
    buffer, AdaGrad state and residuals);
  - ``serving_params_from_train_state`` and the corrupt-file contract
    (``ValueError``; a missing file stays ``FileNotFoundError``).

The JAX side's initial weights reach the port with ``params_from_jax``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import io as j_io  # noqa: E402
from repro.core.closure import ResearchClosure as JClosure  # noqa: E402
from repro.launch.train_serve import build_training as j_build  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.core.closure import ResearchClosure, torchify  # noqa: E402
from repro_torch.core.flatbuf import tree_leaves, tree_paths  # noqa: E402
from repro_torch.launch.train_serve import build_training  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402

FIRST, MORE = 3, 3
ALGO = {"optimizer": "adagrad", "lr": 0.1, "T": 0.5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """``repro``'s run: a TrainState after FIRST iterations, the next MORE
    iterations' logs, its initial weights and a closure of them."""
    d = tmp_path_factory.mktemp("jax")
    cfg = j_tiny()
    loop, cluster, params = j_build(cfg, seed=0)
    loop.run(FIRST)
    state_path = str(d / "jax_state.npz")
    j_io.save_train_state(state_path, j_io.TrainState.capture(loop, cluster))
    flat = np.asarray(loop.reducer.flat_params)
    cont = loop.run(MORE)
    clo_path = str(d / "jax_closure.json")
    JClosure(arch=cfg.name, config=cfg, algorithm=ALGO, params=params,
             step=0).save(clo_path)
    return {"state": state_path, "cont": cont, "flat": flat,
            "closure": clo_path, "init": jax.tree.map(np.asarray, params)}


def _port_fleet(jax_side):
    cfg = tiny_cfg()
    return build_training(cfg, seed=0, device="cpu", init_params=params_from_jax(
        jax_side["init"], cfg, device="cpu"))


def _same_logs(a_logs, b_logs, exact=False):
    assert len(a_logs) == len(b_logs)
    for a, b in zip(a_logs, b_logs):
        assert (a.step, a.events, a.n_workers, a.vectors, a.wire_bytes,
                a.per_worker_wire_bytes, a.n_late, a.wall_time, a.deadline) \
            == (b.step, b.events, b.n_workers, b.vectors, b.wire_bytes,
                b.per_worker_wire_bytes, b.n_late, b.wall_time, b.deadline)
        if exact:
            assert a.loss == b.loss or (a.loss != a.loss and b.loss != b.loss)
        else:
            assert abs(a.loss - b.loss) <= 1e-3 * abs(a.loss)


def test_jax_train_state_resumes_in_port(jax_side):
    loop, cluster, template = _port_fleet(jax_side)
    state = io.load_train_state(jax_side["state"])
    state.restore(loop, cluster)
    assert loop.step == FIRST
    assert np.array_equal(loop.reducer.flat_params.numpy(), jax_side["flat"])
    params, step = io.serving_params_from_train_state(state, template)
    assert step == FIRST
    for (p, a), (q, b) in zip(tree_paths(params),
                              tree_paths(loop.reducer.params)):
        assert p == q and torch.equal(a, b)
    _same_logs(jax_side["cont"], loop.run(MORE))


def test_port_train_state_and_closure_load_in_repro(jax_side, tmp_path):
    loop, cluster, _ = _port_fleet(jax_side)
    loop.run(FIRST)
    path = str(tmp_path / "port_state")               # .npz is appended
    io.save_train_state(path, io.TrainState.capture(loop, cluster))
    cont = loop.run(MORE)
    jloop, jcluster, _ = j_build(j_tiny(), seed=0)
    j_io.load_train_state(path + ".npz").restore(jloop, jcluster)
    _same_logs(jloop.run(MORE), cont)
    # closure: the port's JSON is the bytes repro writes for the same
    # tree, and its npz sidecar reads back in repro
    clo = ResearchClosure(arch="train-serve-tiny", config=tiny_cfg(),
                          algorithm=ALGO, params=loop.reducer.params,
                          metrics=[{"loss": 1.5}], step=loop.step)
    host = _numpy_tree(loop.reducer.params)
    jclo = JClosure(arch="train-serve-tiny", config=j_tiny(),
                    algorithm=ALGO, params=host, metrics=[{"loss": 1.5}],
                    step=loop.step)
    for enc in ("b64", "listing"):
        assert clo.to_json(enc) == jclo.to_json(enc)
    assert clo.digest == jclo.digest
    cpath = str(tmp_path / "closure.json")
    io.save_closure(cpath, clo)
    back = j_io.load_closure(cpath)
    assert back.config == j_tiny() and back.step == loop.step
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(host)):
        assert np.array_equal(a, b)
    sidecar, header = j_io.load_npz(cpath + ".npz")
    assert header["meta"] == {"arch": "train-serve-tiny", "step": loop.step}
    for a, b in zip(jax.tree.leaves(sidecar), jax.tree.leaves(host)):
        assert np.array_equal(a, b)


def _numpy_tree(params):
    out = {}
    for path, x in tree_paths(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.numpy()
    return out


def test_jax_closure_loads_in_port(jax_side, tmp_path):
    clo = io.load_closure(jax_side["closure"])
    assert clo.config == tiny_cfg() and clo.algorithm == ALGO
    params = torchify(clo.params, device="cpu")
    want = params_from_jax(jax_side["init"], tiny_cfg(), device="cpu")
    for (p, a), (q, b) in zip(tree_paths(params), tree_paths(want)):
        assert p == q and torch.equal(a, b)
    # a child closure keeps the lineage, and a round trip through the
    # port's files is exact
    child = clo.child(params, step=5)
    assert child.parent == clo.digest
    path = str(tmp_path / "child.json")
    io.save_closure(path, child, npz_sidecar=False)
    again = io.load_closure(path)
    assert again.to_json() == child.to_json() and again.step == 5
    with open(path) as f:
        body = json.load(f)
    body["format"] = "something-else"
    with pytest.raises(ValueError, match="not a research closure"):
        ResearchClosure.from_json(json.dumps(body))


def test_port_snapshot_resume_is_bit_exact(tmp_path):
    cfg = tiny_cfg()
    loop, cluster, _ = build_training(cfg, seed=0, device="cpu")
    straight = loop.run(FIRST + MORE)
    a, ca, _ = build_training(cfg, seed=0, device="cpu")
    a.run(FIRST)
    path = str(tmp_path / "s.npz")
    io.save_train_state(path, io.TrainState.capture(a, ca))
    b, cb, _ = build_training(cfg, seed=0, device="cpu")
    io.load_train_state(path).restore(b, cb)
    _same_logs(straight[FIRST:], b.run(MORE), exact=True)
    ra, rb = loop.reducer, b.reducer
    assert torch.equal(ra.flat_params, rb.flat_params)
    for x, y in zip(tree_leaves(ra.opt_state), tree_leaves(rb.opt_state)):
        assert torch.equal(x, y)
    assert sorted(ra._residuals) == sorted(rb._residuals)
    for w in ra._residuals:
        assert torch.equal(ra._residuals[w], rb._residuals[w])


def test_params_npz_round_trip_and_cross_read(tmp_path):
    cfg = tiny_cfg()
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=3, device="cpu")
    path = str(tmp_path / "p.npz")
    io.save_npz(path, params, cfg=cfg, meta={"step": 7})
    tree, header = io.load_npz(path)
    jtree, jheader = j_io.load_npz(path)
    assert header == jheader and header["meta"] == {"step": 7}
    assert header["config"]["d_model"] == cfg.d_model
    for (p, x), (q, y), (_, z) in zip(tree_paths(params), tree_paths(tree),
                                      tree_paths(jtree)):
        assert p == q and np.array_equal(x.numpy(), y)
        assert np.array_equal(y, z)


def test_corrupt_files_and_mismatches_raise(tmp_path, jax_side):
    good = jax_side["state"]
    raw = open(good, "rb").read()
    trunc = tmp_path / "trunc.npz"
    trunc.write_bytes(raw[:len(raw) // 2])
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip at all")
    for p in (trunc, junk):
        with pytest.raises(ValueError, match="corrupt or truncated"):
            io.load_train_state(str(p))
        with pytest.raises(ValueError, match="corrupt or truncated"):
            io.load_npz(str(p))
    with pytest.raises(FileNotFoundError):
        io.load_train_state(str(tmp_path / "missing.npz"))
    state = io.load_train_state(good)
    wrong = io.TrainState(loop=state.loop, cluster=state.cluster, version=9)
    io.save_train_state(str(tmp_path / "v9.npz"), wrong)
    with pytest.raises(ValueError, match="unsupported TrainState version"):
        io.load_train_state(str(tmp_path / "v9.npz"))
    loop, cluster, template = _port_fleet(jax_side)
    with pytest.raises(ValueError, match="cluster mismatch"):
        state.restore(loop)
    with pytest.raises(TypeError, match="object array"):
        io.save_train_state(str(tmp_path / "o.npz"), io.TrainState(
            loop={"x": np.array([object()])}))
    two_tier = io.TrainState(loop={"regions": {}, "active": []})
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        io.serving_params_from_train_state(two_tier, template)
    # a dense (non-fused) reducer's leaf list maps onto the template
    leaves = [x.numpy() * 2 for x in tree_leaves(template)]
    dense = io.TrainState(loop={"step": 2, "reducer": {
        "fused": False, "param_leaves": leaves}})
    params, step = io.serving_params_from_train_state(dense, template)
    assert step == 2
    for x, y in zip(tree_leaves(params), leaves):
        assert np.array_equal(x.numpy(), y)
    with pytest.raises(ValueError, match="wrong architecture"):
        io.serving_params_from_train_state(io.TrainState(loop={
            "step": 2, "reducer": {"fused": False,
                                   "param_leaves": leaves[:-1]}}), template)
