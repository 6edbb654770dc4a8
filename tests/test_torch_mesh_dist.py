"""The sharded elastic mesh engine on 4-rank gloo worlds (the port of
``tests/test_multidevice.py::test_elastic_mesh_engine_trains_under_churn``):
``ElasticMeshSGD(jit_kwargs=dict(in_shardings=..., out_shardings=...))``
with ``to_shardings(param_specs(state, cfg, mesh, "train"), mesh)`` on a
(data 2, model 2) and a (data 4, model 1) mesh, spawned through
``distributed/world.py`` (rendezvous through ``file://`` under the test's
temporary directory). On (data 2, model 2) the step splits its compute
over ``model`` (heads, FF, vocab, experts; ``tensor_parallel``).

``qwen3-4b.reduced()`` (4 query heads, 1 KV head: replicated KV and the
partial ``q_norm`` / ``k_norm`` gradients), B 8, S 16, 4 virtual
workers, sgd lr 0.1: 3 steps, leave(2), 2 steps, join(2), a step; the
same for ``llama4-scout-17b-a16e.reduced()`` (MoE under a split batch:
the load-balance loss global over the batch axes, the experts split
over ``model``) with each MoE impl on both meshes, and for
``mamba2-780m.reduced()`` and ``zamba2-7b.reduced()`` (their Mamba2
blocks split over ``model``) on (data 2, model 2); then one step of one
reduced config per other family, and one ``remat`` step, on (data 2,
model 2). Rank 0's metrics and the gathered params are held against the
reference's single-device ``ElasticMeshSGD`` on the same JAX-drawn
weights (``params_from_jax``) and against the port's own single-device
engine: losses within 1e-5 relative, tokens and ``n_live`` exact, aux
within 1e-5, params within 1e-5 absolute (sgd). Every rank reports the
same metrics; the dry-run's per-rank stored bytes and collective bytes
for the mesh equal the run's counters, step by step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.mesh_engine import ElasticMeshSGD as JEngine  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from repro.train.step import make_train_state as j_state  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core.flatbuf import tree_map, tree_paths  # noqa: E402
from repro_torch.core.mesh_engine import ElasticMeshSGD  # noqa: E402
from repro_torch.distributed.sharded_step import \
    ShardedTrainStep  # noqa: E402
from repro_torch.distributed.sharding import (P, NamedSharding,  # noqa: E402
                                              param_specs, to_shardings)
from repro_torch.distributed.world import (mesh_sgd_program,  # noqa: E402
                                           same_everywhere, spawn_world)
from repro_torch.launch.dryrun import batch_shardings, run_dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                    make_train_state)

TOL = 1e-5
B, S, WORKERS = 8, 16, 4
CHURN = {3: [("leave", 2)], 5: [("join", 2)]}
STEPS = 6
# one reduced config per non-MoE family besides qwen3-4b's dense
FAMILIES = ["mamba2-780m", "zamba2-7b", "paligemma-3b", "whisper-large-v3"]
FB, FS = 4, 8
MOE = "llama4-scout-17b-a16e"
IMPLS = ["einsum", "sort"]
# the Mamba2 families under churn on (data 2, model 2), their blocks split
# over ``model`` (8 heads, 4 a rank)
SSM_CHURN = ["mamba2-780m", "zamba2-7b"]


def _batch(cfg, Bn, Sn, seed):
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (Bn, Sn)).astype(np.int32),
           "labels": rs.randint(0, cfg.vocab_size, (Bn, Sn)).astype(np.int32)}
    extra = {"vlm": ("prefix", cfg.n_prefix_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    if extra:
        name, n = extra
        out[name] = (rs.standard_normal((Bn, n, cfg.d_model)) * 0.02
                     ).astype(np.float32)
    return out


def _impl(cfg, impl):
    if impl is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


def _single(name, batches, steps, churn, Bn, impl=None):
    """The reference's and the port's single-device engines on the same
    JAX-drawn weights: (jax metrics, port metrics, jax params, port
    params, the weights as the port's tree). ``impl``: an MoE impl."""
    jcfg = _impl(j_get_config(name).reduced(), impl)
    tcfg = _impl(get_config(name).reduced(), impl)
    jp = jax.tree.map(np.asarray, j_tf.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = params_from_jax(jp, tcfg, device="cpu")
    je = JEngine(train_step=j_build(jcfg, j_sgd(lr=0.1), remat=False),
                 state=j_state(jp, j_sgd(lr=0.1)), n_workers=WORKERS,
                 global_batch=Bn)
    te = ElasticMeshSGD(train_step=build_train_step(tcfg, sgd(lr=0.1),
                                                    remat=False),
                        state=make_train_state(tp, sgd(lr=0.1)),
                        n_workers=WORKERS, global_batch=Bn)
    for i in range(steps):
        for kind, w in churn.get(i, []):
            getattr(je, kind)(w)
            getattr(te, kind)(w)
        b = batches[i % len(batches)]
        je.step({k: jnp.asarray(v) for k, v in b.items()})
        te.step(b)
    return (je.history, te.history, je.state["params"], te.state["params"],
            tree_map(lambda x: x.detach().clone(), tp))


def _metrics_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["tokens"] == b["tokens"] and a["n_live"] == b["n_live"]
        for k in ("loss", "total_loss"):
            assert abs(a[k] - b[k]) <= TOL * abs(b[k]), (k, a[k], b[k])
        assert abs(a["aux_loss"] - b["aux_loss"]) <= TOL


def _port_flat(tree):
    return {p: x.detach().double().numpy() for p, x in tree_paths(tree)}


def _jax_flat(tree):
    return {tuple(str(k.key) for k in p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _params_close(got, want):
    """Two {path: array} dicts: same paths, every leaf within TOL."""
    assert list(got) == list(want)
    for path in got:
        d = float(np.abs(got[path] - want[path]).max())
        assert d <= TOL, (path, d)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both meshes' worlds and the single-device runs they are held to."""
    tmp = tmp_path_factory.mktemp("meshdist")
    qb = [_batch(get_config("qwen3-4b").reduced(), B, S, seed=1)]
    single = {"qwen3-4b": _single("qwen3-4b", qb, STEPS, CHURN, B)}
    runs22 = [{"arch": "qwen3-4b", "batches": qb, "batch": B, "seq": S,
               "steps": STEPS, "churn": CHURN,
               "params": str(tmp / "qwen3-4b.pt"),
               "gather": str(tmp / "g22-qwen3-4b.pt")}]
    torch.save(single["qwen3-4b"][4], tmp / "qwen3-4b.pt")
    mb = [_batch(get_config(MOE).reduced(), B, S, seed=3)]
    moe_runs = []
    for impl in IMPLS:
        single[impl] = _single(MOE, mb, STEPS, CHURN, B, impl)
        torch.save(single[impl][4], tmp / f"{impl}.pt")
        moe_runs.append({"arch": MOE, "moe_impl": impl, "batches": mb,
                         "batch": B, "seq": S, "steps": STEPS,
                         "churn": CHURN, "params": str(tmp / f"{impl}.pt"),
                         "gather": f"{impl}.pt"})
    for name in FAMILIES:
        fb = [_batch(get_config(name).reduced(), FB, FS, seed=7)]
        single[name] = _single(name, fb, 1, {}, FB)
        torch.save(single[name][4], tmp / f"{name}.pt")
        runs22.append({"arch": name, "batches": fb, "batch": FB, "seq": FS,
                       "steps": 1, "params": str(tmp / f"{name}.pt"),
                       "gather": str(tmp / f"g22-{name}.pt")})
    # one step under remat: each block's forward collectives run twice
    runs22.append(dict(runs22[0], steps=1, churn={}, remat=True,
                       gather=None))
    ssm_runs = []
    for name in SSM_CHURN:
        sb = [_batch(get_config(name).reduced(), B, S, seed=5)]
        single[f"churn-{name}"] = _single(name, sb, STEPS, CHURN, B)
        torch.save(single[f"churn-{name}"][4], tmp / f"churn-{name}.pt")
        ssm_runs.append({"arch": name, "batches": sb, "batch": B, "seq": S,
                         "steps": STEPS, "churn": CHURN,
                         "params": str(tmp / f"churn-{name}.pt"),
                         "gather": str(tmp / f"g22-churn-{name}.pt")})
    common = {"reduced": True, "n_workers": WORKERS,
              "optimizer": ("sgd", {"lr": 0.1})}
    out = {"single": single, "tmp": tmp, "batches": qb}
    out[(2, 2)] = spawn_world(mesh_sgd_program, 4, {
        **common, "mesh": ((2, 2), ("data", "model")),
        "runs": runs22 + [dict(r, gather=str(tmp / f"g22-{r['gather']}"))
                          for r in moe_runs] + ssm_runs},
        str(tmp / "w22"), device="cpu")
    out[(4, 1)] = spawn_world(mesh_sgd_program, 4, {
        **common, "mesh": ((4, 1), ("data", "model")),
        "runs": [dict(runs22[0], gather=str(tmp / "g41-qwen3-4b.pt"))]
        + [dict(r, gather=str(tmp / f"g41-{r['gather']}"))
           for r in moe_runs]},
        str(tmp / "w41"), device="cpu")
    return out


def _runs(dims):
    """(name, MoE impl, rows, seq, remat) of each run of a mesh's world,
    in order."""
    out = [("qwen3-4b", None, B, S, False)]
    if dims == (2, 2):
        out += [(n, None, FB, FS, False) for n in FAMILIES]
        out.append(("qwen3-4b", None, B, S, True))
    out += [(MOE, impl, B, S, False) for impl in IMPLS]
    if dims == (2, 2):
        out += [(n, None, B, S, False) for n in SSM_CHURN]
    return out


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)], ids=["data2-model2",
                                                        "data4"])
def test_sharded_engine_under_churn_matches_single_device(worlds, dims):
    jm, tm, jp, tp, _ = worlds["single"]["qwen3-4b"]
    res = worlds[dims]
    assert same_everywhere(res)
    hist = res[0]["runs"][0]["history"]
    assert [h["n_live"] for h in hist] == [4, 4, 4, 3, 3, 4]
    assert [h["tokens"] for h in hist] == [128.0] * 3 + [96.0] * 2 + [128.0]
    assert hist[-1]["loss"] < hist[0]["loss"]
    _metrics_close(hist, jm)
    _metrics_close(hist, tm)
    tag = "g22" if dims == (2, 2) else "g41"
    got = _port_flat(torch.load(worlds["tmp"] / f"{tag}-qwen3-4b.pt"))
    _params_close(got, _jax_flat(jp))
    _params_close(got, _port_flat(tp))


@pytest.mark.parametrize("name", FAMILIES)
def test_one_sharded_step_per_family(worlds, name):
    jm, tm, jp, tp, _ = worlds["single"][name]
    i = 1 + FAMILIES.index(name)
    res = worlds[(2, 2)]
    hist = res[0]["runs"][i]["history"]
    assert all(r["runs"][i]["history"] == hist for r in res)
    _metrics_close(hist, jm)
    _metrics_close(hist, tm)
    got = _port_flat(torch.load(worlds["tmp"] / f"g22-{name}.pt"))
    _params_close(got, _jax_flat(jp))
    _params_close(got, _port_flat(tp))


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)], ids=["data2-model2",
                                                        "data4"])
def test_dryrun_bytes_equal_the_run_counters(worlds, dims):
    """Per rank and per step: the stored bytes and the wire bytes by op
    equal ``run_dryrun``'s for the same config, mesh, shape and
    optimizer."""
    mesh = Mesh(dims, ("data", "model"))
    for i, (name, impl, Bn, Sn, remat) in enumerate(_runs(dims)):
        dr = run_dryrun(_impl(get_config(name).reduced(), impl),
                        InputShape("mesh-dist", Sn, Bn, "train"), mesh=mesh,
                        optimizer_name="sgd", remat=remat)
        for r in worlds[dims]:
            run = r["runs"][i]
            assert run["stored_bytes"] == dr["memory"]["state_bytes"], name
            assert all(w == dr["collectives"] for w in run["wire_bytes"]), \
                (name, run["wire_bytes"][0], dr["collectives"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dims", [(2, 2), (4, 1)], ids=["data2-model2",
                                                        "data4"])
def test_moe_under_a_split_batch_matches_single_device(worlds, dims, impl):
    """MoE under a batch split over more than one rank, under churn:
    the load-balance loss is global over the batch axes (every rank
    reports the reference's), the experts split over ``model`` on (data
    2, model 2)."""
    jm, tm, jp, tp, _ = worlds["single"][impl]
    res = worlds[dims]
    i = [r[:2] for r in _runs(dims)].index((MOE, impl))
    hist = res[0]["runs"][i]["history"]
    assert all(r["runs"][i]["history"] == hist for r in res)
    assert [h["n_live"] for h in hist] == [4, 4, 4, 3, 3, 4]
    assert all(h["aux_loss"] > 0 for h in hist)
    _metrics_close(hist, jm)
    _metrics_close(hist, tm)
    tag = "g22" if dims == (2, 2) else "g41"
    got = _port_flat(torch.load(worlds["tmp"] / f"{tag}-{impl}.pt"))
    _params_close(got, _jax_flat(jp))
    _params_close(got, _port_flat(tp))


@pytest.mark.parametrize("name", SSM_CHURN)
def test_ssm_blocks_split_under_churn_match_single_device(worlds, name):
    """The Mamba2 families on (data 2, model 2) under churn, each block
    computing its rank's heads: metrics within 1e-5 of both packages'
    single-device engines, every rank reporting the same, and the
    gathered params within 1e-5 of the port's single-device engine's.

    The params are not held to the reference's here: at lr 0.1 the
    reduced ``mamba2-780m`` reaches a point, at its fifth step, where a
    6e-7 difference in the params moves the tied embedding's gradient by
    1.1e-4, so the two packages' single-device engines themselves part by
    1.2e-5 on it after six steps (on the same gradients, computed at one
    point, they agree within 2e-6 relative). The one-step runs of
    ``test_one_sharded_step_per_family`` hold the sharded params to the
    reference's."""
    jm, tm, _, tp, _ = worlds["single"][f"churn-{name}"]
    res = worlds[(2, 2)]
    i = [r[0] for r in _runs((2, 2))].index(name, 1 + len(FAMILIES))
    hist = res[0]["runs"][i]["history"]
    assert all(r["runs"][i]["history"] == hist for r in res)
    assert [h["n_live"] for h in hist] == [4, 4, 4, 3, 3, 4]
    assert hist[-1]["loss"] < hist[0]["loss"]
    _metrics_close(hist, jm)
    _metrics_close(hist, tm)
    got = _port_flat(torch.load(worlds["tmp"] / f"g22-churn-{name}.pt"))
    _params_close(got, _port_flat(tp))


def test_remat_step_matches_and_runs_forward_collectives_twice(worlds):
    """A ``remat`` step on (data 2, model 2): the first step's metrics of
    the run without it, and (in the dry-run test) each block's forward
    collectives counted twice."""
    runs = worlds[(2, 2)][0]["runs"]
    plain, remat = runs[0], runs[1 + len(FAMILIES)]
    _metrics_close(remat["history"], plain["history"][:1])
    extra = remat["wire_bytes"][0]["all-reduce"] \
        - plain["wire_bytes"][0]["all-reduce"]
    # qwen3-4b.reduced(): 2 layers x (attention + MLP) reduces of
    # (B/2, S, d) f32, each 2B on the wire
    assert extra == 2 * 2 * 2 * 4 * (B // 2) * S * 128


def test_batch_shardings_choose_each_ranks_rows():
    """The batch's rows follow ``in_shardings[1]``: None takes the mesh's
    ``batch_spec``, a tree takes its tokens' first entry (the dry-run's
    ``batch_shardings``), one ``NamedSharding`` its own."""
    cfg = get_config("qwen3-4b").reduced()
    opt = sgd(lr=0.1)
    state = make_train_state(init_params(cfg, device="cpu"), opt)
    mesh = make_host_mesh(2, 2)
    sh = to_shardings(param_specs(state, cfg, mesh, "train"), mesh)
    step = build_train_step(cfg, opt)
    batch = {k: torch.zeros(8, 16, dtype=torch.int32)
             for k in ("tokens", "labels")}

    def entry(bsh, gb=8):
        return ShardedTrainStep.from_shardings(step, sh, bsh, gb).batch_entry
    assert entry(None) == "data" and entry(None, gb=1) is None
    assert entry(batch_shardings(batch, mesh, 8)) == "data"
    assert entry(NamedSharding(mesh, P(None, None))) is None


def test_unknown_jit_kwargs_key_raises():
    cfg = get_config("qwen3-4b").reduced()
    opt = sgd(lr=0.1)
    with pytest.raises(TypeError, match="keep_unused"):
        ElasticMeshSGD(train_step=build_train_step(cfg, opt),
                       state={"params": {"w": torch.zeros(2)}, "opt": {}},
                       n_workers=4, global_batch=8,
                       jit_kwargs={"in_shardings": None,
                                   "keep_unused": True})
