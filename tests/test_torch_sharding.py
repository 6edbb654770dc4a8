"""Port parity for the sharding rules, the input shapes and specs, and the
dry-runs: ``repro_torch.distributed.sharding`` against
``repro.distributed.sharding`` on ``AbstractMesh(sizes, names)`` (no
devices on either side), leaf by leaf at full width.

The grid: the 11 transformer configs (``mlitb-lm-100m`` and the 10
assigned; the conv net has no such tree), the meshes (16, 16),
(2, 16, 16), (4, 2) and (2, 2), ``train`` and ``serve``, and each layout
feature alone and ``fsdp_remap,serve_fsdp,cache_seqshard``. Specs compare
as tuples of entries after jax 0.9's normalization (a one-axis tuple is
the axis name, an empty tuple ``None``), which the port's ``P`` applies
too. Shapes and dtypes compare exactly.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.configs.all_configs import ASSIGNED_ARCHS  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import adagrad as j_adagrad  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as t_shapes  # noqa: E402
from repro_torch.core.flatbuf import tree_paths  # noqa: E402
from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.launch import dryrun, dryrun_all  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.train.step import make_train_state  # noqa: E402

ARCHS = ["mlitb-lm-100m"] + list(ASSIGNED_ARCHS)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 2), ("data", "model"))]
LAYOUTS = ["baseline", "fsdp_remap", "serve_fsdp", "cache_seqshard",
           "moe_sort", "ssm_no_tp", "fsdp_remap,serve_fsdp,cache_seqshard"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _jspec(s):
    return tuple(_entry(e) for e in s)


def _jleaves(tree, is_leaf=None):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out.append((tuple(str(k.key) for k in path), leaf))
    return out


def _jspecs(tree):
    return [(p, _jspec(s)) for p, s in
            _jleaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _tspecs(tree):
    return [(p, tuple(s)) for p, s in tree_paths(tree)]


def _dt(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


@pytest.fixture(scope="module")
def trees():
    """Both packages' full-width abstract params, per arch."""
    return {a: (j_tf.abstract_params(j_get_config(a)),
                t_tf.abstract_params(get_config(a))) for a in ARCHS}


def test_abstract_trees_agree(trees):
    for a, (jt, tt) in trees.items():
        jl, tl = _jleaves(jt), list(tree_paths(tt))
        assert [p for p, _ in jl] == [p for p, _ in tl], a
        for (p, x), (_, y) in zip(jl, tl):
            assert tuple(x.shape) == tuple(y.shape) and _dt(x) == _dt(y), \
                (a, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_full_grid(arch, trees):
    """Every leaf's spec equals the reference's over meshes x modes x
    layouts (11 configs x 4 x 2 x 7)."""
    jt, tt = trees[arch]
    jc, tc = j_get_config(arch), get_config(arch)
    for dims, names in MESHES:
        jm, tm = AbstractMesh(dims, names), Mesh(dims, names)
        for mode in ("train", "serve"):
            for lay in LAYOUTS:
                jl, tl = j_sh.parse_layout(lay), t_sh.parse_layout(lay)
                assert jl == tl
                want = _jspecs(j_sh.param_specs(jt, jc, jm, mode, jl))
                got = _tspecs(t_sh.param_specs(tt, tc, tm, mode, tl))
                assert got == want, (arch, dims, mode, lay)


@pytest.mark.parametrize("arch", ["mlitb-lm-100m", "qwen3-4b",
                                  "llama4-scout-17b-a16e", "zamba2-7b"])
def test_train_state_specs_match_reference(arch, trees):
    """The optimizer state inherits the params' placement, as in the
    reference (AdaGrad: ``accum`` and ``step``)."""
    jt, tt = trees[arch]
    jc, tc = j_get_config(arch), get_config(arch)
    jopt = j_adagrad()
    jstate = {"params": jt, "opt": jax.eval_shape(jopt.init, jt)}
    tstate = make_train_state(tt, adagrad())
    for dims, names in MESHES:
        want = _jspecs(j_sh.param_specs(jstate, jc, AbstractMesh(dims, names),
                                        "train"))
        got = _tspecs(t_sh.param_specs(tstate, tc, Mesh(dims, names),
                                       "train"))
        assert got == want, (arch, dims)


def test_batch_specs_match_reference():
    for dims, names in MESHES:
        jm, tm = AbstractMesh(dims, names), Mesh(dims, names)
        for lay in ("baseline", "fsdp_remap"):
            jl, tl = j_sh.parse_layout(lay), t_sh.parse_layout(lay)
            for B in (1, 2, 3, 8, 32, 128, 256, 512):
                js, ts = j_sh.batch_spec(jm, B, jl), t_sh.batch_spec(tm, B, tl)
                assert tuple(ts) == _jspec(js), (dims, lay, B)
                assert t_sh.batch_axis(ts) == _entry(j_sh.batch_axis(js))
        for B in (1, 8, 256):
            want = {k: _jspec(v)
                    for k, v in j_sh.train_batch_specs(jm, B).items()}
            got = {k: tuple(v)
                   for k, v in t_sh.train_batch_specs(tm, B).items()}
            assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_on_meta_and_cache_specs_match_reference(arch):
    """``init_decode_cache(.., device="meta")``: the reference's
    ``abstract=True`` cache leaf for leaf (shape, dtype), for a batched
    and a batch-1 long cache; its specs equal the reference's over the
    meshes and the cache layouts."""
    jc, tc = j_get_config(arch), get_config(arch)
    for B, S in ((128, 32768), (1, 8192)):
        jcache = j_tf.init_decode_cache(jc, B, S, abstract=True)
        tcache = t_tf.init_decode_cache(tc, B, S, device="meta")
        jl, tl = _jleaves(jcache), list(tree_paths(tcache))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (p, x), (_, y) in zip(jl, tl):
            assert y.device.type == "meta"
            assert tuple(x.shape) == tuple(y.shape) and _dt(x) == _dt(y), p
        for dims, names in MESHES:
            jm, tm = AbstractMesh(dims, names), Mesh(dims, names)
            for lay in ("baseline", "cache_seqshard",
                        "fsdp_remap,serve_fsdp,cache_seqshard"):
                want = _jspecs(j_sh.cache_specs(jcache, jc, jm, B,
                                                j_sh.parse_layout(lay)))
                got = _tspecs(t_sh.cache_specs(tcache, tc, tm, B,
                                               t_sh.parse_layout(lay)))
                assert got == want, (arch, B, dims, lay)


def test_sanitize_drops_nondivisible():
    """``tests/test_sharding.py``'s cases, on the port's meshes."""
    mesh = make_production_mesh()
    mesh3 = make_production_mesh(multi_pod=True)
    P = t_sh.P
    assert t_sh.sanitize_spec(P("model", None), (51866, 1280), mesh) == \
        P(None, None)
    assert t_sh.sanitize_spec(P("model", None), (51872, 1280), mesh) == \
        P("model", None)
    assert t_sh.sanitize_spec(P(None, ("pod", "data"), "model"),
                              (48, 64, 256), mesh3) == \
        P(None, ("pod", "data"), "model")
    assert t_sh.sanitize_spec(P(None, ("pod", "data")), (48, 40), mesh3) == \
        P(None, None)
    assert P(("data",)) == P("data") and P(()) == P(None)


def test_local_shape_and_slice():
    """A rank's shard is each sharded dim over the product of its axes'
    sizes; the ranks' slices, put back by chunk index, give the tensor."""
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    P = t_sh.P
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in (P(("pod", "data"), None, "model"), P(None, "data"),
                 P("model", None, ("pod", "data")), P()):
        want = tuple(n // mesh.axes_size(spec[i] if i < len(spec) else None)
                     for i, n in enumerate(x.shape))
        assert t_sh.local_shape(x.shape, spec, mesh) == want
        back = torch.zeros_like(x)
        seen = set()
        for r in range(mesh.size):
            part = t_sh.local_slice(x, spec, mesh, r)
            assert tuple(part.shape) == want and part.is_contiguous()
            idx = tuple(
                slice(mesh.chunk_index(spec[i], r) * want[i],
                      (mesh.chunk_index(spec[i], r) + 1) * want[i])
                if i < len(spec) and spec[i] is not None else slice(None)
                for i in range(x.dim()))
            back[idx] = part
            seen.add(tuple((s.start, s.stop) for s in idx))
        assert torch.equal(back, x), spec
    with pytest.raises(ValueError, match="does not split"):
        t_sh.local_shape((6, 4), P("data", "model"), Mesh((4, 2),
                                                         ("data", "model")))


def test_mesh_coordinates_follow_jax_device_order():
    """Rank r sits where ``jax.make_mesh`` puts device r (row-major)."""
    for dims, names in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = Mesh(dims, names)
        grid = np.arange(mesh.size).reshape(dims)
        for r in range(mesh.size):
            c = mesh.coords(r)
            assert grid[tuple(c[a] for a in names)] == r
    assert make_host_mesh(4, 2).shape == {"data": 4, "model": 2}
    assert make_host_mesh(2, 2, 2).axis_names == ("pod", "data", "model")


def test_shapes_and_input_specs_match_reference():
    assert {k: vars(v) for k, v in t_shapes.SHAPE_REGISTRY.items()} == \
        {k: vars(v) for k, v in j_shapes.SHAPE_REGISTRY.items()}
    for arch in ARCHS:
        jc, tc = j_get_config(arch), get_config(arch)
        for name in SHAPES:
            js, ts = j_shapes.get_shape(name), t_shapes.get_shape(name)
            assert t_specs.supports(tc, ts) == j_specs.supports(jc, js)
            assert t_specs.effective_config(tc, ts).sliding_window == \
                j_specs.effective_config(jc, js).sliding_window
            want = _jleaves(j_specs.input_specs(jc, js))
            got = list(tree_paths(t_specs.input_specs(tc, ts)))
            assert [p for p, _ in got] == [p for p, _ in want], (arch, name)
            for (p, x), (_, y) in zip(want, got):
                assert y.device.type == "meta"
                assert tuple(x.shape) == tuple(y.shape), (arch, name, p)
                assert _dt(x) == _dt(y), (arch, name, p)


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512
    host devices for its own process; the flag is put back at once, so
    neither this process's JAX nor a later subprocess sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return j_dryrun


def test_probe_config_and_full_units_match_reference():
    j_dryrun = _reference_dryrun()
    for arch in ARCHS:
        for name in SHAPES:
            jc = j_specs.effective_config(j_get_config(arch),
                                          j_shapes.get_shape(name))
            tc = t_specs.effective_config(get_config(arch),
                                          t_shapes.get_shape(name))
            assert dryrun.full_units(tc) == j_dryrun.full_units(jc)
            for u in (1, 2):
                assert dataclasses.asdict(dryrun.probe_config(tc, u)) == \
                    dataclasses.asdict(j_dryrun.probe_config(jc, u))


def test_dryrun_all_rows_and_skips_match_reference(tmp_path):
    """``dryrun_all --all``: one row per (arch, shape, mesh) the
    reference supports, one skip row where it does not; a second run
    resumes past every row."""
    out = tmp_path / "r.jsonl"
    assert dryrun_all.main(["--all", "--out", str(out)]) == 0
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    want = set()
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            ok, _ = j_specs.supports(j_get_config(arch),
                                     j_shapes.get_shape(name))
            tags = ("1pod-256", "2pod-512") if ok else ("skip",)
            want |= {(arch, name, t) for t in tags}
    got = {(r["arch"], r["shape"],
            "skip" if r.get("skipped") else r["mesh_tag"]) for r in rows}
    assert got == want and len(rows) == len(want)
    for r in rows:
        if r.get("skipped"):
            continue
        n = 512 if r["mesh_tag"] == "2pod-512" else 256
        assert r["n_chips"] == n and r["memory"]["argument_bytes"] > 0
        assert r["collective_bytes_per_chip"] == sum(
            r["collectives"].values())
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    assert dryrun_all.main(["--all", "--out", str(out)]) == 0
    assert len(out.read_text().splitlines()) == len(rows)


def test_dryrun_cli_reports_per_rank_bytes(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--mesh", "2,2", "--json",
                        str(tmp_path / "d.jsonl")]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["axes"] == ["data", "model"] and r["mesh"] == "2x2"
    # AdaGrad's state over (data 2, model 2): every large dim splits
    cfg = get_config("qwen3-4b")
    full = sum(x.numel() * x.element_size() for _, x in tree_paths(
        make_train_state(t_tf.abstract_params(cfg), adagrad())))
    assert full / 4 <= r["memory"]["state_bytes"] < full / 2
    assert set(r["collectives"]) == {"all-gather", "all-reduce"}
    assert (tmp_path / "d.jsonl").read_text().strip() == json.dumps(r)



def test_dryrun_useful_flops_ratio_follows_the_split_blocks():
    """At (data 16, model 16) a train step's work per rank is divided by
    16 where its block splits over ``model``: near 1 for ``qwen3-4b``
    (heads, FF and vocab split; its 8 replicated KV heads are read 1 per
    rank); ``mlitb-lm-100m``'s 12 heads do not split over 16, so its
    attention stays replicated (0.26), and over (data 16, model 4) all
    of it splits. The Mamba2 blocks split their heads (48 and 112 over
    16): each rank reads 1/16 of ``out_proj``, ``gate_norm`` and the
    per-head leaves, its heads' columns of ``in_proj`` and the conv with
    B and C whole; ``mamba2-780m``'s 50 280-row tied vocab does not split
    over 16, which holds it at 0.3508, and ``zamba2-7b`` reaches 0.9454.
    Under the ``ssm_no_tp`` layout the SSM leaves are replicated over
    ``model`` and both fall back to 1/16 and 0.0935."""
    def ratio(arch, mesh=None, layout="baseline"):
        return dryrun.run_dryrun(arch, "train_4k", mesh=mesh,
                                 layout=layout)["useful_flops_ratio"]
    assert ratio("qwen3-4b") > 0.9
    assert ratio("mlitb-lm-100m", Mesh((16, 4), ("data", "model"))) > 0.9
    assert 0.25 < ratio("mlitb-lm-100m") < 0.3
    assert ratio("mamba2-780m") == pytest.approx(0.35082328652208283,
                                                 rel=1e-9)
    assert ratio("zamba2-7b") == pytest.approx(0.9454116593740827, rel=1e-9)
    assert ratio("mamba2-780m", layout="ssm_no_tp") == pytest.approx(
        1 / 16, rel=1e-12)
    assert ratio("zamba2-7b", layout="ssm_no_tp") == pytest.approx(
        0.09349770013562368, rel=1e-9)


def test_dryrun_takes_moe_under_a_batch_split():
    """MoE train rows report: the router's statistics all-reduce per
    block, the experts split over ``model``."""
    r = dryrun.run_dryrun("llama4-scout-17b-a16e", "train_4k",
                          mesh=make_host_mesh(2, 2))
    assert "refused" not in r and r["batch_split"] == 2
    assert r["useful_flops_ratio"] > 0.5
    plain = dryrun.run_dryrun("llama4-scout-17b-a16e", "train_4k",
                              mesh=make_host_mesh(2, 2), remat=False)
    # under remat each block's forward collectives run twice: per layer
    # the attention's, the experts' and the shared expert's reduces of
    # (B/2, S, d) and the router's statistics (2E + 1 entries), all f32,
    # 2B each
    cfg = get_config("llama4-scout-17b-a16e")
    per_layer = 2 * 4 * (3 * 128 * 4096 * cfg.d_model
                         + 2 * cfg.moe.n_experts + 1)
    assert r["collectives"]["all-reduce"] - plain["collectives"][
        "all-reduce"] == cfg.n_layers * per_layer
    assert r["collectives"]["all-gather"] == plain["collectives"][
        "all-gather"]


def test_dryrun_gathers_split_leaves_over_data_only():
    """``mlitb-lm-100m`` on (data 2, model 2), 8 x 256, sgd, no remat:
    every leaf but the 19 200 norm entries splits over ``model`` for
    compute, so a rank gathers half of each over ``data`` (PR 23's step
    gathered every leaf whole: 603 979 776 bytes) and all-reduces half
    of each gradient, plus 50 activation all-reduces of (4, 256, 768)
    f32, the cross-entropy's three of (4, 256) and the (sum, count)."""
    r = dryrun.run_dryrun(
        "mlitb-lm-100m", t_shapes.InputShape("mesh-dist", 256, 8, "train"),
        mesh=make_host_mesh(2, 2), optimizer_name="sgd", remat=False)
    split = 100_682_496 - 19_200
    assert r["collectives"]["all-gather"] == 4 * split // 2 == 201_326_592
    grads = 2 * 4 * (split // 2 + 19_200)
    acts = 50 * 2 * 4 * 4 * 256 * 768 + 3 * 2 * 4 * 4 * 256 + 2 * 4 * 2
    assert r["collectives"]["all-reduce"] == grads + acts
