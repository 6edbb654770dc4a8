"""``repro_torch.distributed.tensor_parallel`` in one 2-rank gloo world
on the CPU (``distributed/world.py`` ``tensor_parallel_program``), held
against the plain single-rank functions on the gathered tensors.

The reference has no such module (GSPMD splits the work under
``jit``), so the reference here is the port's own unsplit code, which
``tests/test_torch_mesh_train.py`` and the other port tests hold against
``repro``: Megatron's ``copy_to_model`` / ``reduce_from_model`` forward
and backward; ``vocab_parallel_embed`` and ``vocab_parallel_xent`` (the
latter through ``layers.softmax_xent``'s hand-off) against
``layers.embed`` / ``softmax_xent``, with masked, all-masked and no
masks; the column / row-parallel MLP (gated, and plain with biases);
attention with sharded KV heads, with replicated KV heads read by a
group of local query heads (and ``q_norm`` / ``k_norm``), and with
replicated KV heads read one per local query head; a Mamba2 block split
over its heads (``sum_over_model`` under its gated norm) and one whose
heads do not divide, computed whole. Values and gradients
within 1e-6 of max(1, their largest magnitude): a split leaf's gradient
is the rank's part of the full one, a replicated leaf's the full one
(summed over ranks where the rank holds only its heads' share), the
input's the full one on every rank. Outside a context every function
is the identity.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.world import (spawn_world,  # noqa: E402
                                           tensor_parallel_program)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402

TOL = 1e-6
WORLD = 2
V, D, FF, B, S = 16, 8, 12, 2, 5


def _rand(rs, *shape, scale=1.0):
    return torch.as_tensor(rs.standard_normal(shape) * scale,
                           dtype=torch.float32)


def _cases():
    rs = np.random.RandomState(0)
    tokens = torch.as_tensor(rs.randint(0, V, (B, S)))
    mask = torch.as_tensor((rs.rand(B, S) > 0.3).astype(np.float32))
    mask[0, 0] = 0.0
    cases = {
        "copy_reduce": {"x": _rand(rs, 6), "g": _rand(rs, 2, 6)},
        "embed": {"table": _rand(rs, V, D), "tokens": tokens,
                  "g": _rand(rs, B, S, D)},
    }
    logits = _rand(rs, B, S, V, scale=3.0)
    labels = torch.as_tensor(rs.randint(0, V, (B, S)))
    for name, m in (("masked", mask), ("all-masked", torch.zeros(B, S)),
                    ("no-mask", None)):
        c = {"logits": logits, "labels": labels, "g": _rand(rs, 2)}
        if m is not None:
            c["mask"] = m
        cases[f"xent-{name}"] = c
    x = _rand(rs, B, S, D)
    cases["mlp-glu"] = {
        "act": "silu", "x": x, "g": _rand(rs, B, S, D),
        "p": {"w_gate": _rand(rs, D, FF, scale=0.3),
              "w_up": _rand(rs, D, FF, scale=0.3),
              "w_down": _rand(rs, FF, D, scale=0.3)}}
    cases["mlp-bias"] = {
        "act": "gelu", "x": x, "g": _rand(rs, B, S, D),
        "p": {"w_up": _rand(rs, D, FF, scale=0.3), "b_up": _rand(rs, FF),
              "w_down": _rand(rs, FF, D, scale=0.3), "b_down": _rand(rs, D)}}
    # (query heads, KV heads, KV split, qk_norm, biases)
    for name, H, K, kv_split, qk, bias in (
            ("kv-split", 4, 2, True, False, True),
            ("kv-replicated", 4, 1, False, True, False),
            ("kv-per-head", 6, 3, False, True, True)):
        hd = 4
        p = {"wq": _rand(rs, D, H, hd, scale=0.4),
             "wk": _rand(rs, D, K, hd, scale=0.4),
             "wv": _rand(rs, D, K, hd, scale=0.4),
             "wo": _rand(rs, H, hd, D, scale=0.4)}
        if bias:
            p.update(bq=_rand(rs, H, hd, scale=0.1),
                     bk=_rand(rs, K, hd, scale=0.1),
                     bv=_rand(rs, K, hd, scale=0.1), bo=_rand(rs, D))
        if qk:
            p["q_norm"] = {"scale": 1.0 + _rand(rs, hd, scale=0.1)}
            p["k_norm"] = {"scale": 1.0 + _rand(rs, hd, scale=0.1)}
        cases[f"attn-{name}"] = {
            "p": p, "x": x, "g": _rand(rs, B, S, D), "kv_split": kv_split,
            "positions": torch.arange(S, dtype=torch.int32)}
    cases["sum_over"] = {"x": _rand(rs, 2, 3), "g": _rand(rs, 2, 3)}
    for name, cfg in SSM_CFG.items():
        di, nh, N = cfg.d_inner(D), cfg.n_heads(D), cfg.d_state
        p = {"in_proj": _rand(rs, D, 2 * di + 2 * N + nh, scale=0.4),
             "conv_w": _rand(rs, cfg.d_conv, di + 2 * N, scale=0.5),
             "conv_b": _rand(rs, di + 2 * N, scale=0.1),
             "A_log": torch.log(torch.linspace(1.0, 4.0, nh))
             + _rand(rs, nh, scale=0.1),
             "D": 1.0 + _rand(rs, nh, scale=0.1),
             "dt_bias": _rand(rs, nh, scale=0.3),
             "gate_norm": {"scale": 1.0 + _rand(rs, di, scale=0.1)},
             "out_proj": _rand(rs, di, D, scale=0.4)}
        cases[f"ssm-{name}"] = {"p": p, "x": x, "g": _rand(rs, B, S, D),
                                "cfg": cfg, "d": D,
                                "split": name == "split"}
    return cases


# a Mamba2 block of 4 heads (split, 2 a rank) and of 3 (3 % 2 != 0: the
# block is gathered whole and every rank computes every head); N 6, a
# ragged last chunk of 1
SSM_CFG = {"split": SSMConfig(d_state=6, d_conv=3, expand=2, head_dim=4,
                              chunk=2),
           "gathered": SSMConfig(d_state=6, d_conv=3, expand=3, head_dim=8,
                                 chunk=2)}
CASES = _cases()


def _kind(name):
    return name.split("-")[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    job = {"cases": [(_kind(n), c) for n, c in CASES.items()]}
    res = spawn_world(tensor_parallel_program, WORLD, job,
                      str(tmp_path_factory.mktemp("tp")), device="cpu")
    names = list(CASES)
    return {n: [r["cases"][i] for r in res] for i, n in enumerate(names)}, \
        [r["calls"] for r in res]


def _close(a, b, what):
    """max |a - b| within TOL of max(1, max |b|)."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    assert a.shape == b.shape and d <= TOL * scale, (what, a.shape,
                                                      b.shape, d, scale)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _full_grads(fn, inputs, g):
    """fn(**inputs) and the gradients of sum(out * g)."""
    leaves = {k: _leaf(v) for k, v in inputs.items()}
    out = fn(**leaves)
    grads = torch.autograd.grad((out * g).sum(), list(leaves.values()),
                                allow_unused=True)
    return out.detach(), dict(zip(leaves, grads))


def _split_dim(name, w, kv_split=True):
    rel = tp.TP_DIM.get(name)
    if rel is None or (name in tp.KV_REPLICATED and not kv_split):
        return None
    return w.dim() + rel


def test_without_a_context_every_function_is_the_identity():
    c = CASES["embed"]
    x = torch.randn(3, 4)
    assert tp.current() is None and not tp.head_split()
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    assert not tp.is_split(("embed",)) and not tp.batch_split()
    assert torch.equal(tp.vocab_parallel_embed(c["table"], c["tokens"]),
                       layers.embed(c["table"], c["tokens"]))
    # softmax_xent hands off to vocab_parallel_xent inside a context only
    xc = CASES["xent-masked"]
    z = xc["logits"]
    nll = torch.logsumexp(z, -1) - torch.gather(
        z, -1, xc["labels"][..., None])[..., 0]
    got = layers.softmax_xent(z, xc["labels"], xc["mask"])
    assert torch.equal(got[0], torch.sum(nll * xc["mask"]))
    assert torch.equal(got[1], xc["mask"].sum())


def test_copy_to_model_and_reduce_from_model(world):
    res, _ = world
    c = CASES["copy_reduce"]
    for r, out in enumerate(res["copy_reduce"]):
        c_r = float(r + 1)
        _close(out["out"][0], 3.0 * c["x"], "reduce forward: the sum")
        _close(out["out"][1], c_r * c["x"], "copy forward: the identity")
        _close(out["grads"]["a"], c_r * c["g"][0], "reduce backward")
        _close(out["grads"]["b"], 3.0 * c["g"][1],
               "copy backward: the sum over ranks")


def test_vocab_parallel_embed(world):
    res, _ = world
    c = CASES["embed"]
    want, grads = _full_grads(lambda table: layers.embed(table, c["tokens"]),
                              {"table": c["table"]}, c["g"])
    parts = []
    for out in res["embed"]:
        _close(out["out"], want, "embed")
        parts.append(out["grads"]["table"])
    _close(torch.cat(parts), grads["table"], "embed table gradient")


@pytest.mark.parametrize("name", ["masked", "all-masked", "no-mask"])
def test_vocab_parallel_xent(world, name):
    res, _ = world
    c = CASES[f"xent-{name}"]

    def fn(logits):
        return torch.stack(layers.softmax_xent(logits, c["labels"],
                                               c.get("mask")))
    want, grads = _full_grads(fn, {"logits": c["logits"]}, c["g"])
    parts = []
    for out in res[f"xent-{name}"]:
        _close(out["out"], want, "(sum_nll, count)")
        parts.append(out["grads"]["logits"])
    _close(torch.cat(parts, dim=-1), grads["logits"], "logits gradient")
    if name == "all-masked":
        assert float(want[0]) == 0.0 and float(want[1]) == 0.0


def _check_split_grads(outs, grads, p, kv_split=True):
    for name, full in grads.items():
        if full is None:
            continue
        w = p.get(name)
        if name == "x" or (name in ("bo", "b_down")):
            for out in outs:
                _close(out["grads"][name], full, name)
            continue
        dim = _split_dim(name, w, kv_split) if not isinstance(w, dict) \
            else None
        got = [out["grads"][name] for out in outs]
        if dim is None:          # a partial: the heads' shares add up
            _close(sum(got), full, name)
        else:
            _close(torch.cat(got, dim=dim), full, name)


@pytest.mark.parametrize("name", ["glu", "bias"])
def test_split_mlp_matches_the_single_rank_block(world, name):
    res, _ = world
    c = CASES[f"mlp-{name}"]
    want, grads = _full_grads(
        lambda x, **p: layers.mlp(p, x, c["act"]), {"x": c["x"], **c["p"]},
        c["g"])
    for out in res[f"mlp-{name}"]:
        _close(out["out"], want, "mlp")
    _check_split_grads(res[f"mlp-{name}"], grads, c["p"])


@pytest.mark.parametrize("name", ["kv-split", "kv-replicated",
                                  "kv-per-head"])
def test_split_attention_matches_the_single_rank_block(world, name):
    res, _ = world
    c = CASES[f"attn-{name}"]
    flat = {k: (v["scale"] if isinstance(v, dict) else v)
            for k, v in c["p"].items()}

    def fn(x, **leaves):
        p = {k: ({"scale": leaves[k]} if isinstance(c["p"][k], dict)
                 else leaves[k]) for k in leaves}
        return attn_mod.attention(p, x, c["positions"], causal=True)
    want, grads = _full_grads(fn, {"x": c["x"], **flat}, c["g"])
    for out in res[f"attn-{name}"]:
        _close(out["out"], want, "attention")
    _check_split_grads(res[f"attn-{name}"], grads, c["p"], c["kv_split"])


def test_local_kv_heads_follow_the_query_heads():
    """Which replicated KV heads a rank's query heads read."""
    from repro_torch.launch.mesh import Mesh

    class _Ranked(Mesh):
        def __init__(self, rank):
            super().__init__((2,), ("model",))
            self._rank = rank
    for rank, (n_q, n_kv), want in (
            (0, (2, 1), ([0], True)), (1, (2, 1), ([0], True)),
            (0, (8, 8), ([0, 1, 2, 3], True)),
            (1, (16, 8), ([4, 5, 6, 7], True)),
            (0, (3, 3), ([0, 0, 1], False)), (1, (3, 3), ([1, 2, 2], False))):
        with tp.sharded_compute(_Ranked(rank), ()):
            assert tp.local_kv_heads(n_q, n_kv) == want, (rank, n_q, n_kv)


def test_sum_over_model_reduces_forward_and_backward(world):
    """The gated norm's statistic: an all-reduce forward, and of the
    gradient in backward."""
    res, _ = world
    c = CASES["sum_over"]
    for r, out in enumerate(res["sum_over"]):
        c_r = float(r + 1)
        _close(out["out"], 3.0 * c_r * c["x"], "forward: the sum")
        _close(out["grads"]["a"], 3.0 * c_r * c["g"], "backward: the sum")
        assert out["calls"] == 2


@pytest.mark.parametrize("name", ["split", "gathered"])
def test_split_ssm_block_matches_the_single_rank_block(world, name):
    """A Mamba2 block on 2 ranks against the single-rank block: values,
    the input's gradient (whole on every rank), ``out_proj``'s and
    ``gate_norm``'s (the rank's rows), the gathered leaves' (in_proj,
    conv, A_log, D, dt_bias: each rank's share, summed over the ranks);
    four activation collectives (the input's gradient, ``out_proj``'s
    partial, the norm's sum of squares forward and backward). With 3
    heads over 2 ranks the block is computed whole on every rank."""
    res, _ = world
    c = CASES[f"ssm-{name}"]
    flat = {k: (v["scale"] if isinstance(v, dict) else v)
            for k, v in c["p"].items()}

    def fn(x, **leaves):
        p = {k: ({"scale": leaves[k]} if isinstance(c["p"][k], dict)
                 else leaves[k]) for k in leaves}
        return ssm_mod.ssm_forward(p, x, c["d"], c["cfg"])
    want, grads = _full_grads(fn, {"x": c["x"], **flat}, c["g"])
    outs = res[f"ssm-{name}"]
    for out in outs:
        _close(out["out"], want, "ssm block")
        assert out["calls"] == (4 if c["split"] else 0)
    for k, full in grads.items():
        got = [out["grads"][k] for out in outs]
        if k == "x" or not c["split"]:
            for g in got:
                _close(g, full, k)
        elif k in ("out_proj", "gate_norm"):
            dim = full.dim() + tp.SSM_TP_DIM["scale" if k == "gate_norm"
                                             else k]
            _close(torch.cat(got, dim=dim), full, k)
        else:
            _close(sum(got), full, k)
            assert all(float(g.abs().max()) > 0 for g in got), k


def test_ssm_blocks_split_only_where_their_heads_divide():
    """``compute_plan``: a Mamba2 block splits ``out_proj`` and
    ``gate_norm`` over ``model`` and marks its gathered leaves partial
    where its heads divide over ``model`` (mamba2-780m's 48 over 2), and
    is gathered whole where they do not (3 heads) or ``model`` is 1."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.flatbuf import tree_paths
    from repro_torch.distributed.sharded_step import compute_plan
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import abstract_params
    cfg = get_config("mamba2-780m").reduced()
    odd = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, expand=3, head_dim=128))         # 384 / 128 = 3 heads
    for c, dims, want in ((cfg, (2, 2), True), (odd, (2, 2), False),
                          (cfg, (4, 1), False)):
        params = abstract_params(c)
        mesh = Mesh(dims, ("data", "model"))
        plan = compute_plan([(p, x.shape) for p, x in tree_paths(params)],
                            param_specs(params, c, mesh, "train"), mesh)
        ssm = {p for p, _ in tree_paths(params) if tp.is_ssm(p)}
        split = {p[-1] if p[-1] != "scale" else p[-2]
                 for p in plan.split if p in ssm}
        partial = {p[-1] for p in plan.partial if p in ssm}
        assert split == ({"out_proj", "gate_norm"} if want else set()), c
        assert partial == (set(tp.SSM_PARTIAL) if want else set()), c
        assert ("blocks", "ln", "scale") not in plan.partial


def test_activation_collectives_are_counted(world):
    """Every rank ran the same number of activation collectives."""
    _, calls = world
    assert len(set(calls)) == 1 and calls[0] > 0
