"""Port parity for the MoE, SSM and hybrid families' models against the
JAX package on the CPU: ``llama4-scout-17b-a16e`` (top-1 + shared
expert), ``arctic-480b`` (top-2 + dense residual), ``mamba2-780m`` and
``zamba2-7b`` (SSM stack with attention super-blocks and a tail), all at
``.reduced()``, JAX weights carried across with ``params_from_jax``.

``forward`` (logits and the MoE aux loss), ``prefill`` (logits and every
cache leaf) and ``decode_step`` within 1e-4 of the reference; prefill +
decode within 2e-3 of the port's own forward (the JAX package's
consistency bound); ``serve_batch`` tokens equal; the serve launcher's
single-shot path and ``--closure`` for these families.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.closure import ResearchClosure as JClosure  # noqa: E402
from repro.launch.serve import serve_batch as j_serve_batch  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_jax,  # noqa: E402
                                            params_to_numpy)
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import (oneshot_prompts,  # noqa: E402
                                      serve_batch)
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCHS = ["llama4-scout-17b-a16e", "arctic-480b", "mamba2-780m", "zamba2-7b"]
TOL = 1e-4
CONSIST = 2e-3
B, S, PRE = 2, 21, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _close_tree(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{path}/{k}")
        else:
            g, w = got[k].detach().numpy(), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, f"{path}/{k}"
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{path}/{k}")


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    name = request.param
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    jp = j_tf.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu"), toks


def test_params_tree_and_dtypes(fam):
    """The carried tree has the reference's layout, and the port's own
    init makes the same tree: shapes and dtypes per leaf; the float32
    router / SSM leaves stay float32 in the bf16 full-width config."""
    cfg, tcfg, jp, tp, _ = fam
    want = jax.tree.map(lambda a: tuple(a.shape), _np(jp))
    assert t_tf.param_shapes(tcfg) == want
    mine = t_tf.init_params(tcfg, seed=3, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape),
                        params_to_numpy(mine)) == want
    again = t_tf.init_params(tcfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mine.parameters(),
                                                  again.parameters()))
    full = t_get_config(cfg.name)
    jfull = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0),
                                                    get_config(cfg.name)))
    tfull = t_tf.abstract_params(full)
    for (jpath, jl), (tpath, tl) in zip(
            jax.tree_util.tree_flatten_with_path(jfull)[0],
            jax.tree_util.tree_flatten_with_path(tfull)[0]):
        assert jpath == tpath
        assert tuple(jl.shape) == tuple(tl.shape)
        assert str(jl.dtype) == str(tl.dtype).replace("torch.", "")


def test_forward(fam):
    cfg, tcfg, jp, tp, toks = fam
    jl, ja = jax.jit(lambda p, t: j_tf.forward(p, cfg, t, remat=False))(
        jp, jnp.asarray(toks))
    tl, ta = t_tf.forward(tp, tcfg, torch.tensor(toks))
    _close(tl, jl)
    _close(ta, ja)
    if cfg.arch_type == "moe":
        assert float(ta) > 0


def test_prefill_and_decode(fam):
    """Prefill PRE tokens, decode the rest one at a time: logits and
    every cache leaf against the reference's at each step, and the
    decoded logits against the port's full forward."""
    cfg, tcfg, jp, tp, toks = fam
    jlog, jc = jax.jit(lambda p, t: j_tf.prefill(p, cfg, t))(
        jp, jnp.asarray(toks[:, :PRE]))
    j_decode = jax.jit(lambda p, t, pos, c: j_tf.decode_step(p, cfg, t, pos,
                                                             c))
    tlog, tc = t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :PRE]))
    _close(tlog, jlog)
    _close_tree(tc, jc)
    full, _ = t_tf.forward(tp, tcfg, torch.tensor(toks), remat=False)
    _close(tlog[:, 0], full[:, PRE - 1].numpy(), CONSIST)
    for t in range(PRE, S):
        jlog, jc = j_decode(jp, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32), jc)
        tlog, tc = t_tf.decode_step(tp, tcfg, torch.tensor(toks[:, t:t + 1]),
                                    t, tc)
        _close(tlog, jlog)
        _close(tlog[:, 0], full[:, t].numpy(), CONSIST)
    _close_tree(tc, jc)


def test_serve_batch_tokens_equal(fam):
    cfg, tcfg, jp, tp, _ = fam
    prompts = oneshot_prompts(tcfg, seed=0)
    want = np.asarray(j_serve_batch(jp, cfg, jnp.asarray(prompts), 12))
    got = serve_batch(tp, tcfg, prompts, 12)
    assert got.dtype == torch.int32 and got.shape == (4, 12)
    assert np.array_equal(got.numpy(), want)


def test_ragged_prefill_needs_an_attention_cache(fam):
    cfg, tcfg, jp, tp, toks = fam
    lengths = torch.tensor([PRE, PRE - 3])
    if cfg.arch_type == "moe":
        jlog, _ = jax.jit(lambda p, t, n: j_tf.prefill(p, cfg, t, lengths=n))(
            jp, jnp.asarray(toks[:, :PRE]), jnp.asarray(lengths.numpy()))
        tlog, _ = t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :PRE]),
                               lengths=lengths)
        _close(tlog, jlog)
    else:
        with pytest.raises(ValueError, match="attention cache"):
            t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :PRE]),
                         lengths=lengths)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b",
                                  "llama4-scout-17b-a16e"])
def test_launcher_on_cpu(name, capsys):
    """``launch.serve --arch <name> --reduced --device cpu``: SSM and
    hybrid through the single-shot path (its first row is
    ``serve_batch``'s on the launcher's prompts), MoE through the
    engine."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "4", "--max-batch", "2",
                       "--max-seq", "48"]) == 0
    out = capsys.readouterr().out
    tcfg = t_get_config(name).reduced()
    if tcfg.arch_type == "moe":
        assert "requests=4" in out and "decode rows" in out
        return
    assert f"arch={tcfg.name} [{tcfg.arch_type}] one-shot" in out
    assert "generated (4, 12)" in out
    tp = t_tf.init_params(tcfg, seed=0, device="cpu")
    first = serve_batch(tp, tcfg, oneshot_prompts(tcfg, seed=0), 12)[0]
    assert f"sample: {first.numpy()}" in out


def test_launcher_serves_a_closure(tmp_path, capsys):
    """A closure of the reduced hybrid written by the JAX package serves
    through the port's launcher: its single-shot tokens are the JAX
    package's ``serve_batch`` on the launcher's prompts."""
    from repro_torch.launch import serve
    name = "zamba2-7b"
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    jp = j_tf.init_params(jax.random.PRNGKey(4), cfg)
    path = str(tmp_path / "hybrid.json")
    JClosure(arch=name, config=cfg, algorithm={}, params=_np(jp),
             step=2).save(path)
    assert serve.main(["--closure", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = np.asarray(j_serve_batch(
        jp, cfg, jnp.asarray(oneshot_prompts(tcfg, seed=0)), 12))
    assert f"sample: {want[0]}" in out


@pytest.mark.parametrize("arch_type", ["vlm", "audio"])
def test_vlm_and_audio_still_raise(fam, arch_type):
    _, tcfg, _, tp, toks = fam
    cfg = dataclasses.replace(tcfg, arch_type=arch_type)
    for fn in (lambda: t_tf.forward(tp, cfg, torch.tensor(toks)),
               lambda: serve_batch(tp, cfg, toks[:, :4], 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP C7"):
            fn()
