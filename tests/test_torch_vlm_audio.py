"""Port parity for the VLM and audio families against the JAX package on
the CPU: ``paligemma-3b`` (a patch-embedding prefix before the scaled
text, a tied head) and ``whisper-large-v3`` (an encoder over frame
embeddings, a decoder with cross-attention, LayerNorm and biases), both
at ``.reduced()`` in float32, JAX weights carried across with
``params_from_jax``.

Both packages initialise biases to 0 and norm scales to 1, where parity
would never exercise a bias add or the LayerNorm affine; so every bias
and norm leaf of the numpy tree is set to seeded random values before
either side loads it.

Held against ``repro``: the trees (reduced, and at full width on the
meta device), ``sinusoidal_pos`` (1e-6), ``cross_kv`` / ``cross_attend``
and ``attention(xkv=)`` (1e-5), ``forward``, ``prefill`` and
``decode_step`` (1e-4), the VLM's ragged decode steps (1e-4) and
``serve_batch`` (tokens, near-tie rule). Held against the port's own
``forward`` at the reference's consistency bounds (2e-3 for a prefill
and one decoded token, 3e-3 a step over many). Also the launcher,
``--closure``, the refusals the reference shares and the CUDA default.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.closure import ResearchClosure as JClosure  # noqa: E402
from repro.launch.serve import serve_batch as j_serve_batch  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import oneshot_inputs, serve_batch  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.layers import layer  # noqa: E402

ARCHS = ["paligemma-3b", "whisper-large-v3"]
TOL = 1e-4
CONSIST, MULTI = 2e-3, 3e-3          # tests/test_models_consistency.py
GAP_TIE = 1e-4
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, rs, path=""):
    """Seeded random values in every bias (``b*``) and norm (``scale``,
    ``bias``) leaf: scales near 1, biases near 0."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _perturb(v, rs, f"{path}/{k}")
        elif k == "scale":
            out[k] = (1 + 0.2 * rs.standard_normal(v.shape)).astype(v.dtype)
        elif k.startswith("b"):
            out[k] = (0.2 * rs.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _close_tree(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{path}/{k}")
        else:
            _close(got[k], want[k])


def _extra(cfg, rs, batch=B):
    """The family's second input, as tests/test_models_consistency.py
    shapes it: patch or frame embeddings, standard normal x 0.02."""
    if cfg.arch_type == "vlm":
        return {"prefix": (rs.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model)) * 0.02
        ).astype(np.float32)}
    return {"frames": (rs.standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)}


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    name = request.param
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    tree = _perturb(_np(j_tf.init_params(jax.random.PRNGKey(0), cfg)),
                    np.random.RandomState(7))
    jp = jax.tree.map(jnp.asarray, tree)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    kw = _extra(cfg, rs)
    full, _ = t_tf.forward(params_from_jax(tree, tcfg, device="cpu"), tcfg,
                           torch.tensor(toks), remat=False,
                           **{k: torch.tensor(v) for k, v in kw.items()})
    return cfg, tcfg, jp, params_from_jax(tree, tcfg, device="cpu"), toks, \
        kw, full


def _jkw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _tkw(kw):
    return {k: torch.tensor(v) for k, v in kw.items()}


def _offset(cfg):
    return cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_tree_paths_shapes_dtypes(name, reduced):
    """The port's tree equals the reference's ``abstract_params`` leaf
    for leaf (paths in ``jax.tree.leaves`` order, shapes, dtypes); at
    full width on the meta device, nothing allocated."""
    cfg, tcfg = get_config(name), t_get_config(name)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    want = jax.tree_util.tree_flatten_with_path(j_tf.abstract_params(cfg))[0]
    got = jax.tree_util.tree_flatten_with_path(t_tf.abstract_params(tcfg))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, j) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), p
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), p


def test_init_params_draws_every_leaf(fam):
    """The port's own draw fills the same tree, the same numbers on a
    second call."""
    _, tcfg, _, tp, _, _, _ = fam
    a = t_tf.init_params(tcfg, seed=3, device="cpu")
    b = t_tf.init_params(tcfg, seed=3, device="cpu")
    assert sorted(n for n, _ in a.named_parameters()) \
        == sorted(n for n, _ in tp.named_parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1280, 128, 2, 3])
def test_sinusoidal_pos(d):
    """Within 1e-6 of the reference at position 0, and within
    ``1e-6 + p * 2**-22`` at position p out to the encoder's 1500
    frames. The two part by the exponential's last bit: XLA's ``exp`` on
    the CPU is not correctly rounded (50 of whisper's 640 frequencies
    differ from the correctly rounded value, torch's 6), so a frequency
    may differ by one unit in its last place (at most 2**-23 of it, and
    every frequency is at most 1), and position p's angle by p times
    that, plus the rounding of the product."""
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(j_tf.sinusoidal_pos(jnp.asarray(pos), d))
    got = t_tf.sinusoidal_pos(torch.tensor(pos), d)
    assert got.dtype == torch.float32 and got.shape == (1500, 2 * (d // 2))
    err = np.abs(got.numpy() - want).max(axis=1)
    assert (err <= 1e-6 + pos * 2.0 ** -22).all()


def test_cross_attention_pieces():
    """``cross_kv``, ``cross_attend`` and ``attention(xkv=,
    kv_positions=)`` on the reduced whisper's first decoder block, with
    RoPE too (it rotates q and k at their own positions)."""
    cfg = get_config("whisper-large-v3").reduced()
    tcfg = t_get_config("whisper-large-v3").reduced()
    tree = _perturb(_np(j_tf.init_params(jax.random.PRNGKey(2), cfg)),
                    np.random.RandomState(3))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"])["cross_attn"]
    tp = layer(params_from_jax(tree, tcfg, device="cpu")["blocks"],
               0)["cross_attn"]
    rs = np.random.RandomState(4)
    x = rs.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    enc = rs.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    kv_j = j_attn.cross_kv(jp, jnp.asarray(enc))
    kv_t = t_attn.cross_kv(tp, torch.tensor(enc))
    for n in ("k", "v"):
        _close(kv_t[n], kv_j[n], 1e-5)
    _close(t_attn.cross_attend(tp, torch.tensor(x), kv_t),
           j_attn.cross_attend(jp, jnp.asarray(x), kv_j), 1e-5)
    for rope, causal in ((False, False), (True, False), (True, True)):
        want = j_attn.attention(
            jp, jnp.asarray(x), jnp.arange(5, dtype=jnp.int32),
            causal=causal, use_rope=rope, xkv=jnp.asarray(enc),
            kv_positions=jnp.arange(9, dtype=jnp.int32) + 2)
        got = t_attn.attention(
            tp, torch.tensor(x), torch.arange(5, dtype=torch.int32),
            causal=causal, use_rope=rope, xkv=torch.tensor(enc),
            kv_positions=torch.arange(9, dtype=torch.int32) + 2)
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
def test_forward(fam):
    cfg, _, jp, _, toks, kw, full = fam
    want, _ = jax.jit(lambda p, t, k: j_tf.forward(p, cfg, t, remat=False,
                                                   **k))(
        jp, jnp.asarray(toks), _jkw(kw))
    assert full.shape == (B, S + 1, cfg.vocab_size)      # text columns only
    _close(full, want)


def test_forward_needs_its_second_input(fam):
    _, tcfg, _, tp, toks, _, _ = fam
    with pytest.raises(ValueError, match="prefix=|frames="):
        t_tf.forward(tp, tcfg, torch.tensor(toks))


def test_prefill_and_decode(fam):
    """Prefill S tokens, decode the rest of a longer sequence one at a
    time: logits and every cache leaf against the reference's at each
    step; the prefill and the first decoded token within 2e-3 of the
    port's forward, every later step within 3e-3."""
    cfg, tcfg, jp, tp, toks, kw, full = fam
    pre = S - 6
    jlog, jc = jax.jit(lambda p, t, k: j_tf.prefill(p, cfg, t, **k))(
        jp, jnp.asarray(toks[:, :pre]), _jkw(kw))
    tlog, tc = t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :pre]),
                            **_tkw(kw))
    _close(tlog, jlog)
    _close_tree(tc, jc)
    _close(tlog[:, 0], full[:, pre - 1].numpy(), CONSIST)
    j_decode = jax.jit(lambda p, t, pos, c: j_tf.decode_step(p, cfg, t, pos,
                                                             c))
    for t in range(pre, S + 1):
        pos = t + _offset(cfg)
        jlog, jc = j_decode(jp, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos, jnp.int32), jc)
        tlog, tc = t_tf.decode_step(tp, tcfg, torch.tensor(toks[:, t:t + 1]),
                                    pos, tc)
        _close(tlog, jlog)
        _close(tlog[:, 0], full[:, t].numpy(),
               CONSIST if t == pre else MULTI)
    _close_tree(tc, jc)


def test_vlm_ragged_prefill_counts_the_prefix(fam):
    """``prefill(lengths=)``: row b's logits are column
    ``n_prefix_tokens + lengths_b - 1``, as the reference's (the audio
    family, like the reference's, takes no ragged prompts)."""
    cfg, tcfg, jp, tp, toks, kw, full = fam
    lengths = np.array([S, S - 5], np.int32)
    if cfg.arch_type != "vlm":
        with pytest.raises(ValueError, match="attention cache"):
            t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :S]),
                         lengths=torch.tensor(lengths), **_tkw(kw))
        return
    jlog, _ = j_tf.prefill(jp, cfg, jnp.asarray(toks[:, :S]),
                           lengths=jnp.asarray(lengths), **_jkw(kw))
    tlog, _ = t_tf.prefill(tp, tcfg, torch.tensor(toks[:, :S]),
                           lengths=torch.tensor(lengths), **_tkw(kw))
    _close(tlog, jlog)
    for b, n in enumerate(lengths):
        _close(tlog[b, 0], full[b, n - 1].numpy(), CONSIST)


# ---------------------------------------------------------------------------
# the VLM's ragged decode steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vlm():
    cfg = get_config("paligemma-3b").reduced()
    tcfg = t_get_config("paligemma-3b").reduced()
    tree = _perturb(_np(j_tf.init_params(jax.random.PRNGKey(5), cfg)),
                    np.random.RandomState(6))
    rs = np.random.RandomState(8)
    shape = (cfg.n_layers, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    return cfg, tcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg, device="cpu"), rs, shape


def _step_inputs(cfg, rs):
    token = rs.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([9, 23, 0], np.int32)
    live = np.array([True, True, False])
    return token, pos, live


def test_vlm_decode_step_ragged(vlm):
    """The dense slot cache: logits and the cache against the
    reference's plain arm; the flash arm (on the CPU: the kernel's plain
    version) against the port's plain arm."""
    cfg, tcfg, jp, tp, rs, shape = vlm
    cache = {n: rs.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    token, pos, live = _step_inputs(cfg, rs)
    jl, jc = j_tf.decode_step_ragged(
        jp, cfg, jnp.asarray(token), jnp.asarray(pos), {"layers": {
            n: jnp.asarray(a) for n, a in cache.items()}}, jnp.asarray(live))
    args = (torch.tensor(token), torch.tensor(pos))
    runs = {}
    for flash in (False, True):
        tc = {"layers": {n: torch.tensor(a) for n, a in cache.items()}}
        runs[flash] = t_tf.decode_step_ragged(tp, tcfg, *args, tc,
                                              torch.tensor(live), flash=flash)
    _close(runs[False][0], jl)
    _close_tree(runs[False][1], jc)
    # a dead row's output is discarded: the plain arm attends slot 0,
    # the kernel returns zeros
    _close(runs[True][0][live], runs[False][0][live].numpy(), 2e-5)
    _close_tree(runs[True][1], _np(jc))


def test_vlm_decode_step_ragged_paged(vlm):
    """The paged pool through page maps with an unused tail page, a
    frozen page (shared, read, not written) and a dead row: the plain arm
    against the reference's; the flash arm against the plain arm."""
    cfg, tcfg, jp, tp, rs, _ = vlm
    n_pages, ps = 12, 8
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rs.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    rmap = np.array([[0, 1, 12, 12], [3, 4, 5, 6], [7, 8, 12, 12]],
                    np.int32)
    wmap = rmap.copy()
    wmap[1, 1] = n_pages                              # frozen shared page
    wmap[2] = n_pages                   # a dead row writes nowhere (engine)
    token, pos, live = _step_inputs(cfg, rs)          # row 1 writes page 6
    maps = (jnp.asarray(rmap), jnp.asarray(wmap))
    jl, jc = j_tf.decode_step_ragged_paged(
        jp, cfg, jnp.asarray(token), jnp.asarray(pos), {"layers": {
            n: jnp.asarray(a) for n, a in pool.items()}}, jnp.asarray(live),
        *maps)
    args = (torch.tensor(token), torch.tensor(pos))
    tmaps = (torch.tensor(rmap), torch.tensor(wmap))
    runs = {}
    for fn in (t_tf.decode_step_ragged_paged,
               t_tf.decode_step_ragged_paged_flash):
        tc = {"layers": {n: torch.tensor(a) for n, a in pool.items()}}
        runs[fn] = fn(tp, tcfg, *args, tc, torch.tensor(live), *tmaps)
    plain = runs[t_tf.decode_step_ragged_paged]
    flash = runs[t_tf.decode_step_ragged_paged_flash]
    _close(plain[0], jl)
    _close_tree(plain[1], jc)
    _close(flash[0][live], plain[0][live].numpy(), 2e-5)
    _close_tree(flash[1], _np(jc))


def test_refusals_the_reference_shares(vlm):
    """The chunked prefill and the engine take no VLM; the engine no
    audio model; the ragged steps no audio model."""
    from repro_torch.serving import ServingConfig, ServingEngine
    cfg, tcfg, _, tp, _, shape = vlm
    cache = {"layers": {n: torch.zeros(shape) for n in ("k", "v")}}
    one = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(dense/moe\), not 'vlm'"):
        t_tf.prefill_chunk(tp, tcfg, torch.zeros(3, 4, dtype=torch.int32),
                           one, one + 4, cache)
    acfg = t_get_config("whisper-large-v3").reduced()
    with pytest.raises(ValueError, match="not 'audio'"):
        t_tf.decode_step_ragged(tp, acfg, one[:, None], one, cache,
                                one.bool())
    for c in (tcfg, acfg):
        with pytest.raises(ValueError, match=f"not '{c.arch_type}'"):
            ServingEngine(tp, c, serving=ServingConfig(max_batch=2,
                                                       max_seq=32),
                          device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _top2_gap(tp, tcfg, seq, kw, b):
    logits, _ = t_tf.forward(tp, tcfg, torch.tensor(seq)[None], remat=False,
                             **{k: torch.tensor(v[b:b + 1])
                                for k, v in kw.items()})
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def test_serve_batch_tokens_equal(fam):
    """``serve_batch(prefix=)`` / ``serve_batch(frames=)`` on the
    launcher's inputs against the reference's ``serve_batch`` on the
    same arrays: tokens equal, a differing token passing only where the
    port's top-2 gap is below 1e-4 (that row is then not compared
    further)."""
    cfg, tcfg, jp, tp, _, _, _ = fam
    prompts, kw = oneshot_inputs(tcfg, seed=0)
    want = np.asarray(j_serve_batch(jp, cfg, jnp.asarray(prompts), 12,
                                    **_jkw(kw)))
    got = serve_batch(tp, tcfg, prompts, 12, **kw)
    assert got.dtype == torch.int32 and got.shape == (4, 12)
    compared = 0
    for b in range(4):
        for t in range(12):
            if int(got[b, t]) != want[b, t]:
                seq = list(prompts[b]) + list(want[b, :t])
                assert _top2_gap(tp, tcfg, seq, kw, b) < GAP_TIE, (b, t)
                break
            compared += 1
    assert compared >= 40


def test_oneshot_inputs_draw_after_the_prompts():
    """The prompts come first from ``RandomState(seed + 1)``, so they are
    the other families' prompts; the patches / frames follow in float32,
    standard normal x 0.02."""
    for name, key, n in (("paligemma-3b", "prefix", 256),
                         ("whisper-large-v3", "frames", 1500)):
        cfg = t_get_config(name)
        prompts, kw = oneshot_inputs(cfg, seed=3)
        rs = np.random.RandomState(4)
        assert np.array_equal(prompts, rs.randint(0, cfg.vocab_size,
                                                  (4, 24)))
        assert set(kw) == {key} and kw[key].dtype == np.float32
        assert kw[key].shape == (4, n, cfg.d_model)
        np.testing.assert_array_equal(kw[key], (rs.standard_normal(
            (4, n, cfg.d_model)) * 0.02).astype(np.float32))


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_on_cpu(name, capsys):
    """``launch.serve --arch <name> --reduced --device cpu`` serves one
    batch through the single-shot path; its sample is ``serve_batch``'s
    first row on the launcher's inputs."""
    assert serve.main(["--arch", name, "--reduced", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    tcfg = t_get_config(name).reduced()
    assert f"arch={tcfg.name} [{tcfg.arch_type}] one-shot" in out
    assert "generated (4, 12)" in out
    prompts, kw = oneshot_inputs(tcfg, seed=0)
    first = serve_batch(t_tf.init_params(tcfg, seed=0, device="cpu"), tcfg,
                        prompts, 12, **kw)[0]
    assert f"sample: {first.numpy()}" in out


def test_launcher_serves_a_closure(fam, tmp_path, capsys):
    """A closure written by the JAX package serves through the port's
    launcher: the tokens of the reference's ``serve_batch`` on the
    launcher's inputs."""
    cfg, tcfg, jp, _, _, _, _ = fam
    path = str(tmp_path / "model.json")
    JClosure(arch=cfg.name, config=cfg, algorithm={}, params=_np(jp),
             step=2).save(path)
    assert serve.main(["--closure", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    prompts, kw = oneshot_inputs(tcfg, seed=0)
    want = np.asarray(j_serve_batch(jp, cfg, jnp.asarray(prompts), 12,
                                    **_jkw(kw)))
    assert f"loaded closure {path} (arch={cfg.name}, step=2)" in out
    assert f"sample: {want[0]}" in out


def test_cuda_default_raises_without_cuda(fam):
    _, tcfg, _, tp, _, kw, _ = fam
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the cuda default is valid")
    prompts = np.zeros((2, 4), np.int32)
    for call in (lambda: t_tf.init_params(tcfg),
                 lambda: t_tf.init_decode_cache(tcfg, 1, 8),
                 lambda: serve_batch(tp, tcfg, prompts, 2, device="cuda",
                                     **kw),
                 lambda: serve.main(["--arch", tcfg.name, "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
