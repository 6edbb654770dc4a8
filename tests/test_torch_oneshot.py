"""Port parity for the single-shot serving path: ``init_cache`` /
``attention_prefill`` / ``attention_decode`` (with ``kpos`` and the
sliding-window ring), the transformer's ``prefill`` (ragged
``lengths``) and lockstep ``decode_step``, ``serve_batch`` and the
serve launcher's ``--closure``, against the JAX package on the CPU at
the reduced ``mlitb-lm-100m``, JAX weights carried across with
``params_from_jax``.

Logits and caches within 1e-5 (relative and absolute, float32); ``kpos``
and generated tokens equal.
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_jax,  # noqa: E402
                                            params_to_numpy)
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.closure import ResearchClosure  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import (ServeRequest, ServingConfig,  # noqa: E402
                                 ServingEngine)

ARCH = "mlitb-lm-100m"
TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    jp = j_tf.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring"])
def test_attention_prefill_and_decode(model, window):
    """Prefill 5 positions, then decode one token at a time to position
    13: with ``window=8`` the cache is an 8-slot ring and the decode
    passes the window, overwriting the oldest slots."""
    cfg, _, jp, tp = model
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tb = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.RandomState(1)
    B, S, T = 3, 5, (window or 16)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jc = j_attn.init_cache(B, T, K, hd, dtype=jnp.float32)
    tc = t_attn.init_cache(B, T, K, hd, dtype=torch.float32, device="cpu")
    assert np.array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    jo, jc = j_attn.attention_prefill(jb, jnp.asarray(x), jnp.asarray(pos),
                                      cache=jc, window=window)
    to, tc = t_attn.attention_prefill(tb, torch.tensor(x), torch.tensor(pos),
                                      cache=tc, window=window)
    _close(to, jo)
    for p in range(S, 14):
        xd = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        jo, jc = j_attn.attention_decode(jb, jnp.asarray(xd),
                                         jnp.asarray(p, jnp.int32), cache=jc,
                                         window=window)
        to, tc = t_attn.attention_decode(tb, torch.tensor(xd),
                                         torch.tensor(p, dtype=torch.int32),
                                         cache=tc, window=window)
        _close(to, jo)
        assert np.array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
        for n in ("k", "v"):
            _close(tc[n], jc[n])
    if window:
        assert sorted(tc["kpos"].tolist()) == list(range(14 - window, 14))


def test_attention_decode_clamps_its_slot_like_jax(model):
    """A position past a linear cache's end: ``dynamic_update_slice``
    clamps the write onto the last slot, and so does the port."""
    cfg, _, jp, tp = model
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tb = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.RandomState(2)
    B, T = 2, 6
    jc = j_attn.init_cache(B, T, cfg.n_kv_heads, cfg.head_dim,
                           dtype=jnp.float32)
    tc = t_attn.init_cache(B, T, cfg.n_kv_heads, cfg.head_dim,
                           dtype=torch.float32, device="cpu")
    for p in (0, 1, 9):
        xd = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        jo, jc = j_attn.attention_decode(jb, jnp.asarray(xd),
                                         jnp.asarray(p, jnp.int32), cache=jc)
        to, tc = t_attn.attention_decode(tb, torch.tensor(xd),
                                         torch.tensor(p), cache=tc)
        _close(to, jo)
    assert tc["kpos"].tolist() == np.asarray(jc["kpos"]).tolist() \
        == [0, 1, -1, -1, -1, 9]


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 16], ids=["full", "ring"])
def test_prefill_ragged_and_decode_step(model, window):
    cfg, tcfg, jp, tp = model
    cfg = dataclasses.replace(cfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    rng = np.random.RandomState(3)
    B, S = 3, 10
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lengths = np.asarray([10, 7, 1], np.int32)
    jl, jc = j_tf.prefill(jp, cfg, jnp.asarray(toks), cache_len=24,
                          lengths=jnp.asarray(lengths))
    tl, tc = t_tf.prefill(tp, tcfg, torch.tensor(toks), cache_len=24,
                          lengths=torch.tensor(lengths))
    _close(tl, jl)
    T = min(window, 24) if window else 24
    assert tuple(tc["layers"]["k"].shape) == (cfg.n_layers, B, T,
                                              cfg.n_kv_heads, cfg.head_dim)
    assert np.array_equal(tc["layers"]["kpos"].numpy(),
                          np.asarray(jc["layers"]["kpos"]))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for p in range(S, S + 9):                  # the ring wraps at 16
        jl, jc = j_tf.decode_step(jp, cfg, jnp.asarray(tok),
                                  jnp.asarray(p, jnp.int32), jc)
        tl, tc = t_tf.decode_step(tp, tcfg, torch.tensor(tok), p, tc)
        _close(tl, jl)
        assert np.array_equal(tc["layers"]["kpos"].numpy(),
                              np.asarray(jc["layers"]["kpos"]))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for n in ("k", "v"):
        _close(tc["layers"][n], jc["layers"][n])


def test_prefill_then_decode_matches_forward(model):
    """The cached path computes the same function as the training
    forward over the whole sequence."""
    _, tcfg, _, tp = model
    rng = np.random.RandomState(4)
    B, P, G = 2, 6, 5
    seq = torch.tensor(rng.randint(0, tcfg.vocab_size,
                                   size=(B, P + G)).astype(np.int32))
    full, _ = t_tf.forward(tp, tcfg, seq, remat=False)
    logits, cache = t_tf.prefill(tp, tcfg, seq[:, :P], cache_len=16)
    assert cache["layers"]["k"].shape[2] == 16
    _close(logits[:, 0], full[:, P - 1].numpy())
    for t in range(G):
        logits, cache = t_tf.decode_step(tp, tcfg, seq[:, P + t:P + t + 1],
                                         P + t, cache)
        _close(logits[:, 0], full[:, P + t].numpy())


# ---------------------------------------------------------------------------
# serve_batch and the launcher
# ---------------------------------------------------------------------------
def test_serve_batch_matches_jax_and_the_engine(model):
    cfg, tcfg, jp, tp = model
    rng = np.random.RandomState(5)
    B, P, G = 4, 12, 8
    prompts = rng.randint(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    want = np.asarray(j_serve_batch(jp, cfg, jnp.asarray(prompts), G))
    got = serve_batch(tp, tcfg, prompts, G)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    # prompts already in a tensor are taken as they are
    assert torch.equal(serve_batch(tp, tcfg, torch.tensor(prompts), G), got)
    eng = ServingEngine(tp, tcfg, serving=ServingConfig(max_batch=B,
                                                        max_seq=32),
                        device="cpu")
    st = eng.run_closed_loop([ServeRequest(rid=i, prompt=prompts[i],
                                           max_new=G) for i in range(B)])
    for c in st.completions:
        assert c.tokens.tolist() == want[c.rid].tolist()


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_launcher_serves_a_closure_on_cpu(model, tmp_path, capsys, writer):
    from repro_torch.launch import serve
    cfg, tcfg, jp, tp = model
    path = str(tmp_path / "model.json")
    if writer == "repro":
        JClosure(arch=ARCH, config=cfg, algorithm={"lr": 0.1},
                 params=_np(jp), step=7).save(path)
    else:
        ResearchClosure(arch=ARCH, config=tcfg, algorithm={"lr": 0.1},
                        params=params_to_numpy(tp), step=7).save(path)
    assert serve.main(["--closure", path, "--requests", "3",
                       "--max-batch", "2", "--max-seq", "64",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loaded closure {path} (arch={ARCH}, step=7)" in out
    assert "requests=3" in out
    # the closure carries the weights across unchanged
    first = serve_batch(tp, tcfg, np.zeros((1, 4), np.int32), 3)
    clo = ResearchClosure.load(path)
    again = serve_batch(params_from_jax(clo.params, clo.config,
                                        device="cpu"),
                        clo.config, np.zeros((1, 4), np.int32), 3)
    assert torch.equal(first, again)


def test_serve_batch_device_rule(model):
    _, tcfg, _, tp = model
    prompts = np.zeros((1, 4), np.int32)
    assert serve_batch(tp, tcfg, prompts, 2, device="cpu").shape == (1, 2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the cuda request is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_batch(tp, tcfg, prompts, 2, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP C7"):
        serve_batch(tp, dataclasses.replace(tcfg, arch_type="audio"),
                    prompts, 2)


def test_cache_allocators_default_to_cuda(model):
    """``init_cache`` and ``init_decode_cache`` allocate on the card
    unless the caller names the CPU, as every entry point of the port."""
    _, tcfg, _, _ = model
    c = t_attn.init_cache(1, 4, 2, 8, device="cpu")
    d = t_tf.init_decode_cache(tcfg, 1, 4, device="cpu")
    assert c["kpos"].tolist() == [-1] * 4
    assert tuple(d["layers"]["k"].shape) == (tcfg.n_layers, 1, 4,
                                             tcfg.n_kv_heads, tcfg.head_dim)
    assert d["layers"]["kpos"].tolist() == [[-1] * 4] * tcfg.n_layers
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the cuda default is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_attn.init_cache(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_tf.init_decode_cache(tcfg, 1, 4)
