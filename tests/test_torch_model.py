"""Port parity for the model stack: ``repro_torch.models`` (layers,
attention, the dense transformer's serving steps) and the weight
transfer, against the JAX package on the reduced ``mlitb-lm-100m`` (2
layers, d 128, 4 heads, 1 KV head, vocab 512). Inputs come from numpy
with a seed; JAX weights are carried across with ``params_from_jax``.

Tolerances: 1e-5 relative / 1e-4 absolute on activations and logits
(float32; the two frameworks sum in different orders). Cache entries
that JAX leaves untouched — dropped out-of-bounds scatters, frozen
pages, dead rows, padding — must come out bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_jax,  # noqa: E402
                                            params_to_numpy)
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _j(tree):
    """The same arrays for the JAX side (its scatters need jax arrays)."""
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    """A torch COPY of a numpy array (the port updates caches in place;
    the numpy input must stay intact for the JAX side)."""
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def model():
    cfg = get_config("mlitb-lm-100m").reduced()
    tcfg = t_get_config("mlitb-lm-100m").reduced()
    jp = j_tf.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return cfg, tcfg, jp, tp


def _blk(jp, tp, i=0):
    """Layer i's attention params on both sides."""
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["attn"]),
            t_layers.layer(tp["blocks"], i)["attn"])


# ---------------------------------------------------------------------------
# configs + layers
# ---------------------------------------------------------------------------
def test_config_copy_matches_reference():
    for reduced in (False, True):
        a, b = get_config("mlitb-lm-100m"), t_get_config("mlitb-lm-100m")
        if reduced:
            a, b = a.reduced(), b.reduced()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "tie_embeddings", "rope_theta",
                  "norm_eps", "param_dtype", "activ_dtype", "mlp_act"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.n_params() == b.n_params()


def test_norms_rope_mlp_embed_unembed():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 32).astype(np.float32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    bias = rng.randn(32).astype(np.float32)
    _close(t_layers.rmsnorm({"scale": _t(scale)}, _t(x)),
           j_layers.rmsnorm({"scale": scale}, x))
    _close(t_layers.apply_norm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           j_layers.apply_norm({"scale": scale, "bias": bias}, x))
    pos = rng.randint(0, 500, size=(2, 5)).astype(np.int32)
    _close(t_layers.apply_rope(_t(x), _t(pos), 10000.0),
           j_layers.apply_rope(x, pos, 10000.0))
    d, ff = 32, 48
    w = {k: rng.randn(*s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    h = rng.randn(4, d).astype(np.float32)
    for act in ("silu", "gelu_glu"):
        _close(t_layers.mlp({k: _t(v) for k, v in w.items()}, _t(h), act),
               j_layers.mlp(w, h, act))
    plain = {"w_up": w["w_up"], "w_down": w["w_down"],
             "b_up": rng.randn(ff).astype(np.float32),
             "b_down": rng.randn(d).astype(np.float32)}
    _close(t_layers.mlp({k: _t(v) for k, v in plain.items()}, _t(h), "gelu"),
           j_layers.mlp(plain, h, "gelu"))
    table = rng.randn(50, d).astype(np.float32)
    tok = rng.randint(0, 50, size=(3, 4)).astype(np.int32)
    _close(t_layers.embed(_t(table), _t(tok)), j_layers.embed(table, tok))
    lg = t_layers.unembed(_t(table).bfloat16(), _t(h).bfloat16())
    assert lg.dtype == torch.float32                   # f32 logits
    _close(lg, j_layers.unembed(jnp.asarray(table, jnp.bfloat16),
                                jnp.asarray(h, jnp.bfloat16)))


def test_greedy_argmax_keeps_first_of_tied_maxima():
    """The engine's greedy pick on tied rows: first index, as
    ``jnp.argmax`` (the JAX engine's sampler) takes it. The engine
    samples through ``sample_tokens``; ``top_k=1`` keeps the same one."""
    from repro_torch.serving.sampling import sample_tokens
    rows = np.asarray([[0.5, 2.0, -1.0, 2.0, 2.0],
                       [3.0, 3.0, 3.0, 3.0, 3.0],
                       [-1.0, -2.0, -1.0, -3.0, -1.0]], np.float32)
    got = sample_tokens(_t(rows), None, None, temperature=0.0, top_k=0,
                        seed=0)
    assert got.tolist() == np.asarray(jnp.argmax(rows, axis=-1)).tolist() \
        == [1, 0, 0]
    top1 = sample_tokens(_t(rows), np.arange(3), np.zeros(3, np.int64),
                         temperature=0.7, top_k=1, seed=0)
    assert top1.tolist() == [1, 0, 0]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_grouped_attend_with_mask(model):
    rng = np.random.RandomState(1)
    B, S, T, H, K, hd = 2, 3, 7, 4, 1, 32
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, T, K, hd).astype(np.float32)
    v = rng.randn(B, T, K, hd).astype(np.float32)
    mask = (rng.rand(B, 1, 1, S, T) < 0.6)
    mask[0, 0, 0, 1] = False                    # a fully masked query row
    _close(t_attn.grouped_attend(_t(q), _t(k), _t(v), _t(mask)),
           j_attn.grouped_attend(q, k, v, mask))


def _decode_inputs(rng, B, T, K, hd, d):
    x = rng.randn(B, 1, d).astype(np.float32)
    ck = rng.randn(B, T, K, hd).astype(np.float32)
    cv = rng.randn(B, T, K, hd).astype(np.float32)
    pos = np.asarray([0, 5, T - 1, 9][:B], np.int32)
    live = np.asarray([True, False, True, True][:B])
    return x, ck, cv, pos, live


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_attention_decode_ragged_dead_rows_do_not_write(model, flash):
    cfg, _, jp, tp = model
    ja, ta = _blk(jp, tp)
    B, T = 4, 32
    x, ck, cv, pos, live = _decode_inputs(np.random.RandomState(2), B, T,
                                          cfg.n_kv_heads, cfg.head_dim,
                                          cfg.d_model)
    jfn = j_attn.attention_decode_ragged_flash if flash \
        else j_attn.attention_decode_ragged
    tfn = t_attn.attention_decode_ragged_flash if flash \
        else t_attn.attention_decode_ragged
    jo, jc = jfn(ja, x, pos, cache=_j({"k": ck, "v": cv}), live=live)
    to, tc = tfn(ta, _t(x), _t(pos), cache={"k": _t(ck), "v": _t(cv)},
                 live=_t(live))
    _close(to[live], np.asarray(jo)[live])
    written = np.zeros((B, T), bool)
    written[live, pos[live]] = True
    for n, init in (("k", ck), ("v", cv)):
        got, want = tc[n].numpy(), np.asarray(jc[n])
        assert np.array_equal(got[~written], init[~written])
        assert np.array_equal(got[~written], want[~written])
        _close(got[written], want[written])


def test_pow2_kv_block_matches():
    for T in (8, 24, 64, 96, 512, 1000, 4096):
        assert t_attn._pow2_kv_block(T) == j_attn._pow2_kv_block(T)


def test_paged_flash_write_map_drops_frozen_and_oob(model):
    """The write map's entries >= n_pages (frozen/shared pages, rows of
    another group, dead rows) must not write; the one cell each live row
    writes must match JAX."""
    cfg, _, jp, tp = model
    ja, ta = _blk(jp, tp, 1)
    rng = np.random.RandomState(3)
    B, N, ps, P, K, hd = 4, 12, 4, 3, cfg.n_kv_heads, cfg.head_dim
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kb = rng.randn(N, ps, K, hd).astype(np.float32)
    vb = rng.randn(N, ps, K, hd).astype(np.float32)
    pos = np.asarray([2, 6, 9, 4], np.int32)
    live = np.asarray([True, True, True, False])
    rmap = np.asarray([[0, N, N], [1, 2, N], [3, 4, 5], [6, 7, N]], np.int32)
    wmap = rmap.copy()
    wmap[1, 1] = N          # row 1's write page is frozen (shared)
    wmap[3, :] = N          # dead row
    jo, (jk, jv) = j_attn.attention_decode_ragged_paged_flash(
        ja, x, pos, kbuf=_j(kb), vbuf=_j(vb), live=live, rmap=rmap,
        wmap=wmap)
    to, (tk, tv) = t_attn.attention_decode_ragged_paged_flash(
        ta, _t(x), _t(pos), kbuf=_t(kb), vbuf=_t(vb), live=_t(live),
        rmap=_t(rmap), wmap=_t(wmap))
    _close(to[live], np.asarray(jo)[live])
    written = np.zeros((N, ps), bool)
    for b in (0, 2):                      # the rows whose write page is real
        written[wmap[b, pos[b] // ps], pos[b] % ps] = True
    for got, want, init in ((tk, jk, kb), (tv, jv, vb)):
        got, want = got.numpy(), np.asarray(want)
        assert np.array_equal(got[~written], init[~written])
        assert np.array_equal(got[~written], want[~written])
        _close(got[written], want[written])


def test_prefill_chunk_padding_columns_do_not_write(model):
    cfg, _, jp, tp = model
    ja, ta = _blk(jp, tp)
    rng = np.random.RandomState(4)
    B, C, T, K, hd = 3, 8, 16, cfg.n_kv_heads, cfg.head_dim
    x = rng.randn(B, C, cfg.d_model).astype(np.float32)
    ck = rng.randn(B, T, K, hd).astype(np.float32)
    cv = rng.randn(B, T, K, hd).astype(np.float32)
    off = np.asarray([0, 5, 12], np.int32)
    clen = np.asarray([8, 3, 0], np.int32)        # full, ragged, padding row
    jo, jc = j_attn.attention_prefill_chunk(ja, x, off, clen,
                                            cache=_j({"k": ck, "v": cv}))
    to, tc = t_attn.attention_prefill_chunk(
        ta, _t(x), _t(off), _t(clen), cache={"k": _t(ck), "v": _t(cv)})
    valid = np.arange(C)[None, :] < clen[:, None]
    _close(to.numpy()[valid], np.asarray(jo)[valid])
    written = np.zeros((B, T), bool)
    for b in range(B):
        written[b, off[b]:off[b] + clen[b]] = True
    for n, init in (("k", ck), ("v", cv)):
        got, want = tc[n].numpy(), np.asarray(jc[n])
        assert np.array_equal(got[~written], init[~written])
        assert np.array_equal(got[~written], want[~written])
        _close(got[written], want[written])


# ---------------------------------------------------------------------------
# transformer steps (whole model, weights carried across)
# ---------------------------------------------------------------------------
def _dense_cache(rng, cfg, B, T):
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
    return {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_decode_step_ragged_logits_and_cache(model, flash):
    cfg, tcfg, jp, tp = model
    rng = np.random.RandomState(5)
    B, T = 4, 32
    cache = _dense_cache(rng, cfg, B, T)
    tok = rng.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.asarray([3, 17, 31, 0], np.int32)
    live = np.asarray([True, True, True, False])
    jl, jc = j_tf.decode_step_ragged(jp, cfg, tok, pos,
                                     _j({"layers": cache}), live, flash=flash)
    tl, tc = t_tf.decode_step_ragged(
        tp, tcfg, _t(tok), _t(pos), {"layers": {n: _t(a) for n, a in
                                                cache.items()}},
        _t(live), flash=flash)
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl[live], np.asarray(jl)[live])
    for n in ("k", "v"):
        _close(tc["layers"][n], jc["layers"][n])
        dead = np.asarray(tc["layers"][n][:, 3])
        assert np.array_equal(dead, cache[n][:, 3])     # dead row untouched


def test_prefill_chunk_logits_and_cache(model):
    cfg, tcfg, jp, tp = model
    rng = np.random.RandomState(6)
    B, C, T = 4, 8, 32
    cache = _dense_cache(rng, cfg, B, T)
    tokens = rng.randint(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    off = np.asarray([0, 4, 20, 0], np.int32)
    clen = np.asarray([8, 5, 1, 0], np.int32)
    jl, jc = j_tf.prefill_chunk(jp, cfg, tokens, off, clen,
                                _j({"layers": cache}))
    tl, tc = t_tf.prefill_chunk(
        tp, tcfg, _t(tokens), _t(off), _t(clen),
        {"layers": {n: _t(a) for n, a in cache.items()}})
    _close(tl[:3], np.asarray(jl)[:3])
    for n in ("k", "v"):
        _close(tc["layers"][n], jc["layers"][n])


def _paged_case(rng, cfg, B, N, ps, P):
    shape = (cfg.n_layers, N, ps, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    rmap = np.full((B, P), N, np.int32)
    pages = rng.permutation(N)
    for b in range(B - 1):                       # last row: padding
        rmap[b, :P - b] = pages[b * P:b * P + P - b]
    wmap = rmap.copy()
    wmap[0, 0] = N                               # a frozen shared page
    return pool, rmap, wmap


def test_prefill_chunk_paged_logits_and_pool(model):
    cfg, tcfg, jp, tp = model
    rng = np.random.RandomState(7)
    B, N, ps, P, C = 4, 16, 4, 3, 4
    pool, rmap, wmap = _paged_case(rng, cfg, B, N, ps, P)
    tokens = rng.randint(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    off = np.asarray([4, 0, 2, 0], np.int32)
    clen = np.asarray([4, 3, 4, 0], np.int32)
    jl, jpool = j_tf.prefill_chunk_paged(jp, cfg, tokens, off, clen,
                                         _j({"layers": pool}), rmap, wmap)
    tl, tpool = t_tf.prefill_chunk_paged(
        tp, tcfg, _t(tokens), _t(off), _t(clen),
        {"layers": {n: _t(a) for n, a in pool.items()}}, _t(rmap), _t(wmap))
    _close(tl[:3], np.asarray(jl)[:3])
    for n in ("k", "v"):
        got, want = tpool["layers"][n].numpy(), np.asarray(jpool["layers"][n])
        _close(got, want)
        # pages no write map names (free, frozen) keep their bytes
        untouched = np.setdiff1d(np.arange(N), wmap[wmap < N])
        assert np.array_equal(got[:, untouched], pool[n][:, untouched])
        assert np.array_equal(got[:, untouched], want[:, untouched])


@pytest.mark.parametrize("kernel", ["plain", "flash"])
def test_decode_step_ragged_paged_logits_and_pool(model, kernel):
    cfg, tcfg, jp, tp = model
    rng = np.random.RandomState(8)
    B, N, ps, P = 4, 16, 4, 3
    pool, rmap, wmap = _paged_case(rng, cfg, B, N, ps, P)
    tok = rng.randint(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.asarray([9, 6, 2, 0], np.int32)
    live = np.asarray([True, True, True, False])
    jfn = j_tf.decode_step_ragged_paged_flash if kernel == "flash" \
        else j_tf.decode_step_ragged_paged
    tfn = t_tf.decode_step_ragged_paged_flash if kernel == "flash" \
        else t_tf.decode_step_ragged_paged
    jl, jpool = jfn(jp, cfg, tok, pos, _j({"layers": pool}), live, rmap,
                    wmap)
    tl, tpool = tfn(tp, tcfg, _t(tok), _t(pos),
                    {"layers": {n: _t(a) for n, a in pool.items()}},
                    _t(live), _t(rmap), _t(wmap))
    _close(tl[live], np.asarray(jl)[live])
    for n in ("k", "v"):
        got, want = tpool["layers"][n].numpy(), np.asarray(jpool["layers"][n])
        _close(got, want)
        untouched = np.setdiff1d(np.arange(N), wmap[wmap < N])
        assert np.array_equal(got[:, untouched], want[:, untouched])


# ---------------------------------------------------------------------------
# parameters and their transfer
# ---------------------------------------------------------------------------
def test_params_round_trip_and_layout(model):
    cfg, tcfg, jp, tp = model
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    mine = t_tf.init_params(tcfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jnp_tree)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        params_to_numpy(mine)) == shapes
    assert t_tf.param_shapes(tcfg) == shapes
    again = t_tf.init_params(tcfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mine.parameters(),
                                                  again.parameters()))
    assert sum(p.numel() for p in mine.parameters()) == tcfg.n_params()
    assert not any(p.requires_grad for p in mine.parameters())


def test_params_from_jax_rejects_mismatches(model):
    cfg, tcfg, jp, _ = model
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["lm_head"] = tree["embed"]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(tree, tcfg, device="cpu")
