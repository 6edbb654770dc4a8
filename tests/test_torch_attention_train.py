"""The training attention's CPU side (``repro_torch.kernels.flash_attention
.train``): the autograd function's wrappers through a Python stand-in for
the C entry points that reads and writes memory by the strides it is
given, as the kernels do, and computes in float64 (held against autograd
through a float64 softmax and through ``grouped_attend``); what
``attention_train`` refuses; the routing rule, and the ``by_index`` fact
the model's forward passes down to it; and the model on the CPU, which
stays on ``grouped_attend`` bit for bit. The kernels themselves run on
the card only (``chip_smoke.py``'s ``[attn-train]`` phase,
``scripts/time_attn_train.py``).
"""
import ctypes
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import train as ft  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.layers import rope_tables, rotate  # noqa: E402

# (B, S, H, K, D, causal, window): masks, GQA groups of 1 and 3, ragged
# lengths (no multiple of a tile), widths 32 / 64 / 128
CASES = {
    "causal-g3-d64": (2, 37, 6, 2, 64, True, 0),
    "causal-g1-d32": (1, 20, 3, 3, 32, True, 0),
    "window-g3-d64": (1, 45, 3, 1, 64, True, 7),
    "window-only-g1-d128": (2, 19, 2, 2, 128, False, 5),
    "none-g3-d128": (1, 23, 6, 2, 128, False, 0),
    "none-g1-d32": (2, 9, 4, 4, 32, False, 0),
}


def _inputs(case, dtype=torch.float64, seed=0):
    B, S, H, K, D, causal, window = CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, generator=g, dtype=dtype)
               for n in (H, K, K))
    w = torch.randn(B, S, H, D, generator=g, dtype=dtype)
    return q, k, v, w, causal, window


def _grads(fn, q, k, v, w):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    return (o.detach(),) + torch.autograd.grad((o * w).sum(), leaves)


def _softmax64(q, k, v, causal, window):
    """Attention by a float64 softmax over the masked scores."""
    B, S, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, D),
                     k) * D ** -0.5
    pos = torch.arange(S)
    m = t_attn.make_mask(pos, pos, causal, window)[0, 0] \
        if causal or window else torch.ones(S, S, dtype=torch.bool)
    s = s.masked_fill(~m, float("-inf"))
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(s, -1), v)
    return o.reshape(B, S, H, D)


def _grouped(q, k, v, causal, window):
    pos = torch.arange(q.shape[1])
    mask = t_attn.make_mask(pos, pos, causal, window) \
        if causal or window else None
    return t_attn.grouped_attend(q, k, v, mask)


ROUTES = [
    # (device, dtype, head_dim, cross, by_index) -> route
    (("cuda", torch.float32, 64, False, True), "fused"),
    (("cpu", torch.float32, 64, False, True), "plain"),
    (("cuda", torch.bfloat16, 64, False, True), "plain"),
    (("cuda", torch.float64, 64, False, True), "plain"),
    (("cuda", torch.float32, 128, False, True), "plain"),
    (("cuda", torch.float32, 32, False, True), "plain"),
    (("cuda", torch.float32, 64, True, True), "plain"),
    (("cuda", torch.float32, 64, False, False), "plain"),
    (("meta", torch.float32, 64, False, True), "plain"),
]


@pytest.mark.parametrize("args,want", ROUTES)
def test_route_rule(args, want):
    assert ft.route(*args) == want


def _at(addr, shape, strides, dtype=torch.float32):
    """The tensor of ``shape`` at ``addr`` with element ``strides``, read
    from memory as the kernels read it."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    flat = torch.frombuffer((ctypes.c_float * n).from_address(addr),
                            dtype=dtype)
    return flat.as_strided(shape, strides)


def _unpack(p):
    a = list((ctypes.c_longlong * 14).from_address(p))
    B, H, K, S, T, D, causal, window = a[:8]
    (qb, qh, qs), (kb, kh, ks) = a[8:11], a[11:14]
    assert D in ft.TRAIN_HEAD_DIMS and H % K == 0
    assert all(x % 4 == 0 for x in a[8:14])
    return ((B, S, H, D), (qb, qs, qh, 1), (B, T, K, D), (kb, ks, kh, 1),
            bool(causal), window)


def _lse64(q, k, causal, window):
    """Each query row's log-sum-exp of its valid scaled scores (B, H, S),
    in float64."""
    B, S, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, D),
                     k) * D ** -0.5
    if causal or window:
        pos = torch.arange(S)
        m = t_attn.make_mask(pos, pos, causal, window)[0, 0]
        s = s.masked_fill(~m, float("-inf"))
    return torch.logsumexp(s, -1).reshape(B, H, S)


def _entries(calls):
    """Stand-ins for ``flash_attention_train_forward`` / ``_backward``:
    the C contract (the .cu's entry-point comments), then the same
    results in float64 (O and L by a float64 softmax, the gradients by
    autograd through it), written where the pointers say. The backward
    also holds the L it is handed to the row's log-sum-exp."""
    def forward(q, k, v, out, lse, p, scale, dev, stream):
        qs, ql, ks, kl, causal, window = _unpack(p)
        assert all(x % 16 == 0 for x in (q, k, v, out, lse))
        assert scale == qs[3] ** -0.5
        q64, k64, v64 = (_at(x, s, st).double() for x, s, st in
                         ((q, qs, ql), (k, ks, kl), (v, ks, kl)))
        _at(out, qs, ql).copy_(_softmax64(q64, k64, v64, causal, window))
        B, S, H, _ = qs
        _at(lse, (B, H, S), (H * S, S, 1)).copy_(
            _lse64(q64, k64, causal, window))
        calls.append(("forward", qs, ks, causal, window))
        return 0

    def backward(q, k, v, out, do, lse, delta, dq, dk, dv, p, scale, dev,
                 stream):
        qs, ql, ks, kl, causal, window = _unpack(p)
        B, S, H, _ = qs
        leaves = [_at(x, s, st).double().requires_grad_(True) for x, s, st
                  in ((q, qs, ql), (k, ks, kl), (v, ks, kl))]
        L = _at(lse, (B, H, S), (H * S, S, 1)).double()
        torch.testing.assert_close(
            L, _lse64(*(t.detach() for t in leaves[:2]), causal, window),
            rtol=1e-6, atol=1e-6)
        with torch.enable_grad():           # called inside a backward
            o = _softmax64(*leaves, causal, window)
            g = torch.autograd.grad(o, leaves, _at(do, qs, ql).double())
        for t, shape, st, val in ((dq, qs, ql, g[0]), (dk, ks, kl, g[1]),
                                  (dv, ks, kl, g[2])):
            _at(t, shape, st).copy_(val)
        calls.append(("backward", qs, ks, causal, window))
        return 0
    return forward, backward


@pytest.fixture
def emulated(monkeypatch):
    """The kernel path for CPU tensors, its C entry points stood in for
    by ``_entries``; yields the calls."""
    calls = []
    fwd, bwd = _entries(calls)
    lib = types.SimpleNamespace(flash_attention_train_forward=fwd,
                                flash_attention_train_backward=bwd)
    monkeypatch.setattr(ft, "library",
                        lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(ft, "_on_card", lambda t: True)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    ft._args.cache_clear()
    yield calls
    ft._args.cache_clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_wrappers_through_stand_in(emulated, monkeypatch, case):
    """The kernel path's forward and backward, each entry point stood in
    for, for every mask, group size, ragged length and width: O and the
    three gradients within float32 rounding of autograd through a float64
    softmax and within 5e-6 of autograd through ``grouped_attend`` (float32
    scores); the model's (B, S, H, D) layouts passed by strides; one
    forward launch counted on ``flash_attention`` and two backward launches
    on ``flash_attention.backward``."""
    q, k, v, w, causal, window = _inputs(case, torch.float32)
    monkeypatch.setattr(ft, "TRAIN_HEAD_DIMS", (q.shape[-1],))
    f0, b0 = fa_ops.COUNTER.count, ft.BACKWARD.count
    got = _grads(lambda a, b, c: ft.attention_train(
        a, b, c, causal=causal, window=window), q, k, v, w)
    wide = [t.double() for t in (q, k, v, w)]
    want = _grads(lambda a, b, c: _softmax64(a, b, c, causal, window),
                  *wide)
    grouped = _grads(lambda a, b, c: _grouped(a, b, c, causal, window),
                     *wide)
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, want, grouped):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6)
        assert float((a.double() - c).abs().max()) < 5e-6, name
    assert [c[0] for c in emulated] == ["forward", "backward"]
    assert emulated[0][1:] == (tuple(q.shape), tuple(k.shape), causal,
                               window)
    assert fa_ops.COUNTER.count - f0 == 1 and ft.BACKWARD.count - b0 == 2


REFUSED = {
    # what attention_train raises on, before any launch
    "cpu-tensors": (dict(), "CUDA"),
    "bf16": (dict(dtype=torch.bfloat16), "built for float32"),
    "width-32": (dict(D=32), "built for float32"),
    "k-width": (dict(kD=32), "do not agree"),
    "heads-not-grouped": (dict(K=4), "do not agree"),
    "negative-window": (dict(window=-1), "window"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_attention_train_refuses(monkeypatch, case):
    """``attention_train`` needs CUDA tensors (no CPU path: ``route``
    sends CPU calls to ``grouped_attend``), float32 at a built width, and
    agreeing shapes; it raises before any launch otherwise."""
    kw, match = REFUSED[case]
    calls = []
    if case != "cpu-tensors":
        monkeypatch.setattr(ft, "_on_card", lambda t: True)
        fwd, bwd = _entries(calls)
        monkeypatch.setattr(ft, "library", lambda: types.SimpleNamespace(
            lib=types.SimpleNamespace(flash_attention_train_forward=fwd,
                                      flash_attention_train_backward=bwd)))
    D, dtype = kw.get("D", 64), kw.get("dtype", torch.float32)
    q = torch.randn(1, 8, 6, D, dtype=dtype)
    k = torch.randn(1, 8, kw.get("K", 3), kw.get("kD", D), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ft.attention_train(q, k, k.clone(), causal=True,
                           window=kw.get("window", 0))
    assert calls == []


def test_kernel_wrapper_copies_a_strided_operand(emulated):
    """A q that is a transposed view is made contiguous in (B, S, H, D)
    before the launch; the result is unchanged."""
    q, k, v, w, causal, window = _inputs("causal-g3-d64", torch.float32)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    a = ft.attention_train(qt, k, v, causal=causal, window=window)
    b = ft.attention_train(q, k, v, causal=causal, window=window)
    assert torch.equal(a, b)


def _routes_seen(monkeypatch):
    """Every ``route`` call's (cross, by_index); the route stays plain."""
    seen = []

    def record(device, dtype, head_dim, cross, by_index):
        seen.append((cross, by_index))
        return "plain"
    monkeypatch.setattr(ft, "route", record)
    return seen


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["mlitb-lm-100m", "whisper-large-v3"])
def test_forward_states_its_positions_by_index(monkeypatch, arch, remat):
    """The training forward tells every self-attention call that its
    positions are the sequence's own index, through the block functions
    and ``torch.utils.checkpoint`` (remat) alike, forward and recompute;
    the audio decoder's cross-attention is cross, and stays plain."""
    cfg = get_config(arch).reduced()
    params = t_tf.init_params(cfg, seed=5, device="cpu")
    leaves = [t.requires_grad_(True) for t in params.parameters()]
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(4))
    kw = {}
    if cfg.arch_type == "audio":
        kw["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                   generator=torch.Generator().manual_seed(5))
    seen = _routes_seen(monkeypatch)
    logits, _ = t_tf.forward(params, cfg, tokens, remat=remat, **kw)
    torch.autograd.grad(logits.logsumexp(-1).mean(), leaves,
                        allow_unused=True)
    n_self = cfg.n_layers + getattr(cfg, "n_encoder_layers", 0)
    n_cross = cfg.n_layers if cfg.arch_type == "audio" else 0
    passes = 2 if remat else 1               # remat recomputes each block
    assert sorted(seen) == sorted([(False, True)] * n_self * passes
                                  + [(True, False)] * n_cross * passes)


@pytest.mark.parametrize("kw,want", [
    (dict(), False),                          # not stated: plain
    (dict(by_index=True), True),
    (dict(by_index=True, kv_positions=torch.arange(6, dtype=torch.int32)),
     False),                                  # other key positions
])
def test_attention_takes_by_index_only_when_stated(monkeypatch, kw, want):
    """``attention`` hands ``route`` the ``by_index`` its caller states,
    and only for keys at the queries' own positions."""
    cfg = get_config("mlitb-lm-100m").reduced()
    p = t_tf.init_params(cfg, seed=5, device="cpu")
    bp = {k: v[0] for k, v in p["blocks"]["attn"].items()}
    seen = _routes_seen(monkeypatch)
    x = torch.randn(2, 6, cfg.d_model)
    t_attn.attention(bp, x, torch.arange(6, dtype=torch.int32), **kw)
    assert seen == [(False, want)]


def _attention_before(p, x, positions, *, causal=True, window=0,
                      use_rope=True, rope_theta=10000.0, xkv=None,
                      kv_positions=None, split=False, kv_split=False,
                      by_index=False):
    """``models.attention.attention`` as it was before the fused route:
    always ``grouped_attend`` under ``make_mask``."""
    assert not split
    kv_positions = positions if kv_positions is None else kv_positions
    xkv = x if xkv is None else xkv
    q, k, v = t_attn._project_qkv(p, x, xkv)
    if use_rope:
        cos, sin = rope_tables(positions, q.shape[-1], rope_theta)
        q = rotate(q, cos, sin)
        if kv_positions is not positions:
            cos, sin = rope_tables(kv_positions, q.shape[-1], rope_theta)
        k = rotate(k, cos, sin)
    mask = t_attn.make_mask(positions, kv_positions, causal, window) \
        if (causal or window) else None
    return t_attn._out_proj(p, t_attn.grouped_attend(q, k, v, mask), split)


def _model_run(cfg, tokens):
    """(logits, the gradient of every leaf) of the LM on the CPU."""
    params = t_tf.init_params(cfg, seed=5, device="cpu")
    leaves = [t.requires_grad_(True) for t in params.parameters()]
    logits, _ = t_tf.forward(params, cfg, tokens, remat=False)
    loss = logits.logsumexp(-1).mean()
    return logits.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("window", [0, 6])
def test_model_on_cpu_unchanged(monkeypatch, window):
    """The LM's CPU forward and gradients equal, bit for bit, those of the
    attention as it was (``grouped_attend`` under ``make_mask``), with and
    without a sliding window; every call counted as plain."""
    cfg = dataclasses.replace(get_config("mlitb-lm-100m").reduced(),
                              sliding_window=window)
    tokens = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(2))
    f0, p0 = t_attn.FUSED_CALLS.count, t_attn.PLAIN_CALLS.count
    now = _model_run(cfg, tokens)
    assert t_attn.FUSED_CALLS.count == f0
    assert t_attn.PLAIN_CALLS.count - p0 == cfg.n_layers
    monkeypatch.setattr(t_attn, "attention", _attention_before)
    before = _model_run(cfg, tokens)
    assert torch.equal(now[0], before[0])
    assert len(now[1]) == len(before[1])
    assert all(torch.equal(a, b) for a, b in zip(now[1], before[1]))


def test_model_fused_route_through_stand_in(emulated, monkeypatch):
    """With the route open to CPU tensors and the entry points stood in
    for, the LM's attention takes the fused function in every layer:
    logits and gradients within float32 rounding of the plain route, one
    forward and one backward call a layer."""
    cfg = get_config("mlitb-lm-100m").reduced()
    monkeypatch.setattr(ft, "TRAIN_HEAD_DIMS", (cfg.head_dim,))
    tokens = torch.randint(0, cfg.vocab_size, (2, 13),
                           generator=torch.Generator().manual_seed(3))
    plain = _model_run(cfg, tokens)
    monkeypatch.setattr(ft, "route", lambda *a: "fused")
    f0 = t_attn.FUSED_CALLS.count
    fused = _model_run(cfg, tokens)
    assert t_attn.FUSED_CALLS.count - f0 == cfg.n_layers
    assert [c[0] for c in emulated] == ["forward"] * cfg.n_layers \
        + ["backward"] * cfg.n_layers
    torch.testing.assert_close(fused[0], plain[0], rtol=1e-4, atol=1e-5)
    for a, b in zip(fused[1], plain[1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
