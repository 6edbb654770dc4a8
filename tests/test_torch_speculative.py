"""Port parity for speculative decoding: the draft program, the verify
shape of ``prefill_chunk(_paged)(all_logits=True)``, the engine's
speculative rounds (dense slot cache and paged pool), their simulated
clock under hot swaps, the configuration checks and the launchers'
``--speculative``, against the JAX package on the CPU. Weights, the
draft's included, are JAX draws carried across with ``params_from_jax``.

Token streams and every counter are compared for equality; logits
within 1e-5 (relative and absolute, float32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.simulation import ServeCostModel as JCost  # noqa: E402
from repro.core.simulation import generate_requests  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import PagingConfig as JPagingConfig  # noqa: E402
from repro.serving import SamplingConfig as JSamplingConfig  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import SpeculativeConfig as JSpec  # noqa: E402
from repro.train.step import build_draft_program as j_draft  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.simulation import ServeCostModel  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import (PagingConfig, SamplingConfig,  # noqa: E402
                                 ServingConfig, ServingEngine,
                                 SpeculativeConfig, pow2_bucket)
from repro_torch.serving import generate_requests as t_generate  # noqa: E402
from repro_torch.train.step import build_draft_program  # noqa: E402

ARCH = "mlitb-lm-100m"
TOL = 1e-5
K, WINDOW = 3, 16
SERVE = dict(max_batch=4, max_seq=64, prompt_cap=16)
LOAD = dict(rate_rps=200.0, prompt_rng=(4, 12), gen_short=(2, 6),
            gen_long=(8, 16), long_frac=0.3, shared_prefix=(2, 16, 0.8),
            seed=9)


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draft_cfgs():
    cfg = get_config(ARCH).reduced()
    return (dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1),
            dataclasses.replace(t_get_config(ARCH).reduced(),
                                name=cfg.name + "-draft", n_layers=1))


@pytest.fixture(scope="module")
def model():
    """Target (seed 0) and a 1-layer draft (seed 2), both sides."""
    cfg, tcfg = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    dcfg, tdcfg = _draft_cfgs()
    jp = j_tf.init_params(jax.random.PRNGKey(0), cfg)
    jd = j_tf.init_params(jax.random.PRNGKey(2), dcfg)
    return dict(cfg=cfg, tcfg=tcfg, dcfg=dcfg, tdcfg=tdcfg, jp=jp, jd=jd,
                tp=params_from_jax(_np(jp), tcfg, device="cpu"),
                td=params_from_jax(_np(jd), tdcfg, device="cpu"))


def _streams(stats):
    return {c.rid: c.tokens.tolist() for c in stats.completions}


def _counters(stats):
    return (stats.drafted, stats.accepted, stats.spec_rounds,
            stats.decode_dispatches)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
def test_draft_program_proposals_bit_equal(model):
    rng = np.random.RandomState(3)
    B = 5
    toks = rng.randint(0, model["cfg"].vocab_size,
                       size=(B, WINDOW)).astype(np.int32)
    # full history (W - k), short ones, one token, and rows past W - k
    # where the JAX program's clips bite
    hlen = np.asarray([WINDOW - K, 4, 1, WINDOW - 1, WINDOW], np.int32)
    want = np.asarray(j_draft(model["dcfg"], k=K, window=WINDOW)(
        model["jd"], jnp.asarray(toks), jnp.asarray(hlen)))
    got = build_draft_program(model["tdcfg"], k=K, window=WINDOW)(
        model["td"], torch.tensor(toks), torch.tensor(hlen))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, K)
    assert np.array_equal(got.numpy(), want)


def _dense_cache(rng, cfg, B, T):
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
    return {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}


def _t_cache(cache):
    return {"layers": {n: torch.tensor(a) for n, a in cache.items()}}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_chunk_all_logits(model, paged):
    cfg, tcfg, jp, tp = model["cfg"], model["tcfg"], model["jp"], model["tp"]
    rng = np.random.RandomState(4)
    B, C = 4, 4
    tokens = rng.randint(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    off = np.asarray([5, 0, 17, 0], np.int32)
    clen = np.asarray([4, 3, 1, 0], np.int32)
    if paged:
        N, ps, P = 24, 8, 4
        cache = _dense_cache(rng, cfg, N, ps)       # (L, N, ps, ..) pool
        rmap = np.full((B, P), N, np.int32)
        for b in range(B - 1):
            rmap[b, :3] = rng.permutation(N)[:3]
        wmap = rmap.copy()
        extra = (rmap, wmap)
        jfn, tfn = j_tf.prefill_chunk_paged, t_tf.prefill_chunk_paged
    else:
        cache = _dense_cache(rng, cfg, B, 32)
        extra = ()
        jfn, tfn = j_tf.prefill_chunk, t_tf.prefill_chunk
    jcache = jax.tree.map(jnp.asarray, {"layers": cache})
    jl, jc = jfn(jp, cfg, tokens, off, clen, jcache, *extra, all_logits=True)
    targs = (torch.tensor(tokens), torch.tensor(off), torch.tensor(clen))
    textra = tuple(torch.tensor(a) for a in extra)
    tl, tc = tfn(tp, tcfg, *targs, _t_cache(cache), *textra, all_logits=True)
    assert tuple(tl.shape) == (B, C, cfg.vocab_size)
    live = clen > 0
    _close(tl[live], np.asarray(jl)[live])
    for n in ("k", "v"):
        _close(tc["layers"][n], jc["layers"][n])
    # column clen-1 of the verify shape is the default path, bit for bit
    one, _ = tfn(tp, tcfg, *targs, _t_cache(cache), *textra)
    idx = torch.tensor(np.maximum(clen - 1, 0)).long()
    assert torch.equal(tl[torch.arange(B), idx], one[:, 0])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_spec_runs(model):
    """The JAX engine's speculative closed-loop run per layout."""
    reqs = generate_requests(14, vocab_size=model["cfg"].vocab_size, **LOAD)
    out = {}
    for paged in (False, True):
        spec = JSpec(draft_params=model["jd"], draft_cfg=model["dcfg"],
                     k=K, window=WINDOW)
        eng = JServingEngine(model["jp"], model["cfg"], serving=JServingConfig(
            **SERVE, speculative=spec,
            paging=JPagingConfig(page_size=8) if paged else None))
        out[paged] = (eng.run_closed_loop(reqs), eng.verify_buckets_seen)
    return out


def _no_decode(eng):
    """Make the engine's plain decode program raise: a speculative engine
    must never call it."""
    def boom(*a, **kw):
        raise AssertionError("decode dispatched in speculative mode")
    eng._programs = dataclasses.replace(eng._programs, decode=boom)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_speculative_matches_jax(model, jax_spec_runs, paged):
    want, want_buckets = jax_spec_runs[paged]
    reqs = t_generate(14, vocab_size=model["cfg"].vocab_size, **LOAD)
    paging = PagingConfig(page_size=8) if paged else None
    spec = SpeculativeConfig(draft_params=model["td"],
                             draft_cfg=model["tdcfg"], k=K, window=WINDOW)
    eng = ServingEngine(model["tp"], model["tcfg"], serving=ServingConfig(
        **SERVE, speculative=spec, paging=paging), device="cpu")
    _no_decode(eng)
    st = eng.run_closed_loop(reqs)
    assert _streams(st) == _streams(want)
    assert _counters(st) == _counters(want)
    assert st.drafted > 0 and st.spec_rounds > 0
    assert eng.verify_buckets_seen == want_buckets \
        == [(SERVE["max_batch"], pow2_bucket(K + 1))]
    if paged:
        assert st.prefix_hits == want.prefix_hits > 0
    # ... and the port's own non-speculative engine serves the same
    plain = ServingEngine(model["tp"], model["tcfg"], serving=ServingConfig(
        **SERVE, paging=paging), device="cpu")
    assert _streams(plain.run_closed_loop(reqs)) == _streams(st)


def test_perfect_draft_accepts_everything(model):
    """Draft == target with a window covering the whole history: every
    draft matches, so each round advances k + 1 tokens."""
    rng = np.random.RandomState(32)
    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(rid=i, prompt=rng.randint(
        0, model["cfg"].vocab_size, size=rng.randint(3, 9)).astype(np.int32),
        max_new=int(rng.randint(4, 12))) for i in range(8)]
    spec = SpeculativeConfig(draft_params=model["tp"],
                             draft_cfg=model["tcfg"], k=4, window=32)
    base = ServingEngine(model["tp"], model["tcfg"],
                         serving=ServingConfig(**SERVE), device="cpu")
    eng = ServingEngine(model["tp"], model["tcfg"], serving=ServingConfig(
        **SERVE, speculative=spec), device="cpu")
    ref, st = base.run_closed_loop(reqs), eng.run_closed_loop(reqs)
    assert _streams(st) == _streams(ref)
    assert st.drafted > 0 and st.accepted == st.drafted
    assert st.decode_dispatches < ref.decode_dispatches


# ---------------------------------------------------------------------------
# the simulated clock under hot swaps
# ---------------------------------------------------------------------------
SIM_LOAD = dict(rate_rps=60.0, vocab_size=128, prompt_rng=(4, 24),
                gen_short=(2, 6), gen_long=(8, 14), long_frac=0.3, seed=3)
SIM_SWAPS = (0.1, 0.2, 0.25)


def _record_steps(eng):
    """Wrap ``eng.step`` to log (verify dispatches, draft dispatches) per
    step — with one verify per live version, the per-version split."""
    log = []
    step = eng.step

    def wrapped(*a, **kw):
        rep = step(*a, **kw)
        log.append((len(rep.verify_shapes), rep.draft_dispatches))
        return rep
    eng.step = wrapped
    return log


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_run_simulated_speculative_with_swaps_matches_jax(paged):
    jcfg, tcfg = j_tiny(), tiny_cfg()
    trees = [j_tf.init_params(jax.random.PRNGKey(s), jcfg) for s in (0, 1)]
    jd = j_tf.init_params(jax.random.PRNGKey(5), jcfg)
    kw = dict(max_batch=4, max_seq=64, prompt_cap=16,
              page_size=8 if paged else None)
    reqs = generate_requests(20, **SIM_LOAD)

    jeng = JServingEngine(trees[0], jcfg, serving=JServingConfig.from_flat(
        **kw, speculative=JSpec(draft_params=jd, draft_cfg=jcfg, k=2,
                                window=16)))
    jlog = _record_steps(jeng)
    want = jeng.run_simulated(reqs, JCost(), swaps=[
        (t, trees[(i + 1) % 2], i + 1) for i, t in enumerate(SIM_SWAPS)])

    tp = [params_from_jax(_np(t), tcfg, device="cpu") for t in trees]
    spec = SpeculativeConfig(
        draft_params=params_from_jax(_np(jd), tcfg, device="cpu"),
        draft_cfg=tcfg, k=2, window=16)
    teng = ServingEngine(tp[0], tcfg, serving=ServingConfig.from_flat(
        **kw, speculative=spec), device="cpu")
    tlog = _record_steps(teng)
    got = teng.run_simulated(t_generate(20, **SIM_LOAD), ServeCostModel(),
                             swaps=[(t, tp[(i + 1) % 2], i + 1)
                                    for i, t in enumerate(SIM_SWAPS)])

    key = (lambda c: (c.rid, c.version, c.finish, c.latency,
                      c.tokens.tolist()))
    assert sorted(map(key, got.completions)) \
        == sorted(map(key, want.completions))
    assert (got.makespan, got.p50_latency, got.p95_latency) \
        == (want.makespan, want.p50_latency, want.p95_latency)
    assert _counters(got) == _counters(want)
    assert got.versions_served == want.versions_served
    assert len(got.versions_served) >= 3        # the swaps bit mid-run
    assert tlog == jlog
    assert any(v > 1 for v, _ in tlog)          # a mixed-version round


# ---------------------------------------------------------------------------
# configuration checks and launchers
# ---------------------------------------------------------------------------
def _msg(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


def test_config_checks_match_reference_messages(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    for kw in (dict(k=0, window=8), dict(k=4, window=4)):
        assert _msg(lambda: SpeculativeConfig(draft_params={}, draft_cfg=tcfg,
                                              **kw)) \
            == _msg(lambda: JSpec(draft_params={}, draft_cfg=cfg, **kw))
    jspec = JSpec(draft_params={}, draft_cfg=cfg, k=8, window=16)
    tspec = SpeculativeConfig(draft_params={}, draft_cfg=tcfg, k=8, window=16)
    for kw in (dict(prompt_cap=8), dict(max_seq=8)):
        base = {**dict(max_batch=4, max_seq=64), **kw}
        assert _msg(lambda: ServingConfig(**base, speculative=tspec)) \
            == _msg(lambda: JServingConfig(**base, speculative=jspec))
    assert _msg(lambda: ServingConfig(
        max_batch=4, max_seq=64, speculative=tspec,
        sampling=SamplingConfig(temperature=0.5))) \
        == _msg(lambda: JServingConfig(
            max_batch=4, max_seq=64, speculative=jspec,
            sampling=JSamplingConfig(temperature=0.5)))
    assert ServingConfig.from_flat(max_batch=4, max_seq=64,
                                   speculative=tspec).speculative is tspec
    # the engine's draft checks: vocabulary and family
    small = dataclasses.replace(model["tdcfg"], vocab_size=256)
    jsmall = dataclasses.replace(model["dcfg"], vocab_size=256)
    for tdc, jdc in ((small, jsmall),
                     (dataclasses.replace(model["tdcfg"], arch_type="ssm"),
                      dataclasses.replace(model["dcfg"], arch_type="ssm"))):
        got = _msg(lambda: ServingEngine(
            model["tp"], tcfg, device="cpu", serving=ServingConfig(
                max_batch=2, max_seq=32, speculative=SpeculativeConfig(
                    draft_params=model["td"], draft_cfg=tdc, k=2,
                    window=8))))
        want = _msg(lambda: JServingEngine(
            model["jp"], cfg, serving=JServingConfig(
                max_batch=2, max_seq=32, speculative=JSpec(
                    draft_params=model["jd"], draft_cfg=jdc, k=2,
                    window=8))))
        assert got == want


def test_launchers_speculative_on_cpu(capsys):
    from repro_torch.launch import serve, train_serve
    assert serve.main(["--arch", ARCH, "--reduced", "--requests", "4",
                       "--max-batch", "2", "--max-seq", "64",
                       "--page-size", "8", "--speculative", "2",
                       "--draft-window", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "speculative: drafted" in out and "verify buckets [(2, 4)]" in out
    assert train_serve.main(["--device", "cpu", "--iterations", "4",
                             "--requests", "12", "--speculative", "2"]) == 0
    out = capsys.readouterr().out
    assert "speculative: drafted" in out and "requests" in out
