"""Port parity for serving a MoE model through the continuous-batching
engine, against the JAX package's engine on the CPU: the serving tests'
``TINY_MOE`` (4 experts, top-2, capacity 4.0) on the dense slot cache
and the paged pool with chunked prefill; speculative decoding with a
dense draft over the MoE target and with a MoE draft; and a tight
capacity factor (1.0), where the padded tail of a ragged prefill chunk
is routed too and tokens drop, with the reference's capacity warning.
JAX weights carried across with ``params_from_jax``.

Greedy token streams and the engine's counters are compared for
equality.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JArch  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core.simulation import generate_requests  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import PagingConfig as JPagingConfig  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import SpeculativeConfig as JSpec  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serving import (PagingConfig, ServingConfig,  # noqa: E402
                                 ServingEngine, SpeculativeConfig)
from repro_torch.serving import generate_requests as t_generate  # noqa: E402

DENSE = dict(name="tiny-dense", arch_type="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=61, head_dim=16,
             param_dtype="float32", activ_dtype="float32",
             tie_embeddings=True)
MOE = dict(DENSE, name="tiny-moe", arch_type="moe", n_kv_heads=2)
MOE_SUB = dict(n_experts=4, experts_per_token=2, d_ff_expert=32,
               capacity_factor=4.0)
SERVE = dict(max_batch=4, max_seq=32, prompt_cap=8)
LOAD = dict(rate_rps=200.0, prompt_rng=(1, 12), gen_short=(1, 6),
            gen_long=(8, 14), long_frac=0.3, seed=5)
N_REQ = 12
K, WINDOW = 2, 16


def _cfgs(cf=4.0, n_layers=2, dense=False):
    if dense:
        return JArch(**DENSE), ArchConfig(**DENSE)
    sub = dict(MOE_SUB, capacity_factor=cf)
    kw = dict(MOE, n_layers=n_layers,
              name=MOE["name"] + ("-draft" if n_layers == 1 else ""))
    return (JArch(**kw, moe=JMoE(**sub)),
            ArchConfig(**kw, moe=MoEConfig(**sub)))


def _pair(seed, **kw):
    cfg, tcfg = _cfgs(**kw)
    jp = j_tf.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu")


@pytest.fixture(scope="module")
def model():
    return {"target": _pair(0), "dense_draft": _pair(5, dense=True),
            "moe_draft": _pair(6, n_layers=1)}


def _reqs(vocab):
    return (generate_requests(N_REQ, vocab_size=vocab, **LOAD),
            t_generate(N_REQ, vocab_size=vocab, **LOAD))


def _streams(stats):
    return {c.rid: c.tokens.tolist() for c in stats.completions}


def _counters(stats):
    return (stats.n_requests, stats.gen_tokens, stats.decode_dispatches,
            stats.prefill_chunks, stats.drafted, stats.accepted,
            stats.spec_rounds)


def _run_both(jp, tp, cfg, tcfg, paged, spec=None, **serve):
    """One schedule through the JAX engine and the port's; returns
    (JAX stats, port stats, port engine)."""
    jreqs, treqs = _reqs(cfg.vocab_size)
    jspec = tspec = None
    if spec is not None:
        (dcfg, tdcfg, jd, td) = spec
        jspec = JSpec(draft_params=jd, draft_cfg=dcfg, k=K, window=WINDOW)
        tspec = SpeculativeConfig(draft_params=td, draft_cfg=tdcfg, k=K,
                                  window=WINDOW)
    s = dict(SERVE, **serve)
    jeng = JServingEngine(jp, cfg, serving=JServingConfig(
        **s, paging=JPagingConfig(page_size=8) if paged else None,
        speculative=jspec))
    teng = ServingEngine(tp, tcfg, serving=ServingConfig(
        **s, paging=PagingConfig(page_size=8) if paged else None,
        speculative=tspec), device="cpu")
    return jeng.run_closed_loop(jreqs), teng.run_closed_loop(treqs), teng


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_jax(model, paged):
    cfg, tcfg, jp, tp = model["target"]
    want, got, _ = _run_both(jp, tp, cfg, tcfg, paged)
    assert got.n_requests == N_REQ
    assert _streams(got) == _streams(want)
    assert _counters(got) == _counters(want)
    # some prompts are longer than the prompt cap: they prefill in chunks
    assert max(len(r.prompt) for r in _reqs(cfg.vocab_size)[1]) \
        > SERVE["prompt_cap"]
    # the plain decode path serves the same stream
    plain = ServingEngine(tp, tcfg, serving=ServingConfig(
        **SERVE, decode_kernel="plain",
        paging=PagingConfig(page_size=8) if paged else None), device="cpu")
    assert _streams(plain.run_closed_loop(_reqs(cfg.vocab_size)[1])) \
        == _streams(got)


@pytest.mark.parametrize("draft", ["dense_draft", "moe_draft"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_over_moe(model, draft, paged):
    """A dense draft over the MoE target, and a 1-layer MoE draft: the
    streams and counters of the JAX engine, and the plain greedy
    stream."""
    cfg, tcfg, jp, tp = model["target"]
    dcfg, tdcfg, jd, td = model[draft]
    want, got, _ = _run_both(jp, tp, cfg, tcfg, paged,
                             spec=(dcfg, tdcfg, jd, td))
    assert _streams(got) == _streams(want)
    assert _counters(got) == _counters(want)
    assert got.drafted > 0 and got.spec_rounds > 0
    base = ServingEngine(tp, tcfg, serving=ServingConfig(**SERVE),
                         device="cpu")
    assert _streams(base.run_closed_loop(_reqs(cfg.vocab_size)[1])) \
        == _streams(got)


def test_tight_capacity_routes_the_padded_tail(model, monkeypatch):
    """Capacity factor 1.0 (below E/k = 2): prefill chunks are padded to
    their bucket and the padded tail is routed and counted against the
    capacity, so tokens drop; the port drops the same ones (streams
    equal) and warns as the reference does."""
    cfg, tcfg, jp, tp = _pair(0, cf=1.0)
    dropped = []
    dispatch = t_moe.dispatch_combine

    def counting(x, gates, idx, c, cap, dtype=None):
        disp, comb = dispatch(x, gates, idx, c, cap, dtype)
        dropped.append(idx.numel() - int(disp.sum()))
        return disp, comb
    monkeypatch.setattr(t_moe, "dispatch_combine", counting)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        JServingEngine(jp, cfg, serving=JServingConfig(**SERVE))
    with pytest.warns(UserWarning, match="capacity_factor=1.0 can bind") \
            as tw:
        ServingEngine(tp, tcfg, serving=ServingConfig(**SERVE),
                      device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    for paged in (False, True):
        dropped.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, got, _ = _run_both(jp, tp, cfg, tcfg, paged)
        assert _streams(got) == _streams(want)
        assert _counters(got) == _counters(want)
        assert sum(dropped) > 0


def test_engine_rejects_the_recurrent_families(model):
    _, tcfg, _, tp = model["target"]
    for arch_type in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="attention-cached"):
            ServingEngine(tp, dataclasses.replace(tcfg, arch_type=arch_type),
                          serving=ServingConfig(**SERVE), device="cpu")
