"""The port's hot swap, version ring and sampling, on the CPU at
``tiny_cfg()``:

  - a paged engine with prefix reuse under timed swaps, against the JAX
    engine on the same weights (``params_from_jax``): streams, versions,
    prefix hits and clocks equal;
  - ``swap_params`` validation, the ring's lifecycle, and KV pages that
    belong to one version: a request admitted under v2 never reuses
    pages written under v0, and a retired version's trie generation is
    dropped;
  - mixed-version decode steps (dense and paged): every completion equals
    a solo replay under its pinned version, so rows outside a dispatch's
    version group neither advance nor write their KV;
  - published trees are snapshots: later reduce steps leave them bitwise
    unchanged;
  - sampling by invariants (the port cannot draw ``jax.random``'s bits):
    temperature 0 is the argmax, ``top_k=1`` is greedy, a row sampled
    alone equals itself in a batch, exactly k candidates survive ties,
    and a seeded chi-square test of the draws against the softmax passes
    (df 7, statistic below 24.32, the 0.001 critical value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.simulation import ServeCostModel as JCost  # noqa: E402
from repro.core.simulation import generate_requests  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.core import PublishConfig, TrainingConfig  # noqa: E402
from repro_torch.core.flatbuf import tree_paths  # noqa: E402
from repro_torch.core.simulation import ServeCostModel  # noqa: E402
from repro_torch.launch.train_serve import build_training  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402
from repro_torch.serving import (ServeRequest, ServingConfig,  # noqa: E402
                                 ServingEngine, generate_requests as t_gen)
from repro_torch.serving.sampling import sample_tokens  # noqa: E402

# shared system prompts, so prefix reuse meets the version ring
LOAD = dict(rate_rps=80.0, vocab_size=128, prompt_rng=(4, 12),
            gen_short=(2, 6), gen_long=(8, 14), long_frac=0.3,
            shared_prefix=(2, 16, 0.8), seed=5)
PAGED = dict(max_batch=4, max_seq=64, prompt_cap=16, page_size=8)
SWAPS = (0.05, 0.12, 0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """Two JAX weight draws as numpy, and the JAX engine's paged run with
    prefix reuse under swaps that alternate between them."""
    cfg = j_tiny()
    jt = [j_tf.init_params(jax.random.PRNGKey(s), cfg) for s in (0, 1)]
    eng = JServingEngine(jt[0], cfg, serving=JServingConfig.from_flat(
        **PAGED))
    stats = eng.run_simulated(
        generate_requests(20, **LOAD), JCost(),
        swaps=[(t, jt[(i + 1) % 2], i + 1) for i, t in enumerate(SWAPS)])
    return [jax.tree.map(np.asarray, t) for t in jt], stats


def _params(trees, i):
    return params_from_jax(trees[0][i], tiny_cfg(), device="cpu")


def _engine(params, **kw):
    return ServingEngine(params, tiny_cfg(),
                         serving=ServingConfig.from_flat(**kw), device="cpu")


def _solo(params, req, **kw):
    eng = _engine(params, **dict(dict(max_batch=1, max_seq=64), **kw))
    return eng.run_closed_loop([ServeRequest(
        rid=req.rid, prompt=req.prompt, max_new=req.max_new)]
    ).completions[0].tokens.tolist()


class _MixedSteps:
    """Counts decode steps that dispatched more than one version."""

    def __init__(self, eng):
        self.n = 0
        inner = eng._step_decode

        def counted(*a):
            vers = {eng._slots[s].ver for s in range(eng.max_batch)
                    if eng._live[s]}
            self.n += len(vers) > 1
            return inner(*a)
        eng._step_decode = counted


def test_paged_prefix_reuse_under_swaps_matches_jax(trees):
    want = trees[1]
    params = [_params(trees, i) for i in (0, 1)]
    eng = _engine(params[0], **PAGED)
    st = eng.run_simulated(
        t_gen(20, **LOAD), ServeCostModel(),
        swaps=[(t, params[(i + 1) % 2], i + 1) for i, t in enumerate(SWAPS)])
    assert (st.swap_count, st.versions_served, st.prefix_hits,
            st.reused_tokens, st.pages_peak, st.makespan) \
        == (want.swap_count, want.versions_served, want.prefix_hits,
            want.reused_tokens, want.pages_peak, want.makespan)
    key = (lambda c: (c.rid, c.version, c.finish, c.latency,
                      c.tokens.tolist()))
    assert sorted(map(key, st.completions)) \
        == sorted(map(key, want.completions))
    assert len(st.versions_served) == 4 and st.prefix_hits > 0
    # the ring kept only the latest once the run drained; its trie
    # generation is all that holds pages
    assert eng.live_versions == [3]
    assert eng.pages_free + eng.trie_pages == eng.n_pages


def test_swap_params_validation_and_ring(trees):
    p0, p1 = _params(trees, 0), _params(trees, 1)
    eng = _engine(p0, max_batch=2, max_seq=32)
    assert eng.live_versions == [0] and eng.params is p0
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"embed": p1["embed"]})
    bad = {k: v for k, v in p1.items()}
    bad["embed"] = p1["embed"][:, :-1]
    with pytest.raises(ValueError, match="leaf embed"):
        eng.swap_params(bad)
    bad["embed"] = p1["embed"].double()
    with pytest.raises(ValueError, match="float64"):
        eng.swap_params(bad)
    assert eng.swap_params(p1) == 1 and eng.live_versions == [1]
    with pytest.raises(ValueError, match="must exceed"):
        eng.swap_params(p0, version=1)
    assert eng.swap_params(p0, version=7) == 7 and eng.swap_count == 2
    # a pinned version stays in the ring until its last slot completes
    req = ServeRequest(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new=4)
    eng.submit(req)
    eng.step()
    eng.swap_params(p1)
    assert eng.live_versions == [7, 8]
    while eng.has_work:
        done = eng.step().completed
    assert done[0].version == 7 and eng.live_versions == [8]
    assert ServingConfig.from_flat(max_batch=1, max_seq=8,
                                   start_version=5).start_version == 5


def test_kv_pages_belong_to_their_version(trees):
    p0, p1 = _params(trees, 0), _params(trees, 1)
    eng = _engine(p0, max_batch=2, max_seq=64, page_size=8)
    prompt = np.arange(3, 30, dtype=np.int32)      # 3 whole pages + 3
    mk = (lambda rid: ServeRequest(rid=rid, prompt=prompt, max_new=3))
    eng.run_closed_loop([mk(0)])
    assert eng.trie_pages == 3 and eng.prefix_hits == 0
    again = eng.run_closed_loop([mk(1)])          # same version: reuse
    assert again.prefix_hits == 1
    # a request admitted under v2 while v0 is pinned: no reuse of v0 pages
    eng._begin_run()
    eng.submit(mk(2))
    eng.step()                                    # rid 2 pins v0
    eng.swap_params(p1, version=2)
    eng.submit(mk(3))
    while eng.has_work:
        eng.step()
    assert eng.prefix_hits == 1                   # rid 2's hit only
    assert eng.live_versions == [2]
    # v0 retired with rid 2: its generation left the trie; v2's stays
    assert eng.trie_pages == 3
    assert eng.pages_free + eng.trie_pages == eng.n_pages
    st = eng.run_closed_loop([mk(4)])
    assert st.prefix_hits == 1 and st.completions[0].version == 2
    # the v2 stream is v2's own: a fresh engine on p1 serves the same
    assert st.completions[0].tokens.tolist() == _solo(p1, mk(4))
    assert eng.flush_prefix_cache() == 3 and eng.trie_pages == 0


@pytest.mark.parametrize("layout", [
    dict(), dict(page_size=8), dict(page_size=8, decode_kernel="plain")],
    ids=["dense-flash", "paged-flash", "paged-plain"])
def test_mixed_version_steps_replay_solo(trees, layout):
    params = [_params(trees, i) for i in (0, 1)]
    kw = dict(max_batch=4, max_seq=64, prompt_cap=16, **layout)
    eng = _engine(params[0], **kw)
    mixed = _MixedSteps(eng)
    reqs = t_gen(16, **dict(LOAD, rate_rps=200.0, shared_prefix=None))
    st = eng.run_simulated(reqs, ServeCostModel(),
                           swaps=[(0.05, params[1], 1),
                                  (0.1, params[0], 2)])
    assert mixed.n > 0 and len(st.versions_served) == 3
    by_rid = {r.rid: r for r in reqs}
    for c in st.completions:
        p = params[c.version % 2]
        assert c.tokens.tolist() == _solo(p, by_rid[c.rid], **layout), \
            (c.rid, c.version)


def test_published_trees_are_snapshots():
    """The reducer hands ``publish_fn`` views of its flat buffer; later
    reduce steps must not write into them."""
    held = []
    loop, _, _ = build_training(
        tiny_cfg(), training=TrainingConfig(
            T=0.5, publish=PublishConfig(
                every=1, fn=lambda p, v, t: held.append(p))),
        seed=0, device="cpu")
    loop.run(2)
    frozen = [{path: x.clone() for path, x in tree_paths(p)} for p in held]
    loop.run(3)
    assert len(held) == 5 and loop.reducer.step >= 3
    for p, f in zip(held, frozen):
        for path, x in tree_paths(p):
            assert torch.equal(x.view(torch.int32), f[path].view(torch.int32))
    moved = [not torch.equal(held[0]["embed"], p["embed"]) for p in held[2:]]
    assert any(moved)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _draw(logits, T, k, n, seed=0):
    """n draws from one logits row: rows differ only by token index."""
    lg = torch.as_tensor(logits, dtype=torch.float32).expand(n, -1)
    return sample_tokens(lg, torch.full((n,), 11, dtype=torch.int64),
                         torch.arange(n, dtype=torch.int64), temperature=T,
                         top_k=k, seed=seed).numpy()


def test_sampler_argmax_top1_and_exact_k_under_ties():
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(6, 50).astype(np.float32))
    logits[2, [4, 9, 30]] = 9.0                        # tied maxima
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    assert int(greedy[2]) == 4
    rids = torch.arange(6, dtype=torch.int64)
    gidx = torch.zeros(6, dtype=torch.int64)
    for T in (0.5, 1.0, 3.0):
        assert torch.equal(sample_tokens(logits, rids, gidx, temperature=T,
                                         top_k=1, seed=3), greedy)
    assert torch.equal(sample_tokens(logits, rids, gidx, temperature=0.0,
                                     top_k=7, seed=3), greedy)
    # ten tied maxima, k = 3: only the three lowest indices survive, and
    # each of them is drawn
    row = np.full(40, -1.0, np.float32)
    row[[2, 5, 6, 11, 17, 20, 23, 31, 35, 39]] = 4.0
    got = set(_draw(row, 1.0, 3, 600).tolist())
    assert got == {2, 5, 6}


@pytest.mark.parametrize("k", [0, 5])
def test_sampler_draws_follow_the_softmax(k):
    logits = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2],
                      np.float32)
    T, n = 0.8, 20000
    draws = _draw(logits, T, k, n, seed=7)
    p = np.exp(logits / T - np.max(logits / T))
    if k:
        p[np.argsort(-logits, kind="stable")[k:]] = 0.0
    p /= p.sum()
    counts = np.bincount(draws, minlength=8)
    assert counts[p == 0].sum() == 0
    expect = n * p[p > 0]
    chi2 = float((((counts[p > 0] - expect) ** 2) / expect).sum())
    assert chi2 < 24.32, (chi2, counts, expect)


def test_sampled_row_alone_equals_itself_in_a_batch(trees):
    p0 = _params(trees, 0)
    reqs = t_gen(6, **dict(LOAD, shared_prefix=None))
    kw = dict(max_seq=64, prompt_cap=16, temperature=0.8, top_k=20,
              sample_seed=4)
    batched = _engine(p0, max_batch=4, **kw).run_closed_loop(reqs)
    got = {c.rid: c.tokens.tolist() for c in batched.completions}
    for r in reqs:
        assert _solo(p0, r, **kw) == got[r.rid]
    # the draws are not the argmax everywhere, and top_k=1 is greedy
    greedy = _engine(p0, max_batch=4, max_seq=64, prompt_cap=16
                     ).run_closed_loop(reqs)
    want = {c.rid: c.tokens.tolist() for c in greedy.completions}
    assert got != want
    top1 = _engine(p0, max_batch=4, **dict(kw, top_k=1)).run_closed_loop(reqs)
    assert {c.rid: c.tokens.tolist() for c in top1.completions} == want
