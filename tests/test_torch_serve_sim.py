"""Port parity for the simulated serving clock and backpressure:
``ServeCostModel``, ``SimulatedServeSession`` / ``run_simulated`` with
timed hot swaps, the admission queue's sheds (``reject``,
``drop_oldest``, admission deadlines) and ``simulate_static_batches`` of
``repro_torch`` against the JAX package, on the CPU, at ``tiny_cfg()``
with the JAX side's weights carried across (``params_from_jax``).

Every clock here is exact arithmetic on the host, so the comparisons are
equality, not tolerance: completion finish times and latencies, shed
records (rid, reason, clock), makespan, p50/p95 and every counter. The
streams are greedy and equal token for token (the JAX engine's ``"xla"``
decode against the port's ``"plain"``; with paging the cost charge does
not depend on the kernel, so the port's ``"flash"`` runs there).
"""
import dataclasses

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
from repro.serving import simulate_static_batches as j_static  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulation import ServeCostModel  # noqa: E402
from repro_torch.launch.train_serve import tiny_cfg  # noqa: E402
from repro_torch.serving import (ServeRequest, ServingConfig,  # noqa: E402
                                 ServingEngine, SimulatedServeSession,
                                 generate_requests as t_generate,
                                 simulate_static_batches)

LOAD = dict(rate_rps=60.0, vocab_size=128, prompt_rng=(4, 24),
            gen_short=(2, 6), gen_long=(8, 14), long_frac=0.3, seed=3)
# the backpressure cases: arrivals faster than two slots drain them
OVERLOAD = dict(LOAD, rate_rps=400.0)
N_REQ = 24
# (name, ServingConfig.from_flat kwargs, port decode kernel, swap times)
CASES = {
    "swaps-dense": (dict(max_batch=4, max_seq=64, prompt_cap=16),
                    "plain", (0.1, 0.2, 0.25)),
    "swaps-paged": (dict(max_batch=4, max_seq=64, prompt_cap=16,
                         page_size=8), "flash", (0.1, 0.2, 0.25)),
    "reject": (dict(max_batch=2, max_seq=64, prompt_cap=16, max_queue=3),
               "plain", ()),
    "drop_oldest": (dict(max_batch=2, max_seq=64, prompt_cap=16,
                         max_queue=3, shed_policy="drop_oldest"),
                    "plain", (0.03,)),
    "deadline": (dict(max_batch=2, max_seq=64, prompt_cap=16,
                      admission_deadline=0.05, page_size=16), "flash",
                 (0.03,)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's ``run_simulated`` for every case, on two weight
    draws (the swaps alternate between them), computed once."""
    cfg = j_tiny()
    trees = [j_tf.init_params(jax.random.PRNGKey(s), cfg) for s in (0, 1)]
    out = {}
    for name, (kw, _, times) in CASES.items():
        reqs = generate_requests(N_REQ, **_load(name))
        eng = JServingEngine(trees[0], cfg,
                             serving=JServingConfig.from_flat(**kw))
        swaps = [(t, trees[(i + 1) % 2], i + 1) for i, t in enumerate(times)]
        out[name] = eng.run_simulated(reqs, JCost(), swaps=swaps)
    return out, [jax.tree.map(np.asarray, t) for t in trees]


def _load(name):
    return LOAD if name.startswith("swaps") else OVERLOAD


def _port_run(name, trees):
    kw, kernel, times = CASES[name]
    cfg = tiny_cfg()
    params = [params_from_jax(t, cfg, device="cpu") for t in trees]
    eng = ServingEngine(params[0], cfg, serving=ServingConfig.from_flat(
        **kw, decode_kernel=kernel), device="cpu")
    swaps = [(t, params[(i + 1) % 2], i + 1) for i, t in enumerate(times)]
    return eng, eng.run_simulated(t_generate(N_REQ, **_load(name)),
                                  ServeCostModel(), swaps=swaps)


def _same_stats(a, b):
    for f in ("n_requests", "gen_tokens", "makespan", "tokens_per_s",
              "p50_latency", "p95_latency", "engine_steps", "prefill_tokens",
              "decode_rows_live", "decode_rows_total", "prefill_chunks",
              "decode_dispatches", "swap_count", "versions_served", "n_shed",
              "queue_peak", "concurrency_peak", "pages_peak", "prefix_hits",
              "reused_tokens", "decode_kv_tokens"):
        assert getattr(a, f) == getattr(b, f), f
    assert [(s.rid, s.reason, s.t) for s in a.shed] \
        == [(s.rid, s.reason, s.t) for s in b.shed]
    ca = sorted(a.completions, key=lambda c: c.rid)
    cb = sorted(b.completions, key=lambda c: c.rid)
    assert [(c.rid, c.version, c.finish, c.latency, c.prompt_len)
            for c in ca] == [(c.rid, c.version, c.finish, c.latency,
                              c.prompt_len) for c in cb]
    assert [c.tokens.tolist() for c in ca] == [c.tokens.tolist() for c in cb]


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_simulated_matches_jax(jax_runs, name):
    runs, trees = jax_runs
    eng, st = _port_run(name, trees)
    _same_stats(runs[name], st)
    assert not eng.has_work
    n_swaps = len(CASES[name][2])
    assert st.swap_count == n_swaps
    if name.startswith("swaps"):
        assert len(st.versions_served) >= 3     # the swaps bit mid-run
    else:
        assert st.n_shed > 0
        assert {s.reason for s in st.shed} == {
            "reject": {"queue_full"}, "drop_oldest": {"displaced"},
            "deadline": {"deadline"}}[name]
        assert st.n_shed + st.n_requests == N_REQ
        assert max(s.t for s in st.shed) <= st.makespan


def test_submit_sheds_and_stamps_like_jax():
    """The admission queue alone, both policies, with and without a
    clock: return values and shed records bit-equal."""
    reqs = generate_requests(9, **OVERLOAD)
    cfg = tiny_cfg()
    jp = jax.tree.map(np.asarray,
                      j_tf.init_params(jax.random.PRNGKey(0), j_tiny()))
    tp = params_from_jax(jp, cfg, device="cpu")
    for policy in ("reject", "drop_oldest"):
        kw = dict(max_batch=2, max_seq=64, max_queue=3, shed_policy=policy)
        je = JServingEngine(jp, j_tiny(), serving=JServingConfig.from_flat(
            **kw))
        te = ServingEngine(tp, cfg, serving=ServingConfig.from_flat(**kw),
                           device="cpu")
        for i, r in enumerate(reqs):
            now = None if i % 2 else 0.5 + i
            assert je.submit(r, now=now) == te.submit(r, now=now)
        assert [(s.rid, s.reason, s.t) for s in je.shed_log] \
            == [(s.rid, s.reason, s.t) for s in te.shed_log]
        assert je.queue_peak == te.queue_peak == 3
        with pytest.raises(ValueError, match="duplicate rid"):
            te.submit(te._queue[0])


def test_cost_model_and_static_batches_match_jax():
    j, t = JCost(), ServeCostModel()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.draft_time(4, 16, 32) == t.draft_time(4, 16, 32)
    for args in ((4, 16), (1, 8), (16, 64)):
        assert j.prefill_time(*args) == t.prefill_time(*args)
    assert j.decode_time(16) == t.decode_time(16)
    assert j.decode_time_paged(37, 8) == t.decode_time_paged(37, 8)
    assert j.decode_time_flash(300, 64) == t.decode_time_flash(300, 64)
    assert j.swap_time() == t.swap_time()
    for bs in (1, 4, 7):
        a = j_static(generate_requests(30, **LOAD), bs, JCost())
        b = simulate_static_batches(t_generate(30, **LOAD), bs,
                                    ServeCostModel())
        for f in ("n_requests", "gen_tokens", "makespan", "tokens_per_s",
                  "p50_latency", "p95_latency", "engine_steps",
                  "prefill_tokens", "decode_rows_live", "decode_rows_total"):
            assert getattr(a, f) == getattr(b, f), (bs, f)
        assert [(c.rid, c.finish, c.latency) for c in a.completions] \
            == [(c.rid, c.finish, c.latency) for c in b.completions]


def test_session_clock_swap_order_and_drain():
    cfg = tiny_cfg()
    jp = jax.tree.map(np.asarray,
                      j_tf.init_params(jax.random.PRNGKey(0), j_tiny()))
    tp = params_from_jax(jp, cfg, device="cpu")
    eng = ServingEngine(tp, cfg, serving=ServingConfig(max_batch=2,
                                                       max_seq=32),
                        device="cpu")
    session = SimulatedServeSession(eng, ServeCostModel(), [])
    session.push_swap(1.0, tp, 1)
    with pytest.raises(ValueError, match="time order"):
        session.push_swap(0.5, tp, 2)
    session.advance_to(2.0)
    assert session.clock == 2.0 and eng.version == 1
    # the idle engine jumps to the next arrival, charges the steps, and
    # answers every request
    req = ServeRequest(rid=7, prompt=np.arange(5, dtype=np.int32),
                       max_new=3, arrival=3.0, client_latency=0.01)
    session = SimulatedServeSession(eng, ServeCostModel(), [req])
    session.drain()
    (c,) = session.completions
    assert c.version == 1 and c.finish > 3.0
    assert c.latency == c.finish - 3.0 + 0.02
    assert session.stats().makespan == c.finish
    with pytest.raises(ValueError, match="duplicate request ids"):
        SimulatedServeSession(eng, ServeCostModel(), [req, req])


def test_serve_launcher_simulate_with_swaps(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "mlitb-lm-100m", "--reduced", "--requests",
                       "12", "--max-batch", "2", "--max-seq", "64",
                       "--simulate", "--swap-every", "0.05",
                       "--temperature", "0.8", "--top-k", "20",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "simulated: " in out and "in-flight swaps applied" in out
    hist = [ln for ln in out.splitlines() if ln.startswith("  v")]
    assert len(hist) >= 2 and sum(int(ln.split()[1]) for ln in hist) == 12
