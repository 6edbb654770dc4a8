"""Port parity for the live train->serve loop: one seeded
``run_train_serve`` of ``repro_torch`` against ``repro``'s, on the CPU
at ``tiny_cfg()``, the JAX side's initial weights carried across
(``init_params=params_from_jax(...)``). A burst overloads a two-slot
paged engine with a four-deep queue, so requests shed both ways
(``drop_oldest`` displacement and admission deadlines) while the fleet
publishes into the engine.

Equal: every ``IterationLog`` field that
``test_torch_lm_train.py::test_build_training_run_matches_jax`` compares
(loss within 1e-3 relative), the published ``(clock, version)`` pairs,
``versions_served``, ``swap_count``, the shed log and every completion's
``(rid, version, finish, latency)`` — the clock is exact host
arithmetic. Greedy streams equal up to the near-tie rule: at the first
differing token the port's plain logits' top-2 gap must be below 1e-4,
and the comparison of that request stops there. Also the CLI (the
version histogram, ``--snapshot-out`` then ``--from-snapshot``) and the
CUDA default of the new entry points.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.simulation import generate_requests  # noqa: E402
from repro.launch.train_serve import run_train_serve as j_run  # noqa: E402
from repro.launch.train_serve import tiny_cfg as j_tiny  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train_serve as ts  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import generate_requests as t_gen  # noqa: E402

# the reference CLI's request shape at max_seq 64, with a burst
LOAD = dict(rate_rps=6.0, vocab_size=128, prompt_rng=(4, 47),
            gen_short=(2, 8), gen_long=(9, 16), burst=(1.4, 0.6, 14.0),
            seed=1)
N_REQ = 32
RUN = dict(iterations=6, publish_every=2, T=0.5, seed=0, max_batch=2,
           max_seq=64, prompt_cap=16, page_size=8, max_queue=4,
           shed_policy="drop_oldest", admission_deadline=0.025)
GAP_TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """``repro``'s run (its cost: compiling each batch shape) and the
    port's on the same initial weights."""
    jout = j_run(j_tiny(), generate_requests(N_REQ, **LOAD), **RUN)
    jp = jax.tree.map(np.asarray,
                      j_tf.init_params(jax.random.PRNGKey(0), j_tiny()))
    cfg = ts.tiny_cfg()
    tout = ts.run_train_serve(
        cfg, t_gen(N_REQ, **LOAD), **RUN, device="cpu",
        init_params=params_from_jax(jp, cfg, device="cpu"))
    return jout, tout


def _top2_gap(params, cfg, seq):
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim)
    cache = {"layers": {n: torch.zeros(shape) for n in ("k", "v")}}
    logits, _ = t_tf.prefill_chunk(
        params, cfg, torch.tensor(np.asarray(seq, np.int64)[None]),
        torch.zeros(1, dtype=torch.int64), torch.tensor([len(seq)]), cache)
    top = torch.topk(logits[0, 0], 2).values
    return float(top[0] - top[1])


def test_run_train_serve_matches_jax(runs):
    jout, tout = runs
    assert len(jout["logs"]) == len(tout["logs"]) == RUN["iterations"]
    for a, b in zip(jout["logs"], tout["logs"]):
        assert (a.step, a.events, a.n_workers, a.vectors, a.wire_bytes,
                a.per_worker_wire_bytes, a.n_late, a.n_quarantined,
                a.rolled_back) \
            == (b.step, b.events, b.n_workers, b.vectors, b.wire_bytes,
                b.per_worker_wire_bytes, b.n_late, b.n_quarantined,
                b.rolled_back)
        assert a.wall_time == b.wall_time and a.deadline == b.deadline
        assert abs(a.loss - b.loss) <= 1e-3 * abs(a.loss)
    assert tout["published"] == jout["published"]
    assert sorted(tout["versions"]) == sorted(jout["versions"])
    js, st = jout["stats"], tout["stats"]
    assert (st.versions_served, st.swap_count, st.n_shed, st.queue_peak) \
        == (js.versions_served, js.swap_count, js.n_shed, js.queue_peak)
    assert [(s.rid, s.reason, s.t) for s in st.shed] \
        == [(s.rid, s.reason, s.t) for s in js.shed]
    key = (lambda c: (c.rid, c.version, c.finish, c.latency))
    assert sorted(map(key, st.completions)) \
        == sorted(map(key, js.completions))
    # what the run exercised: both shed reasons, two or more versions
    assert {s.reason for s in st.shed} == {"displaced", "deadline"}
    assert len(st.versions_served) >= 2 and st.swap_count >= 3
    # greedy streams, up to the near-tie rule
    cfg = ts.tiny_cfg()
    by_rid = {r.rid: r for r in t_gen(N_REQ, **LOAD)}
    want = {c.rid: c.tokens.tolist() for c in js.completions}
    compared = 0
    for c in st.completions:
        for i, (a, b) in enumerate(zip(c.tokens.tolist(), want[c.rid])):
            if a != b:
                seq = list(by_rid[c.rid].prompt) + want[c.rid][:i]
                gap = _top2_gap(tout["versions"][c.version], cfg, seq)
                assert gap < GAP_TIE, (c.rid, i, gap)
                break
            compared += 1
    assert compared >= 0.9 * st.gen_tokens


def test_loop_state_and_engine_after_the_run(runs):
    _, tout = runs
    eng, loop = tout["engine"], tout["loop"]
    assert not eng.has_work and eng.live_versions == [loop.step]
    assert loop.step == RUN["iterations"]
    assert "joiner" in tout["cluster"].workers          # scripted churn
    assert "w1" not in tout["cluster"].workers
    # every served version is a snapshot of the reducer at that step
    assert set(tout["stats"].versions_served) <= set(tout["versions"])


def test_cli_histogram_and_snapshot_round_trip(tmp_path, capsys):
    snap = str(tmp_path / "ts.npz")
    assert ts.main(["--device", "cpu", "--iterations", "4", "--requests",
                    "12", "--snapshot-out", snap]) == 0
    out = capsys.readouterr().out
    assert "served version histogram" in out
    assert "wrote TrainState snapshot" in out and "(step 4)" in out
    hist = [ln for ln in out.splitlines() if ln.startswith("  v")]
    assert sum(int(ln.split()[1]) for ln in hist) == 12
    assert ts.main(["--device", "cpu", "--iterations", "2", "--requests",
                    "6", "--from-snapshot", snap, "--page-size", "8"]) == 0
    out = capsys.readouterr().out
    assert "seeded engine from" in out and "(training step 4)" in out
    served = [int(ln.split()[0][1:]) for ln in out.splitlines()
              if ln.startswith("  v")]
    assert served and min(served) >= 4


def test_from_snapshot_engine_serves_the_loops_params(tmp_path):
    """An engine seeded by ``serving_params_from_train_state`` serves
    exactly what the resumed loop's own params serve."""
    from repro_torch.checkpoint.io import (TrainState, load_train_state,
                                           save_train_state,
                                           serving_params_from_train_state)
    cfg = ts.tiny_cfg()
    loop, cluster, _ = ts.build_training(cfg, seed=0, device="cpu")
    loop.run(3)
    snap = str(tmp_path / "s.npz")
    save_train_state(snap, TrainState.capture(loop, cluster))
    state = load_train_state(snap)
    params, step = serving_params_from_train_state(
        state, t_tf.init_params(cfg, seed=0, device="cpu"))
    reqs = t_gen(6, rate_rps=20.0, vocab_size=cfg.vocab_size,
                 prompt_rng=(4, 20), gen_short=(2, 6), gen_long=(8, 12),
                 seed=4)
    kw = dict(iterations=2, max_batch=2, max_seq=64, device="cpu")
    seeded = ts.run_train_serve(cfg, reqs, resume_state=state,
                                engine_params=params, start_version=step,
                                **kw)
    default = ts.run_train_serve(cfg, reqs, resume_state=load_train_state(
        snap), **kw)
    key = (lambda c: (c.rid, c.version, c.finish, c.tokens.tolist()))
    assert sorted(map(key, seeded["stats"].completions)) \
        == sorted(map(key, default["stats"].completions))
    assert step == 3 and min(seeded["stats"].versions_served) == 3


def test_unported_options_and_the_cuda_default():
    cfg = ts.tiny_cfg()
    # speculative decoding is ported: the reference's validation errors
    with pytest.raises(ValueError, match="temperature=0"):
        ts.main(["--device", "cpu", "--speculative", "4",
                 "--temperature", "0.5"])
    from repro_torch.serving import SpeculativeConfig
    spec = SpeculativeConfig(draft_params={}, draft_cfg=cfg, k=16,
                             window=32)
    with pytest.raises(ValueError, match="k=16.*prompt_cap=16"):
        ts.run_train_serve(cfg, [], iterations=1, device="cpu",
                           speculative=spec)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from repro_torch.core.closure import torchify
    from repro_torch.launch import serve
    for call in (lambda: ts.run_train_serve(cfg, [], iterations=1),
                 lambda: ts.main(["--iterations", "1"]),
                 lambda: torchify({"w": np.zeros(2, np.float32)}),
                 lambda: serve.main(["--reduced", "--simulate"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
