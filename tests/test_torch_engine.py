"""Port parity for the serving slice: request schedules, paging
bookkeeping, serving config and the continuous-batching engine of
``repro_torch`` against the JAX package, on the reduced
``mlitb-lm-100m`` with JAX weights carried across. Greedy streams must
be token-equal to the JAX engine's (``decode_kernel="flash"``, the
Pallas kernel in interpret mode) for the dense cache and for the paged
pool with prefix reuse. Also: the port's isolation from JAX and its
explicit-device rule.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.simulation import generate_requests  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import PagingConfig as JPagingConfig  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.paging import PagePool as JPagePool  # noqa: E402
from repro.serving.paging import PrefixTrie as JPrefixTrie  # noqa: E402
from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.serving import (BackpressureConfig,  # noqa: E402
                                 PagePool, PagingConfig, PrefixTrie,
                                 SamplingConfig, ServingConfig,
                                 ServingEngine)
from repro_torch.serving import generate_requests as t_generate  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "mlitb-lm-100m"


def _same_schedule(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival, x.client_latency) \
            == (y.rid, y.max_new, y.arrival, y.client_latency)
        assert x.prompt.dtype == y.prompt.dtype
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=1, prompt_rng=(4, 64), gen_short=(1, 12), gen_long=(128, 192),
         shared_prefix=(3, 64, 0.7), vocab_size=32768),
    dict(seed=7, rate_rps=20.0, burst=(0.1, 0.2, 8.0)),
], ids=["default", "chip-smoke-load", "burst"])
def test_generate_requests_bit_equal(kw):
    _same_schedule(generate_requests(40, **kw), t_generate(40, **kw))


def test_paging_matches_reference_under_one_op_sequence():
    """Drive both PagePool/PrefixTrie pairs through the same seeded mix
    of alloc/insert/lookup/evict/decref/drop and compare every result
    and the final state."""
    rng = np.random.RandomState(0)
    pools = (JPagePool(24, 4), PagePool(24, 4))
    tries = (JPrefixTrie(4), PrefixTrie(4))
    prompts = [rng.randint(0, 5, size=rng.randint(4, 20)) for _ in range(12)]
    held = []
    for step in range(200):
        op = rng.randint(6)
        if op == 0:
            n = int(rng.randint(0, 6))
            res = [p.alloc(n) for p in pools]
            assert res[0] == res[1]
            if res[0]:
                held.append(res[0])
        elif op == 1 and held:
            pages = held[int(rng.randint(len(held)))]
            pr = prompts[int(rng.randint(len(prompts)))]
            j = int(rng.randint(0, max(1, len(pr) // 4)))
            page = pages[j % len(pages)]
            if pools[0].ref[page] > 0:
                res = [t.insert(0, pr, j, page) for t in tries]
                assert res[0] == res[1]
                if res[0]:
                    for p in pools:
                        p.incref(page)
                        p.frozen[page] = True
        elif op == 2:
            pr = prompts[int(rng.randint(len(prompts)))]
            m = int(rng.randint(0, 5))
            assert tries[0].lookup(0, pr, m) == tries[1].lookup(0, pr, m)
        elif op == 3:
            n = int(rng.randint(0, 4))
            assert tries[0].evict_idle(pools[0], n) \
                == tries[1].evict_idle(pools[1], n)
        elif op == 4 and held:
            pages = held.pop(int(rng.randint(len(held))))
            for p in pools:
                for pg in pages:
                    p.decref(pg)
        elif op == 5 and step % 50 == 49:
            assert tries[0].drop_all(pools[0]) == tries[1].drop_all(pools[1])
        assert pools[0].ref == pools[1].ref
        assert pools[0].frozen == pools[1].frozen
        assert pools[0].n_free == pools[1].n_free
        assert tries[0].n_pages_held == tries[1].n_pages_held


def test_config_validation_and_unported_settings():
    with pytest.raises(ValueError, match="max_seq=40.*page_size=16"):
        ServingConfig(max_batch=4, max_seq=40,
                      paging=PagingConfig(page_size=16))
    with pytest.raises(ValueError, match="decode_kernel='xla'"):
        ServingConfig(max_batch=4, max_seq=32, decode_kernel="xla")
    # sampling (C1) and backpressure (C2) are ported: the reference's
    # validation, and the settings themselves construct
    with pytest.raises(ValueError, match="temperature=-0.5"):
        SamplingConfig(temperature=-0.5)
    assert SamplingConfig(temperature=0.7, top_k=5).top_k == 5
    with pytest.raises(ValueError, match="shed_policy='lifo'"):
        BackpressureConfig(shed_policy="lifo")
    with pytest.raises(ValueError, match="max_queue=0"):
        BackpressureConfig(max_queue=0)
    assert BackpressureConfig(max_queue=4).max_queue == 4
    # speculative decoding (C4) is ported: the reference's two checks
    from repro_torch.serving import SpeculativeConfig
    spec = SpeculativeConfig(draft_params={}, draft_cfg=None, k=8, window=16)
    with pytest.raises(ValueError, match="k=8.*prompt_cap=8"):
        ServingConfig(max_batch=4, max_seq=64, prompt_cap=8, speculative=spec)
    with pytest.raises(ValueError, match="temperature=0"):
        ServingConfig(max_batch=4, max_seq=64,
                      sampling=SamplingConfig(temperature=0.5),
                      speculative=spec)
    assert ServingConfig(max_batch=4, max_seq=32).decode_kernel == "flash"


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
_JAX_RUNS = {}
_SERVE = dict(max_batch=4, max_seq=64, prompt_cap=16)


def _load():
    cfg = get_config(ARCH).reduced()
    return generate_requests(
        14, rate_rps=200.0, vocab_size=cfg.vocab_size, prompt_rng=(4, 12),
        gen_short=(2, 6), gen_long=(8, 16), long_frac=0.3,
        shared_prefix=(2, 16, 0.8), seed=9)


def _jax_streams(paged):
    """The JAX engine's greedy streams (flash kernel, interpret mode),
    computed once per layout."""
    if paged not in _JAX_RUNS:
        cfg = get_config(ARCH).reduced()
        jp = j_tf.init_params(jax.random.PRNGKey(0), cfg)
        eng = JServingEngine(jp, cfg, serving=JServingConfig(
            **_SERVE, decode_kernel="flash",
            paging=JPagingConfig(page_size=8) if paged else None))
        stats = eng.run_closed_loop(_load())
        _JAX_RUNS[paged] = (jax.tree.map(np.asarray, jp),
                            {c.rid: c.tokens.tolist()
                             for c in stats.completions},
                            stats.prefix_hits)
    return _JAX_RUNS[paged]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kernel", ["flash", "plain"])
def test_engine_streams_token_equal_to_jax(paged, kernel):
    tree, want, jax_hits = _jax_streams(paged)
    tcfg = t_get_config(ARCH).reduced()
    params = params_from_jax(tree, tcfg, device="cpu")
    cfg = get_config(ARCH).reduced()
    reqs = t_generate(14, rate_rps=200.0, vocab_size=cfg.vocab_size,
                      prompt_rng=(4, 12), gen_short=(2, 6), gen_long=(8, 16),
                      long_frac=0.3, shared_prefix=(2, 16, 0.8), seed=9)
    eng = ServingEngine(params, tcfg, serving=ServingConfig(
        **_SERVE, decode_kernel=kernel,
        paging=PagingConfig(page_size=8) if paged else None), device="cpu")
    stats = eng.run_closed_loop(reqs)
    assert {c.rid: c.tokens.tolist() for c in stats.completions} == want
    assert stats.n_requests == len(reqs)
    if paged:
        assert stats.prefix_hits == jax_hits and stats.prefix_hits > 0
        # everything released but the trie's cached prefix pages
        assert eng.pages_free + eng.trie_pages == eng.n_pages
    elif kernel == "flash":
        assert 0 < stats.decode_kv_tokens < stats.decode_rows_total * 64


def test_engine_rejects_bad_requests_and_reruns_cleanly():
    tcfg = t_get_config(ARCH).reduced()
    from repro_torch.models.transformer import init_params
    params = init_params(tcfg, seed=1, device="cpu")
    eng = ServingEngine(params, tcfg, serving=ServingConfig(
        max_batch=2, max_seq=32, paging=PagingConfig(page_size=8, n_pages=3)),
        device="cpu")
    from repro_torch.serving import ServeRequest
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(ServeRequest(rid=0, prompt=np.ones(30, np.int32),
                                max_new=4))
    with pytest.raises(ValueError, match="can never be admitted"):
        eng.submit(ServeRequest(rid=1, prompt=np.ones(20, np.int32),
                                max_new=8))
    reqs = [ServeRequest(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                         max_new=5) for i in range(4)]
    first = eng.run_closed_loop(reqs)
    again = eng.run_closed_loop(reqs)          # pool fully released between
    assert [c.tokens.tolist() for c in sorted(first.completions,
                                              key=lambda c: c.rid)] \
        == [c.tokens.tolist() for c in sorted(again.completions,
                                              key=lambda c: c.rid)]
    assert all(c.tokens.size == 5 for c in first.completions)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--requests", "4",
                       "--max-batch", "2", "--max-seq", "64",
                       "--page-size", "8", "--shared-prefix", "16",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "requests=4" in out and "prefix hits" in out


# ---------------------------------------------------------------------------
# isolation and the explicit-device rule
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_nothing_of_repro():
    """In a fresh interpreter: import every module of repro_torch, then
    chip_smoke.py as a module (its main does not run); no jax and no
    repro / repro.* may be loaded."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith('jax.') or n == 'repro' or\n"
        "             n.startswith('repro.'))\n"
        "n = sum(1 for m in sys.modules if m.startswith('repro_torch'))\n"
        "new = [m for m in NEW if m not in sys.modules]\n"
        "print('BAD', bad, 'MISSING', new, 'PORT', n)\n")
    # the model families' modules and every config file (slice 10)
    new = ["repro_torch.models.moe", "repro_torch.models.ssm",
           "repro_torch.configs.all_configs"] + [
        f"repro_torch.configs.{c}" for c in (
            "arctic_480b", "command_r_plus_104b", "granite_8b",
            "llama4_scout_17b_a16e", "mamba2_780m", "minitron_8b",
            "paligemma_3b", "qwen3_4b", "whisper_large_v3", "zamba2_7b")] + [
        # the single-device training path (A10a)
        "repro_torch.train.step", "repro_torch.core.mesh_engine",
        "repro_torch.data.pipeline", "repro_torch.launch.train"] + [
        # the multi-device surface (A10b)
        f"repro_torch.distributed.{m}" for m in (
            "sharding", "activation_sharding", "collectives",
            "comm_analysis", "sharded_step", "world",
            # the compute split over `model` (A10c)
            "tensor_parallel")] + [
        f"repro_torch.launch.{m}" for m in (
            "mesh", "specs", "dryrun", "dryrun_all")] + [
        "repro_torch.configs.shapes"]
    code = f"NEW = {new!r}\n" + code
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("BAD [] MISSING [] PORT "), line
    assert int(line.split()[-1]) >= 81


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from repro_torch.kernels.runtime import require_hopper, resolve_device
    from repro_torch.models.transformer import init_params
    tcfg = t_get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        require_hopper()
    params = init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, tcfg, serving=ServingConfig(max_batch=2,
                                                          max_seq=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, tcfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1"])
    # the training slice
    from repro_torch.checkpoint.convert import cnn_params_from_jax
    from repro_torch.core.simulation import make_cnn_problem
    from repro_torch.launch import elastic_sgd
    from repro_torch.models import cnn
    for call in (cnn.init_params, make_cnn_problem,
                 lambda: cnn_params_from_jax({}),
                 lambda: elastic_sgd.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    p = cnn.init_params(device="cpu")
    assert cnn_params_from_jax({k: v.numpy() for k, v in p.items()},
                               device="cpu")["fc_w"].shape == (3136, 10)
    init_p, grad_fn, eval_fn = make_cnn_problem(device="cpu")
    assert 0.0 <= eval_fn(init_p(), np.zeros((2, 28, 28, 1), np.float32),
                          np.zeros(2, np.int32)) <= 1.0
    assert elastic_sgd.main(["--device", "cpu", "--iterations", "2",
                             "--n-data", "200"]) == 0
