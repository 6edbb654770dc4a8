"""``repro_torch.tracing``: the spans and counters, off and on, and the
program's spans at its layer boundaries (the mesh engine's step, the
fleet's iteration, the simulated workers, the fused reduce), on the CPU.
Tracing on or off, the program computes bit for bit the same."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core import GuardrailConfig, TrainingConfig
from repro_torch.core import simulation as sim
from repro_torch.core.flatbuf import tree_paths
from repro_torch.core.mesh_engine import ElasticMeshSGD
from repro_torch.kernels import runtime
from repro_torch.launch.train_serve import build_training, tiny_cfg
from repro_torch.models.transformer import init_params
from repro_torch.optim import adagrad, sgd
from repro_torch.train.step import build_train_step, make_train_state

MESH_SPANS = ["mesh.step", "mesh.upload", "train.step", "train.forward",
              "train.backward", "train.optimizer", "mesh.readback"]
FLEET_PHASES = ["fleet.events", "fleet.map", "fleet.screen",
                "fleet.deadline", "fleet.reduce", "fleet.monitor",
                "fleet.broadcast", "fleet.publish"]
WORKER_SPANS = ["worker.rows", "worker.forward", "worker.backward",
                "worker.readback"]
# what becomes of the rows a worker computed, and of the rows a stale
# reply re-sent: computed + resent = on time + deferred + quarantined +
# dropped + stale
FATES = ["fleet.vectors_on_time", "fleet.vectors_deferred",
         "fleet.vectors_quarantined", "fleet.vectors_dropped",
         "fleet.vectors_stale"]


@pytest.fixture(autouse=True)
def _fresh():
    """Every test starts and ends with tracing off and nothing held."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    torch.set_num_threads(n)


def _by_start(records):
    return sorted(records, key=lambda r: (r.start_ns, r.id))


def _children(records, parent):
    return [r for r in _by_start(records) if r.parent == parent.id]


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------
def test_off_returns_one_shared_no_op_and_records_nothing():
    before = {k: c.count for k, c in tracing.COUNTERS.items()}
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        with b:
            tracing.count("fleet.vectors_on_time", 5)
    out = tracing.drain()
    assert out.records == [] and out.dropped == 0
    assert out.counters == before           # no counter made or moved


def test_on_nesting_parents_steps_and_self_time():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("a"):
            with tracing.span("a.inner"):
                pass
        with tracing.span("b"):
            pass
    with tracing.span("second"):
        pass
    out = tracing.drain()
    by = {r.name: r for r in out.records}
    assert [r.name for r in out.records] == ["a.inner", "a", "b", "outer",
                                             "second"]
    assert by["outer"].parent is None and by["second"].parent is None
    assert by["a"].parent == by["b"].parent == by["outer"].id
    assert by["a.inner"].parent == by["a"].id
    assert len({by[n].step for n in ("outer", "a", "a.inner", "b")}) == 1
    assert by["second"].step != by["outer"].step
    assert by["outer"].self_ns == (by["outer"].host_ns - by["a"].host_ns
                                   - by["b"].host_ns)
    assert by["a"].self_ns == by["a"].host_ns - by["a.inner"].host_ns
    assert by["b"].self_ns == by["b"].host_ns
    assert all(r.device_ms is None for r in out.records)
    assert all(0 <= r.self_ns <= r.host_ns for r in out.records)
    assert tracing.drain().records == []          # drain cleared them


def test_span_closes_on_an_exception():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("raises"):
                raise ValueError("x")
    with tracing.span("after"):
        pass
    by = {r.name: r for r in tracing.drain().records}
    assert by["raises"].parent == by["outer"].id
    assert by["after"].parent is None


def test_record_cap_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    out = tracing.drain()
    assert [r.name for r in out.records] == ["s0", "s1", "s2"]
    assert out.dropped == 2
    assert tracing.drain().dropped == 0


def test_counters_count_only_while_on_and_reset_zeroes_them():
    tracing.count("fleet.workers_gone", 3)
    tracing.enable()
    tracing.count("fleet.workers_gone", 2)
    tracing.count("fleet.workers_gone")
    assert tracing.drain().counters["fleet.workers_gone"] == 3
    tracing.reset()
    assert tracing.COUNTERS["fleet.workers_gone"].count == 0


def test_one_registry_under_the_runtime_names():
    assert runtime.COUNTERS is tracing.COUNTERS
    assert runtime.LaunchCounter is tracing.LaunchCounter
    assert runtime.launch_counter is tracing.launch_counter
    assert runtime.reset_counters is tracing.reset_counters
    c = runtime.launch_counter("test_kernel")
    c.count += 1                       # launch counters count while off
    assert tracing.drain().counters["test_kernel"] == 1
    tracing.reset_counters()
    assert c.count == 0
    del tracing.COUNTERS["test_kernel"]


def test_spans_enter_the_profilers_trace_only_when_on():
    from torch.profiler import ProfilerActivity, profile

    def names(on):
        (tracing.enable if on else tracing.disable)()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("t.outer"):
                with tracing.span("t.inner"):
                    torch.ones(4).sum()
        return {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"t.outer", "t.inner"} <= names(True)
    assert not {"t.outer", "t.inner"} & names(False)
    with tracing.span("no.profiler"):             # on, no profiler
        pass


# ---------------------------------------------------------------------------
# idle gaps by span
# ---------------------------------------------------------------------------
def test_idle_by_span_innermost_open_range_wins():
    ranges = [(0, 100, "fleet.iteration"), (10, 60, "fleet.map"),
              (20, 30, "worker.readback"), (70, 90, "fleet.reduce")]
    gaps = [(22, 28),         # inside readback, inside map, inside iteration
            (40, 50),         # map (readback has closed)
            (60, 70),         # middle 65: iteration only
            (80, 84),         # reduce
            (120, 130),       # outside every range
            (95, 115)]        # middle 105: outside
    got = tracing.idle_by_span(gaps, ranges)
    assert got == {"worker.readback": 6, "fleet.map": 10,
                   "fleet.iteration": 10, "fleet.reduce": 4,
                   tracing.OUTSIDE: 30}
    assert tracing.idle_by_span([(0, 5)], []) == {tracing.OUTSIDE: 5}
    # spans that start on one tick: the shorter is the inner one
    same = [(10, 60, "fleet.iteration"), (10, 20, "fleet.events"),
            (10, 40, "fleet.map")]
    assert tracing.idle_by_span([(12, 14), (30, 32), (50, 52)], same) == {
        "fleet.events": 2, "fleet.map": 2, "fleet.iteration": 2}
    assert tracing.idle_by_span([], ranges) == {}


class _Event:
    def __init__(self, name, start, dur, device, note=False):
        self._v = (name, start, dur, device, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_profile_idle_by_span_reads_a_trace():
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    events = [
        _Event("fleet.map", 0, 1000, cpu, note=True),
        _Event("worker.readback", 400, 200, cpu, note=True),
        _Event("aten::mm", 10, 5, cpu),              # a host op: no range
        _Event("gemm", 100, 300, gpu),
        _Event("fleet.map", 100, 900, gpu, note=True),   # device mirror
        _Event("copy", 380, 20, gpu),                # overlaps the gemm
        _Event("gemm", 500, 100, gpu),               # gap 400-500: readback
        _Event("add", 2000, 100, gpu),               # gap 600-2000: outside
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events
    got = tracing.profile_idle_by_span(Prof)
    assert got == pytest.approx({"worker.readback": 100e-9,
                                 tracing.OUTSIDE: 1400e-9})


# ---------------------------------------------------------------------------
# the mesh engine
# ---------------------------------------------------------------------------
def _mesh_run(on, steps=3, name="qwen3-4b", remat=False):
    cfg = get_config(name).reduced()
    opt = adagrad(lr=0.01)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=remat),
        state=make_train_state(init_params(cfg, seed=0, device="cpu"), opt),
        n_workers=2, global_batch=4)
    rs = np.random.RandomState(0)
    (tracing.enable if on else tracing.disable)()
    out, spans = [], []
    for i in range(steps):
        if i == 1:
            eng.leave(1)
        b = {"tokens": rs.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32),
             "labels": rs.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)}
        out.append(eng.step(b))
        spans.append(tracing.drain().records)
    return out, eng.state, spans


@pytest.mark.parametrize("name,remat", [("qwen3-4b", False),
                                        ("mamba2-780m", True)])
def test_mesh_engine_same_with_tracing_on(name, remat):
    off_m, off_s, off_spans = _mesh_run(False, name=name, remat=remat)
    on_m, on_s, on_spans = _mesh_run(True, name=name, remat=remat)
    assert off_m == on_m
    for (pa, a), (pb, b) in zip(tree_paths(off_s), tree_paths(on_s)):
        assert pa == pb and torch.equal(a, b), pa
    assert all(s == [] for s in off_spans)
    for recs in on_spans:
        assert [r.name for r in _by_start(recs)] == MESH_SPANS
        assert len({r.step for r in recs}) == 1
        root = next(r for r in recs if r.name == "mesh.step")
        assert [r.name for r in _children(recs, root)] == [
            "mesh.upload", "train.step", "mesh.readback"]
        step = next(r for r in recs if r.name == "train.step")
        assert [r.name for r in _children(recs, step)] == [
            "train.forward", "train.backward", "train.optimizer"]
        assert all(r.device_ms is None for r in recs)   # no card here


def test_off_makes_no_event_and_no_profiler_call(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("called with tracing off")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    metrics, _, spans = _mesh_run(False, steps=1)
    assert np.isfinite(metrics[0]["loss"]) and spans == [[]]
    logs, _, recs, _ = _fleet(False, iterations=2)
    assert len(logs) == 2 and recs == [[], []]


# ---------------------------------------------------------------------------
# the fleet: event loop, simulated workers, fused reduce
# ---------------------------------------------------------------------------
# replies lost on the uplink, and stale re-sends of an earlier reply
LOSSY = {"w1": sim.FaultProfile(drop_p=0.5, max_retries=0),
         "w2": sim.FaultProfile(stale_p=0.5)}
# the fates each fleet below must show at least once
SEEN = {False: ["fleet.vectors_deferred"],
        True: ["fleet.vectors_quarantined"],
        "lossy": ["fleet.vectors_dropped", "fleet.vectors_stale",
                  "fleet.vectors_resent"]}


def _fleet(on, iterations=6, chaos=False):
    if chaos is True:   # quarantines and an eviction under the guardrails
        loop, cluster, _ = build_training(
            tiny_cfg(), training=TrainingConfig(
                T=1.5, guardrails=GuardrailConfig(strikes_to_evict=2)),
            optimizer=sgd(lr=0.05), churny=False, seed=0,
            fault_profiles={"w1": sim.FaultProfile(nan_p=0.3)},
            device="cpu")
    else:               # a straggler past the deadline: late replies
        loop, cluster, _ = build_training(
            tiny_cfg(), seed=0, lr=0.05, churny=True, device="cpu",
            fault_profiles=LOSSY if chaos == "lossy" else None)
    (tracing.enable if on else tracing.disable)()
    logs, recs, counters = [], [], []
    for _ in range(iterations):
        tracing.reset_counters()
        logs.append(loop.iteration())
        out = tracing.drain()
        recs.append(out.records)
        counters.append(out.counters)
    return logs, loop.reducer.flat_params.clone(), recs, counters


def _same_logs(a, b):
    for x, y in zip(a, b):
        x, y = asdict(x), asdict(y)
        lx, ly = x.pop("loss"), y.pop("loss")
        assert x == y
        assert (np.isnan(lx) and np.isnan(ly)) or lx == ly


def _fates_add_up(c):
    return (c["fleet.vectors_computed"] + c.get("fleet.vectors_resent", 0)
            == sum(c.get(k, 0) for k in FATES))


@pytest.mark.parametrize("chaos", [False, True, "lossy"])
def test_event_loop_same_with_tracing_on(chaos):
    off_logs, off_p, off_recs, _ = _fleet(False, chaos=chaos)
    on_logs, on_p, on_recs, counters = _fleet(True, chaos=chaos)
    _same_logs(off_logs, on_logs)
    assert torch.equal(off_p, on_p)
    assert all(r == [] for r in off_recs)
    seen = {}
    for log, recs, c in zip(on_logs, on_recs, counters):
        root = next(r for r in recs if r.name == "fleet.iteration")
        assert root.parent is None
        assert {r.step for r in recs} == {root.step}
        assert [r.name for r in _children(recs, root)] == FLEET_PHASES
        fmap = next(r for r in recs if r.name == "fleet.map")
        workers = _children(recs, fmap)
        assert {r.name for r in workers} == {"fleet.worker"}
        for w in workers:
            names = [r.name for r in _children(recs, w)]
            assert names in ([], WORKER_SPANS), names
        red = next(r for r in recs if r.name == "fleet.reduce")
        assert [r.name for r in _children(recs, red)] == (
            ["reduce.stack", "reduce.step"] if log.wire_bytes else [])
        assert c["fleet.vectors_on_time"] == log.vectors
        assert _fates_add_up(c)
        assert c["fleet.workers_gone"] == sum(
            e.startswith("lost:") for e in log.events)
        for k, v in c.items():
            seen[k] = seen.get(k, 0) + v
    # the fates off the on-time path that each fleet has occur
    for k in SEEN[chaos] + ["fleet.vectors_on_time"]:
        assert seen[k] > 0, k
