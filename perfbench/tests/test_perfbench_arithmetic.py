"""The yardstick's arithmetic against hand counts: model FLOPs, a GEMM's
least time, the trace's reduction, and the per-layer readers."""
from __future__ import annotations

import json

import pytest

from perfbench import flops
from perfbench.devtrace import TraceData, _gaps, _union, idle_by_host
from perfbench.harness import Run, Window
from perfbench.tests.support import ROOT


def _cfg(name):
    return json.loads((ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())


def test_mlitb_lm_100m_counts():
    cfg = _cfg("mlitb-lm-100m")
    assert flops.matmul_params(cfg) == 100_663_296
    # 6 x params + 6 hd H (S + 1) L a token, 16 384 tokens at S 1024
    step = flops.train_flops_per_token(cfg, 1024) * 16_384
    assert step == (6 * 100_663_296 + 6 * 64 * 12 * 1025 * 12) * 16_384
    assert round(step / 1e12, 2) == 10.82


def test_mamba2_780m_counts():
    cfg = _cfg("mamba2-780m")
    assert flops.matmul_params(cfg) == 779_120_640
    Q, N, hp = 128, 128, 48 * 64
    mix = 48 * ((Q + 1) * N + (Q + 1) * hp + 4 * N * hp)
    assert flops.train_flops_per_token(cfg, 2048) == \
        6 * 779_120_640 + 3 * mix
    assert round(flops.train_flops_per_token(cfg, 2048) / 1e9, 1) == 5.0


def test_gemm_bound_hand_counts():
    peak, hbm = 165e12, 3.35e12

    def bound(op, shapes):
        return flops.product_bound_s(*flops.gemm_mnk(op, shapes), 4,
                                     "float32")
    # compute-bound: 4096^3
    assert bound("aten::mm", [[4096, 4096], [4096, 4096]]) == pytest.approx(
        2 * 4096 ** 3 / peak)
    # bytes-bound: a thin product
    assert bound("aten::addmm", [[64], [8, 4096], [4096, 64], [], []]) == \
        pytest.approx(4 * (8 * 4096 + 4096 * 64 + 8 * 64) / hbm)
    # the program's linear: x (2, 8, 16) @ w (16, 12)
    assert flops.linear_mnk([[2, 8, 16], [16, 12]]) == (1, 16, 12, 16)
    assert flops.gemm_mnk("aten::bmm", [[3, 5, 7], [3, 7, 11]]) == \
        (3, 5, 11, 7)
    assert flops.peak_flops("bfloat16") == 989e12


def test_union_gaps_and_idle_by_host():
    assert _union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    busy = [(10.0, 20.0), (30.0, 40.0)]
    gaps = _gaps(busy, 0.0, 50.0)
    assert gaps == [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    cpu = [(1.0, 9.0, "aten::copy_"), (22.0, 29.0, "aten::item"),
           (31.0, 33.0, "aten::mm")]
    got = dict(idle_by_host(gaps, cpu))
    assert got == pytest.approx({"aten::copy_": 10e-9, "aten::item": 10e-9,
                                 "after aten::mm": 10e-9})


def test_readers():
    from perfbench.harness import reader

    def read(kind, name, data):
        return reader(kind, name)(data)

    t = TraceData(steps=3, window_s=2.0, busy_s=1.5, tokens=3000.0,
                  step_gaps_s=[0.01, 0.03], gemm_bound_s=0.2,
                  gemm_device_s=0.8)
    run = Run(trace=t, spans={"fleet.map": [100.0, 50.0, 30.0],
                              "fleet.reduce": [20.0, 20.0],
                              "optimizer": [4.0, 6.0]},
              program_spans={"train.forward": [30.0, 34.0],
                             "train.backward": [70.0, 80.0]},
              steps=[150.0, 150.0], peak_window_bytes=3 * 2 ** 30,
              flops_per_token=1e9, peak_flops=165e12)
    assert read("metrics", "step_gap_ms", run) == pytest.approx(20.0)
    assert read("metrics", "device_idle_share", run) == pytest.approx(25.0)
    assert read("metrics", "gemm_roofline", run) == pytest.approx(25.0)
    assert read("metrics", "fleet_map_ms", run) == pytest.approx(90.0)
    assert read("metrics", "fleet_reduce_ms", run) == pytest.approx(20.0)
    assert read("metrics", "fleet_loop_ms", run) == pytest.approx(40.0)
    assert read("metrics", "optimizer_ms", run) == pytest.approx(5.0)
    assert read("metrics", "forward_ms", run) == pytest.approx(32.0)
    assert read("metrics", "backward_ms", run) == pytest.approx(75.0)
    assert read("metrics", "peak_mem_gib", run) == pytest.approx(3.0)
    assert read("metrics", "step_mfu", run) == pytest.approx(
        100 * 3000 * 1e9 / 2.0 / 165e12)
    for name in ("gemm_roofline", "step_mfu", "device_idle_share",
                 "peak_mem_gib"):
        assert read("metrics", f"{name}.fleet", run) == \
            read("metrics", name, run)
    for name in ("step_gap_ms", "forward_ms", "backward_ms"):
        assert read("metrics", name, Run()) is None
    w = Window(tokens=16384.0, seconds=0.5, flops=16384.0 * 1e6,
               peak_flops=165e12, setup_s=12.5)
    assert read("endtoend", "train_tokens_per_s", w) == 32768.0
    assert read("endtoend", "train_mfu", w) == pytest.approx(
        100 * 16384e6 / 0.5 / 165e12)
    assert read("endtoend", "setup_s", w) == 12.5
    assert read("endtoend", "train_tokens_per_s.fleet", w) == 32768.0
    assert read("endtoend", "train_mfu.fleet", w) == \
        read("endtoend", "train_mfu", w)


def test_token_stream_is_the_programs():
    import numpy as np
    from repro_torch.data.datasets import synthetic_lm as program

    from perfbench.traffic import synthetic_lm

    for seed, vocab, n in ((0, 32_768, 20_000), (2 ** 31 + 5, 50_280, 30_000),
                           (7, 13, 1_000)):
        assert np.array_equal(synthetic_lm(n, vocab, seed),
                              program(n, vocab, seed=seed % 2 ** 32))
