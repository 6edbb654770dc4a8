#!/usr/bin/env python3
"""Where a step of the mesh training path goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_mesh_step.py [--remat]

``mlitb-lm-100m`` at full width (f32, TF32 off) trains through
``ElasticMeshSGD`` over ``build_train_step`` (4 virtual workers, batch 8
x 256 from ``launch.train``'s ``data_stream``, AdaGrad lr 0.003), the
path of ``python -m repro_torch.launch.train`` without ``--simulate``:
5 steps to warm up, then 10 under ``torch.profiler``. It prints the host
and device time per step, the device's busy share of the wall time, the
products' share and their achieved rate against the 6 x parameters x
tokens of a step, and the ops with the most device time per step, each
as a ``[prof]`` line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from profile_families import card, report
from repro_torch.configs import get_config
from repro_torch.core.mesh_engine import ElasticMeshSGD
from repro_torch.launch.train import data_stream
from repro_torch.models.transformer import init_params
from repro_torch.optim import adagrad
from repro_torch.train.step import build_train_step, make_train_state

WARMUP, STEPS, BATCH, SEQ = 5, 10, 8, 256
MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=14)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    name = card()
    cfg = get_config("mlitb-lm-100m")
    opt = adagrad(lr=0.003)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=args.remat),
        state=make_train_state(init_params(cfg, seed=0, device="cuda"), opt),
        n_workers=4, global_batch=BATCH)
    stream = data_stream(cfg.vocab_size, BATCH, SEQ, seed=0)
    batches = [next(stream) for _ in range(WARMUP + STEPS)]
    for b in batches[:WARMUP]:
        eng.step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[WARMUP:]:
            eng.step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"mlitb-lm-100m full width, 8 x 256, remat={args.remat}",
           prof, wall, STEPS, args.rows, name)
    ka = prof.key_averages()
    mm = sum(e.self_device_time_total for e in ka
             if e.key in MATMULS) / 1e6 / STEPS
    flop = 6 * cfg.n_params() * BATCH * SEQ
    print(f"[prof] products (mm, addmm, bmm): {1e3 * mm:.2f} ms a step; "
          f"6 x {cfg.n_params()} parameters x {BATCH * SEQ} tokens = "
          f"{flop / 1e12:.3f} TFLOP a step, {flop / mm / 1e12:.1f} TFLOP/s "
          f"over their time | {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
