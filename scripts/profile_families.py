#!/usr/bin/env python3
"""Where a decode step's time goes for the MoE and the hybrid family,
on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_families.py

``llama4-scout-17b-a16e`` at full width with 4 of its 48 layers (bf16)
serves ``chip_smoke.py``'s ``[moe]`` schedule (32 requests sized to 256
positions, seed 1) through the paged engine with flash decode, once to
warm up and once under ``torch.profiler``; ``zamba2-7b`` at full width
and depth (bf16) runs ``launch.serve``'s single-shot batch (4 x 24
prompts, 12 tokens) the same way. For each, it prints the host and
device time per decode step (device = the sum of the kernels' time), the
device's busy share of the wall time, and the ops with the most device
time per step, each as a ``[prof]`` line, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.serve import (ONESHOT_GEN, oneshot_prompts,
                                      serve_batch)
from repro_torch.models import transformer as tf
from repro_torch.serving import (PagingConfig, ServingConfig, ServingEngine,
                                 generate_requests)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def report(tag: str, prof, wall: float, steps: int, rows: int,
           name: str) -> None:
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    print(f"[prof] {tag}: wall {1e3 * wall / steps:.2f} ms a step over "
          f"{steps} steps, device {1e3 * busy / steps:.2f} ms a step, busy "
          f"{100 * busy / wall:.1f}% | {name}")
    ops = sorted((e for e in ka
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:rows]:
        print(f"[prof] {tag}:   {e.key[:48]:<48} "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms a step "
              f"({100 * e.self_device_time_total / 1e6 / busy:5.1f}%), "
              f"{e.count / steps:.1f} calls")


def moe(rows: int, name: str) -> None:
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=4)
    params = tf.init_params(cfg, seed=0, device="cuda")
    max_seq = 256
    reqs = generate_requests(
        32, rate_rps=60.0, vocab_size=cfg.vocab_size, prompt_rng=(4, 32),
        gen_short=(1, 12), gen_long=(64, 128), seed=1)

    def engine():
        return ServingEngine(params, cfg, serving=ServingConfig(
            max_batch=16, max_seq=max_seq, decode_kernel="flash",
            paging=PagingConfig(page_size=16)), device="cuda")
    engine().run_closed_loop(reqs)
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run_closed_loop(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("llama4-scout-17b-a16e 4 layers, paged engine, whole run "
           "(prefill included) per decode step", prof, wall,
           st.decode_dispatches, rows, name)


def hybrid(rows: int, name: str) -> None:
    cfg = get_config("zamba2-7b")
    params = tf.init_params(cfg, seed=0, device="cuda")
    prompts = oneshot_prompts(cfg, 0)
    serve_batch(params, cfg, prompts, ONESHOT_GEN)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = serve_batch(params, cfg, prompts, ONESHOT_GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert np.asarray(out.cpu()).shape == (4, ONESHOT_GEN)
    report("zamba2-7b single-shot batch (prefill included) per lockstep "
           "step", prof, wall, ONESHOT_GEN, rows, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=12)
    args = ap.parse_args()
    name = card()
    moe(args.rows, name)
    torch.cuda.empty_cache()
    hybrid(args.rows, name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
