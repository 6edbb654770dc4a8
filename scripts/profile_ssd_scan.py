#!/usr/bin/env python3
"""Device time of each kernel of the port's Mamba2 SSD scan on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_ssd_scan.py

Runs the public ``repro_torch.kernels.ssd_scan`` at ``mamba2-780m``'s
widths (48 heads of 64, d_state 128, chunk 128, f32, 2048 steps) for 4
sequences and for one, ``--calls`` calls under ``torch.profiler``, and
prints one ``[ssd-prof]`` line per kernel with its device time per call
(the chunk states with C B^T, the state pass, the chunk scan), then their
sum beside the time per call between two CUDA events. Inputs are drawn
as ``scripts/time_ssd_scan.py`` draws them.
"""
from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ssd_scan

S, NH, HD, N, CHUNK = 2048, 48, 64, 128, 128


def inputs(B: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, S, NH, HD)
    dt = torch.nn.functional.softplus(randn(B, S, NH))
    A = -torch.exp(randn(NH) * 0.5)
    return x, dt, A, randn(B, S, N) * 0.5, randn(B, S, N) * 0.5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd_scan: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for B in (4, 1):
        ins = inputs(B, args.seed)
        for _ in range(3):
            ssd_scan(*ins, chunk=CHUNK)             # build, load, warm up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.calls):
            ssd_scan(*ins, chunk=CHUNK)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.calls
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                ssd_scan(*ins, chunk=CHUNK)
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us and "kernel" in e.key:
                name = e.key.split("::")[-1].split("<")[0].split("(")[0]
                total += us / args.calls
                print(f"[ssd-prof] B {B}: {name} {us / args.calls:.1f} us "
                      f"per call ({e.count // args.calls} launch(es) a "
                      f"call) | {card}")
        print(f"[ssd-prof] B {B}: kernels {total:.1f} us per call, "
              f"{ms * 1e3:.1f} us between CUDA events | {card}")
        del ins
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
