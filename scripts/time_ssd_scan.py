#!/usr/bin/env python3
"""Time the port's Mamba2 SSD scan at mamba2-780m's widths on one CUDA card.

    PYTHONPATH=src python3 scripts/time_ssd_scan.py [--label NAME]

``ssd_scan`` over one layer's scan at ``mamba2-780m``'s widths (48 heads
of 64, d_state 128, chunk 128, f32, 2048 steps) for 4 sequences and for
one, inputs drawn from a seed with ``chip_smoke.py``'s recipe. For each
batch size: the device time per call, ``--calls`` calls queued back to
back between two CUDA events after three warm-up calls, and the largest
difference from the first call's output over the runs (0 when every
call gives the same bits).

It calls only the public ``repro_torch.kernels.ssd_scan`` of whatever
``repro_torch`` the path holds, so running it with ``PYTHONPATH`` set to
another checkout's ``src`` times that checkout with the same yardstick.
Prints one ``[ssd]`` line and one JSON line per batch size and run;
``--repeat`` runs it again in the same process.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

import repro_torch
from repro_torch.kernels import ssd_scan

S, NH, HD, N, CHUNK = 2048, 48, 64, 128, 128


def inputs(B: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, S, NH, HD)
    dt = F.softplus(randn(B, S, NH))
    A = -torch.exp(randn(NH) * 0.5)
    return x, dt, A, randn(B, S, N) * 0.5, randn(B, S, N) * 0.5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ssd_scan: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for B in (4, 1):
        ins = inputs(B, args.seed)
        first = ssd_scan(*ins, chunk=CHUNK)      # build, load
        for _ in range(2):
            ssd_scan(*ins, chunk=CHUNK)
        torch.cuda.synchronize()
        for run in range(args.repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.calls):
                y = ssd_scan(*ins, chunk=CHUNK)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.calls
            drift = float((y.float() - first.float()).abs().max())
            res = {"label": args.label, "B": B, "run": run, "ms": ms,
                   "max_abs_drift": drift, "calls": args.calls,
                   "repro_torch": repro_torch.__file__, "card": card}
            print(f"[ssd] {args.label} B {B} run {run}: {ms:.4f} ms per call "
                  f"(S {S}, nh {NH}, hd {HD}, N {N}, chunk {CHUNK}, f32), "
                  f"drift {drift:.1e} | {card}")
            print(json.dumps(res))
        del ins, first, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
