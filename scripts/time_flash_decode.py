#!/usr/bin/env python3
"""Time the port's paged flash-decode at the served shapes on one CUDA card.

    PYTHONPATH=src python3 scripts/time_flash_decode.py [--label NAME]

Three yardsticks for the same call, ``flash_decode`` over one layer's
pool at ``mlitb-lm-100m``'s serving shapes (B 16, H 12, K 4, D 64, pages
of 16, 32 pages per row, f32), cycling over 12 layers' pools as a decode
step does:

- ``host_us``: the host's time per call, 240 calls queued without a sync
  (the wrapper's own cost, where the card keeps up);
- ``eager_us``: 240 back-to-back calls between two CUDA events, the time
  a caller that launches eagerly pays (the larger of host and device);
- ``graph_us``: the same 240 calls captured in a CUDA graph and
  replayed, the device time per call.

It calls only the public ``flash_decode`` of whatever ``repro_torch`` the
path holds, so running it with ``PYTHONPATH`` set to another checkout's
``src`` times that checkout with the same yardsticks. Prints one
``[fd]`` line and one JSON line per run; ``--repeat`` runs it again in
the same process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

import repro_torch
from repro_torch.kernels.flash_decode.ops import flash_decode

B, H, K, D, PS, P, LAYERS, CALLS = 16, 12, 4, 64, 16, 32, 12, 240


def inputs(seed: int):
    gen = torch.Generator().manual_seed(seed)
    N = B * P
    q = torch.randn(LAYERS, B, H, D, generator=gen)
    kp = torch.randn(LAYERS, N, PS, K, D, generator=gen)
    vp = torch.randn(LAYERS, N, PS, K, D, generator=gen)
    pos = torch.randint(0, P * PS, (B,), generator=gen, dtype=torch.int32)
    perm = torch.randperm(N, generator=gen)
    pm = torch.full((B, P), N, dtype=torch.int32)
    for b in range(B):
        used = int(pos[b]) // PS + 1
        pm[b, :used] = perm[b * P:b * P + used].to(torch.int32)
    live = torch.ones(B, dtype=torch.int32)
    return [t.cuda() for t in (q, kp, vp, pm, pos, live)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_decode: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    q, kp, vp, pm, pos, live = inputs(args.seed)
    it = [0]

    def call():
        i = it[0] % LAYERS
        it[0] += 1
        flash_decode(q[i], kp[i], vp[i], pm, pos, live)

    for _ in range(3):
        call()                                 # build, load, warm up
    torch.cuda.synchronize()
    for run in range(args.repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        host_us = (time.perf_counter() - t0) / CALLS * 1e6
        torch.cuda.synchronize()

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            call()
        end.record()
        torch.cuda.synchronize()
        eager_us = start.elapsed_time(end) / CALLS * 1e3

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                call()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        graph_us = start.elapsed_time(end) / (10 * CALLS) * 1e3
        res = {"label": args.label, "run": run, "host_us": host_us,
               "eager_us": eager_us, "graph_us": graph_us,
               "live_tokens": int((pos.long() + 1).sum()),
               "repro_torch": repro_torch.__file__, "card": card}
        print(f"[fd] host {args.label} run {run}: {host_us:.1f} us of host "
              f"time per call, {eager_us:.1f} us per call eagerly, "
              f"{graph_us:.1f} us per call from a CUDA graph | {card}")
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
