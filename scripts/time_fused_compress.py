#!/usr/bin/env python3
"""Time the port's fused block-top-k compressor over the LM's flat buffer.

    PYTHONPATH=src python3 scripts/time_fused_compress.py [--label NAME]

``fused_block_topk_batched`` over one worker's 100 682 496 entries (the
``mlitb-lm-100m`` flat buffer) at the wide rows (block_w 2048, k 16 and
8192, k 64) on three buffers drawn from a seed: ``randn`` (g, and r at
0.1), ``ties`` (integers in -3..3, r = 0) and ``sparse`` (99.5% zeros);
and on the randn buffer at the warp path's edge, block_w 512 to 1024
with k = block_w / 128, and k 4 at 512 and 1024. For each shape: the
device time per call, ``--calls`` calls queued back to back between two
CUDA events after three warm-up calls, best of ``--repeat`` runs; the
route the plan took (where the checkout names its routes); and the
outputs held bit for bit against the checkout's plain version.

It calls only the public wrapper and plain version of whatever
``repro_torch`` the path holds, so running it with ``PYTHONPATH`` set to
another checkout's ``src`` times that checkout with the same yardstick:
unpack the parent commit with ``git archive`` into the git-ignored
``build/`` and run parent, change, change, parent in one chip call.
Prints one ``[fused]`` line per shape and the card line, and writes
``chiprun_out/time_fused_compress-<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

import repro_torch
from repro_torch.kernels.topk_compress import ops
from repro_torch.kernels.topk_compress.ref import \
    fused_block_topk_batched_ref

N = 100_682_496
WIDE = ((2048, 16), (8192, 64))
EDGE = ((512, 4), (640, 5), (768, 6), (896, 7), (1024, 4), (1024, 8))


def buffers(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn():
        return torch.randn(1, N, generator=gen, device="cuda")
    g = randn()
    zeros = torch.zeros(1, N, device="cuda")
    return {"randn": (g, randn() * 0.1),
            "ties": (torch.randint(-3, 4, (1, N), generator=gen,
                                   device="cuda").float(), zeros),
            "sparse": (g * (torch.rand(1, N, generator=gen, device="cuda")
                            < 0.005), zeros)}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def device_ms(fn, calls: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_compress: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    bufs = buffers(args.seed)
    cases = [(kind, W, k) for W, k in WIDE for kind in bufs]
    cases += [("randn", W, k) for W, k in EDGE]
    rows = []
    for kind, W, k in cases:
        g, r = bufs[kind]

        def call(g=g, r=r, W=W, k=k):
            return ops.fused_block_topk_batched(g, r, k=k, block_w=W)
        out = call()
        ref = fused_block_topk_batched_ref(g, r, k=k, block_w=W)
        torch.cuda.synchronize()
        exact = all(same_bits(a, b) for a, b in zip(out, ref))
        del out, ref
        ms = min(device_ms(call, args.calls) for _ in range(args.repeat))
        route = (ops.route(W, min(k, W)) if hasattr(ops, "route") else
                 "warp" if W <= ops.WARP_BLOCK_W else "block")
        rows.append({"label": args.label, "buffer": kind, "block_w": W,
                     "k": k, "route": route, "ms": ms, "bit_exact": exact})
        print(f"[fused] {args.label} {kind} block_w {W} k {k} ({route}): "
              f"{ms:.3f} ms, bit-exact {exact} | {card}")
        if not exact:
            raise SystemExit(f"time_fused_compress: {kind} block_w {W} k "
                             f"{k} differs from the plain version")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"time_fused_compress-{args.label}.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__,
         "package": str(Path(repro_torch.__file__).parent), "rows": rows},
        indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
