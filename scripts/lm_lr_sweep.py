#!/usr/bin/env python3
"""AdaGrad learning rates for the simulated fleet's LM, on one CUDA card.

    PYTHONPATH=src python3 scripts/lm_lr_sweep.py [--steps 12]

``repro_torch.launch.train.run_lm`` (``build_training``'s fleet, T 0.5 s,
deadline quantile 0.5, the ``topk`` channel, random weights from seed 0)
trains ``mlitb-lm-100m`` at full width once per learning rate in
``--lrs`` and prints each run's loss per iteration, late workers, host ms
per iteration and ms per reduce step (CUDA events). Then, at
``mlitb-lm-100m.reduced()``, it runs the same fleet on the card and on
the CPU at each rate of ``--reduced-lrs`` and prints the largest
relative loss difference over ``--reduced-steps`` iterations: what the
card-against-CPU gate of ``chip_smoke.py`` would see at that rate.
"""
from __future__ import annotations

import argparse
import gc
import math
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import run_lm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[0.1, 0.03, 0.01, 0.003, 0.001])
    ap.add_argument("--reduced-steps", type=int, default=8)
    ap.add_argument("--reduced-lrs", type=float, nargs="+",
                    default=[0.1, 0.003])
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config("mlitb-lm-100m")
    for lr in args.lrs:
        run = run_lm(cfg, steps=args.steps, seed=0, device="cuda", lr=lr)
        logs = run.logs
        print(f"[lr] {lr}: loss {[round(lg.loss, 2) for lg in logs]}; late "
              f"{[lg.n_late for lg in logs]}; host ms "
              f"{[round(1e3 * x, 1) for x in run.iter_s]}; reduce ms "
              f"{[round(x, 2) for x in run.reduce_ms]} | {card}",
              flush=True)
        del run, logs
        gc.collect()            # the loop's reference cycles hold 10+ GB
        torch.cuda.empty_cache()
    small = cfg.reduced()
    for lr in args.reduced_lrs:
        a, b = (run_lm(small, steps=args.reduced_steps, seed=0, device=d,
                       lr=lr) for d in ("cuda", "cpu"))
        rel = [abs(x.loss - y.loss) / abs(y.loss)
               for x, y in zip(a.logs, b.logs) if math.isfinite(y.loss)]
        print(f"[reduced] lr {lr}: card vs CPU loss rel by iteration "
              f"{[f'{r:.1e}' for r in rel]} (max {max(rel):.2e}) | {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
