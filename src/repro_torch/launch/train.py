"""Training launcher: the paper's elastic, deadline-bounded event loop
trains a dense LM through the simulated browser fleet on the card (port
of ``repro.launch.train``'s ``--simulate`` path).

  python -m repro_torch.launch.train --arch mlitb-lm-100m --simulate \\
      --steps 10 --lr 0.003
  PYTHONPATH=src python -m repro_torch.launch.train --simulate --reduced \\
      --steps 4 --device cpu

``build_training``'s fleet (two workstations, a laptop, a straggler) takes
``--steps`` iterations of ``--T`` seconds of simulated time, each worker
computing real next-token gradients of ``--arch`` (random weights from
``--seed``), reduced through the fused top-k channel with AdaGrad
(``--lr``: the default 0.1 suits the reduced and tiny LMs; at full width
it diverges, and 0.003 trains). The run prints the simulated clock and
the loss, then the host ms per iteration and the ms per reduce step
(CUDA events) on the card.

Not ported yet: the mesh engine behind a run without ``--simulate``
(ROADMAP A10) and the hierarchy behind ``--regions > 1`` (ROADMAP A5);
both raise.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.core.event_loop import IterationLog, MasterEventLoop
from repro_torch.kernels.runtime import DeviceLike, resolve_device


@dataclass
class LMRun:
    logs: List[IterationLog]
    iter_s: List[float]          # host seconds per iteration, each ending
                                 # in a device sync
    reduce_ms: List[float]       # CUDA-event ms per reduce step (card only)
    loop: MasterEventLoop


def run_lm(cfg, *, steps: int, T: float = 0.5, seed: int = 0,
           device: DeviceLike = "cuda", training=None,
           **build_kw) -> LMRun:
    """``steps`` iterations of ``build_training(cfg)`` on ``device``
    (``training`` defaults to the ``--simulate`` path's: T and a 0.5
    deadline quantile; ``build_kw`` goes to ``build_training``), timed
    per iteration on the host and per reduce step with CUDA events."""
    from repro_torch.core import TrainingConfig
    from repro_torch.core.config import DeadlineConfig
    from repro_torch.launch.train_serve import build_training

    dev = resolve_device(device)
    if training is None:
        training = TrainingConfig(T=T, deadline=DeadlineConfig(quantile=0.5))
    loop, _, _ = build_training(cfg, training=training, seed=seed,
                                device=dev, **build_kw)
    events = []
    if dev.type == "cuda":
        reduce = loop.reducer.reduce_and_step

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = reduce(*a, **kw)
            ev[1].record()
            events.append(ev)
            return out

        loop.reducer.reduce_and_step = timed
    logs, iter_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logs.append(loop.iteration())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        iter_s.append(time.perf_counter() - t0)
    return LMRun(logs=logs, iter_s=iter_s,
                 reduce_ms=[s.elapsed_time(e) for s, e in events], loop=loop)


def run_simulated(cfg, *, steps: int, regions: int, T: float, seed: int,
                  lr: float = 0.1, device: DeviceLike = "cuda") -> int:
    """The discrete-event path behind ``--simulate``, flat
    (``regions=1``) only."""
    if regions > 1:
        raise NotImplementedError(
            f"--regions {regions}: the two-tier hierarchy is not ported yet "
            f"(ROADMAP A5)")
    dev = resolve_device(device)
    run = run_lm(cfg, steps=steps, T=T, seed=seed, device=dev, lr=lr)
    losses = [lg.loss for lg in run.logs if lg.loss == lg.loss]
    print(f"flat: {len(run.logs)} iterations, "
          f"clock={run.loop.clock:.2f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if dev.type == "cuda":
        ms = sorted(1e3 * x for x in run.iter_s)
        red = sorted(run.reduce_ms)
        print(f"device={torch.cuda.get_device_name(dev)} host ms per "
              f"iteration: median {ms[len(ms) // 2]:.2f} (range "
              f"{ms[0]:.2f}-{ms[-1]:.2f}); ms per reduce step: median "
              f"{red[len(red) // 2]:.2f} over {len(red)} (range "
              f"{red[0]:.2f}-{red[-1]:.2f})")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mlitb-lm-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate", action="store_true",
                    help="drive the discrete-event simulated fleet "
                         "(build_training); required: the mesh engine is "
                         "not ported")
    ap.add_argument("--regions", type=int, default=1,
                    help="with --simulate: >1 is the two-tier hierarchy "
                         "(not ported)")
    ap.add_argument("--T", type=float, default=0.5,
                    help="with --simulate: iteration budget (s)")
    ap.add_argument("--lr", type=float, default=0.1,
                    help="with --simulate: AdaGrad's learning rate")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if not args.simulate:
        raise NotImplementedError(
            "training without --simulate runs the multi-device mesh engine, "
            "which is not ported yet (ROADMAP A10)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return run_simulated(cfg, steps=args.steps, regions=args.regions,
                         T=args.T, seed=args.seed, lr=args.lr,
                         device=args.device)


if __name__ == "__main__":
    main()
