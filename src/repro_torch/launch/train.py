"""Training launcher: elastic distributed SGD on synthetic LM data, on
the card (port of ``repro.launch.train``).

Without ``--simulate`` it runs the production path end to end: config ->
model -> train step -> ``ElasticMeshSGD`` (the paper's event semantics:
``--n-workers`` virtual workers, row slices of the batch, leaving and
joining per ``--churn``) -> research-closure checkpoint:

  # ~100M model, a few hundred steps (examples/train_e2e.py's 100m
  # preset; at full width AdaGrad's default lr 0.05 oscillates, 0.003
  # trains)
  python -m repro_torch.launch.train --arch mlitb-lm-100m \\
      --steps 300 --batch 8 --seq 256 --closure-out model.json --lr 0.003

  # any assigned arch, reduced variant, with worker churn, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 20 --churn 10:leave:1,15:join:1 --device cpu

It prints each churn event, a step line every ``--log-every`` steps and
the final loss in the reference's format (``device=`` names the card
where the reference counts devices); on the card also the ms per step
(CUDA events, and the host clock ending in the metrics' host copy), the
tokens/s and the peak memory. ``--lr`` defaults per optimizer: AdaGrad
0.05, Adam 3e-4, SGD 0.1.

With ``--simulate`` it drives the discrete-event simulated browser fleet
instead (``build_training``):

  python -m repro_torch.launch.train --arch mlitb-lm-100m --simulate \\
      --steps 10 --lr 0.003
  python -m repro_torch.launch.train --simulate --regions 4 --steps 8 \\
      --lr 0.003
  PYTHONPATH=src python -m repro_torch.launch.train --simulate --reduced \\
      --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --simulate --reduced \\
      --steps 8 --regions 4 --device cpu

``build_training``'s fleet (two workstations, a laptop, a straggler) takes
``--steps`` iterations of ``--T`` seconds of simulated time, each worker
computing real next-token gradients of ``--arch`` (random weights from
``--seed``), reduced through the fused top-k channel with AdaGrad
(``--lr``: the default 0.1 suits the reduced and tiny LMs; at full width
it diverges, and 0.003 trains). The run prints the simulated clock and
the loss, then the host ms per iteration and the ms per reduce step
(CUDA events) on the card.

``--regions R`` (R > 1) trains through the two-tier hierarchy instead
(``core/hierarchy.py``): R regional sub-masters, each over that fleet and
a 1/R shard of the data, H = 4 inner iterations per outer step and a
top-k 0.25 gossip of the deltas between them, ``max(1, steps // 4)``
outer steps. It prints the loss, the WAN bytes and their share of all
gradient traffic and the communication ratio, then, on the card, the
host ms per inner iteration, the ms per outer exchange (CUDA events
around compress + gossip + correction) and the peak memory.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.closure import ResearchClosure
from repro_torch.core.event_loop import IterationLog, MasterEventLoop
from repro_torch.core.hierarchy import HierarchicalMaster, OuterLog
from repro_torch.core.mesh_engine import ElasticMeshSGD
from repro_torch.data.datasets import synthetic_lm
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.optim import get_optimizer
from repro_torch.train.step import build_train_step, make_train_state

# --lr's default on the mesh path, per optimizer (the reference's)
MESH_LR = {"adagrad": 0.05, "adam": 3e-4, "sgd": 0.1}
# --lr's default with --simulate (build_training's)
SIMULATE_LR = 0.1


def data_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                device: DeviceLike = "cuda"
                ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless (batch, seq) next-token batches of the reference's stream:
    ``synthetic_lm(2_000_000, min(vocab, 65_536))`` and one
    ``RandomState(seed)`` drawing the window starts, so the same numbers
    as ``repro``'s; ``tokens`` / ``labels`` are int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    toks = synthetic_lm(2_000_000, vocab=min(vocab, 65_536), seed=seed)
    rng = np.random.RandomState(seed)

    def stream():
        while True:
            starts = rng.randint(0, len(toks) - seq - 1, size=batch)
            x = np.stack([toks[s:s + seq] for s in starts])
            y = np.stack([toks[s + 1:s + seq + 1] for s in starts])
            yield {"tokens": torch.from_numpy(x).to(dev),
                   "labels": torch.from_numpy(y).to(dev)}
    return stream()


def parse_churn(spec: str) -> Dict[int, List[Tuple[str, int]]]:
    """'10:leave:1,15:join:1' -> {step: [(kind, worker_idx)]}"""
    out: Dict[int, List[Tuple[str, int]]] = {}
    if not spec:
        return out
    for item in spec.split(","):
        step, kind, idx = item.split(":")
        out.setdefault(int(step), []).append((kind, int(idx)))
    return out


@dataclass
class MeshRun:
    engine: ElasticMeshSGD
    losses: List[float]
    step_ms: List[float]         # CUDA-event ms per step (card only)
    host_ms: List[float]         # host ms per step, ending in the
                                 # metrics' host copy
    peak_mem_bytes: int          # peak device memory (card; else 0)


def run_mesh(cfg, *, steps: int, lr: float, batch: int = 8, seq: int = 128,
             optimizer: str = "adagrad", n_workers: int = 4, churn: str = "", seed: int = 0,
             remat: bool = False, log_every: int = 10,
             device: DeviceLike = "cuda") -> MeshRun:
    """``steps`` steps of ``ElasticMeshSGD`` over ``build_train_step(cfg)``
    on ``device`` (random weights from ``seed``, ``data_stream``'s
    batches), applying ``churn`` (``parse_churn``'s spec) before the
    steps it names; prints the churn events and every ``log_every``-th
    step as the reference's launcher does. Each step is timed on the
    host and, on the card, with CUDA events."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    opt = get_optimizer(optimizer, lr=lr)
    state = make_train_state(init_params(cfg, seed=seed, device=dev), opt)
    eng = ElasticMeshSGD(train_step=build_train_step(cfg, opt, remat=remat),
                         state=state, n_workers=n_workers,
                         global_batch=batch)
    events = parse_churn(churn)
    stream = data_stream(cfg.vocab_size, batch, seq, seed, device=dev)
    t0 = time.time()
    losses, host_ms, cuda_ev = [], [], []
    for i in range(steps):
        for kind, idx in events.get(i, []):
            getattr(eng, kind)(idx)
            print(f"step {i}: worker {idx} {kind}s "
                  f"({eng.n_live}/{eng.n_workers} live)")
        b = next(stream)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) if cuda else None
        t = time.perf_counter()
        if ev:
            ev[0].record()
        metrics = eng.step(b)
        if ev:
            ev[1].record()
            cuda_ev.append(ev)
        host_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(metrics["loss"])
        if i % log_every == 0 or i == steps - 1:
            tok_s = metrics["tokens"] * (i + 1) / max(time.time() - t0, 1e-9)
            print(f"step {i:5d} loss {metrics['loss']:.4f} "
                  f"tokens {int(metrics['tokens'])} live {eng.n_live} "
                  f"({tok_s:.0f} tok/s)")
    if cuda:
        torch.cuda.synchronize(dev)
    return MeshRun(engine=eng, losses=losses,
                   step_ms=[s.elapsed_time(e) for s, e in cuda_ev],
                   host_ms=host_ms,
                   peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0))


def print_mesh_timing(run: MeshRun, device: torch.device) -> None:
    """The card's line: ms per step (CUDA events, and the host clock
    ending in the metrics' host copy), median and range; tokens/s over
    the steps' host time; peak memory."""
    ev, host = sorted(run.step_ms), sorted(run.host_ms)
    tokens = sum(h["tokens"] for h in run.engine.history)
    print(f"device={torch.cuda.get_device_name(device)} ms per step: "
          f"median {ev[len(ev) // 2]:.2f} (range {ev[0]:.2f}-{ev[-1]:.2f}) "
          f"CUDA events, median {host[len(host) // 2]:.2f} (range "
          f"{host[0]:.2f}-{host[-1]:.2f}) host; "
          f"{1e3 * tokens / sum(run.host_ms):.0f} tokens/s; peak memory "
          f"{run.peak_mem_bytes / 2**30:.2f} GiB")


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


@dataclass
class HierRun:
    logs: List[OuterLog]
    iter_s: List[float]          # host seconds per inner iteration (all
                                 # regions), each ending in a device sync
    outer_ms: List[float]        # CUDA-event ms per outer exchange (card)
    peak_mem_bytes: int          # peak device memory (card; else 0)
    master: HierarchicalMaster
    cluster: Any


def run_hierarchy(cfg, *, outer_steps: int, hierarchy, T: float = 0.5,
                  seed: int = 0, device: DeviceLike = "cuda",
                  **build_kw) -> HierRun:
    """``outer_steps`` outer steps of ``build_training(cfg)``'s two-tier
    hierarchy (``hierarchy``: a ``HierarchyConfig``) on ``device``, with
    the ``--simulate`` path's T and 0.5 deadline quantile; every inner
    iteration timed on the host, every outer exchange with CUDA events."""
    from repro_torch.core import TrainingConfig
    from repro_torch.core.config import DeadlineConfig
    from repro_torch.launch.train_serve import build_training

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    training = TrainingConfig(T=T, deadline=DeadlineConfig(quantile=0.5),
                              hierarchy=hierarchy)
    master, cluster, _ = build_training(cfg, training=training, seed=seed,
                                        device=dev, **build_kw)
    iter_s, events = [], []

    def timed_iteration(fn):
        def inner():
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize(dev)
            iter_s.append(time.perf_counter() - t0)
            return out
        return inner

    for loop in master.regions.values():
        loop.iteration = timed_iteration(loop.iteration)
    if cuda:
        exchange = master._outer_exchange

        def timed_exchange(live):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = exchange(live)
            ev[1].record()
            events.append(ev)
            return out

        master._outer_exchange = timed_exchange
    logs = master.run(outer_steps)
    if cuda:
        torch.cuda.synchronize(dev)
    return HierRun(logs=logs, iter_s=iter_s,
                   outer_ms=[s.elapsed_time(e) for s, e in events],
                   peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0),
                   master=master, cluster=cluster)


def run_simulated(cfg, *, steps: int, regions: int, T: float, seed: int,
                  lr: float = SIMULATE_LR, device: DeviceLike = "cuda"
                  ) -> int:
    """The discrete-event path behind ``--simulate``: flat
    (``regions=1``) or two-tier."""
    dev = resolve_device(device)
    if regions > 1:
        from repro_torch.core import HierarchyConfig

        hier = HierarchyConfig(n_regions=regions, inner_steps=4,
                               gossip=True, gossip_frac=0.25)
        outer = max(1, steps // hier.inner_steps)
        run = run_hierarchy(cfg, outer_steps=outer, hierarchy=hier, T=T,
                            seed=seed, device=dev, lr=lr)
        master = run.master
        losses = [lg.loss for lg in run.logs if lg.loss == lg.loss]
        s = master.summary()
        print(f"hierarchy: {regions} regions x {hier.inner_steps} inner, "
              f"{outer} outer steps, clock={master.clock:.2f}s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        print(f"wan: {s['wan_bytes']} bytes "
              f"({100 * s['wan_bytes_frac']:.2f}% of gradient traffic), "
              f"comm ratio {s['communication_ratio']:.3f}")
        if dev.type == "cuda":
            ms = sorted(1e3 * x for x in run.iter_s)
            ex = sorted(run.outer_ms)
            print(f"device={torch.cuda.get_device_name(dev)} host ms per "
                  f"inner iteration: median {ms[len(ms) // 2]:.2f} (range "
                  f"{ms[0]:.2f}-{ms[-1]:.2f}); ms per outer exchange: "
                  f"median {ex[len(ex) // 2]:.2f} over {len(ex)} (range "
                  f"{ex[0]:.2f}-{ex[-1]:.2f}); peak memory "
                  f"{run.peak_mem_bytes / 2**30:.2f} GiB")
        return 0
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adagrad",
                    choices=["adagrad", "adam", "sgd"])
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 0.05 / 3e-4 / 0.1 for adagrad / adam / "
                         "sgd; with --simulate 0.1 (AdaGrad)")
    ap.add_argument("--n-workers", type=int, default=4,
                    help="virtual workers (data slices)")
    ap.add_argument("--churn", default="",
                    help="step:leave|join:worker_idx,...")
    ap.add_argument("--closure-out", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate", action="store_true",
                    help="drive the discrete-event simulated fleet "
                         "(build_training) instead of the mesh engine")
    ap.add_argument("--regions", type=int, default=1,
                    help="with --simulate: >1 builds the two-tier "
                         "hierarchy")
    ap.add_argument("--T", type=float, default=0.5,
                    help="with --simulate: iteration budget (s)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.simulate:
        return run_simulated(cfg, steps=args.steps, regions=args.regions,
                             T=args.T, seed=args.seed,
                             lr=SIMULATE_LR if args.lr is None else args.lr,
                             device=dev)
    lr = MESH_LR[args.optimizer] if args.lr is None else args.lr
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"device={name}")
    run = run_mesh(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   optimizer=args.optimizer, lr=lr, n_workers=args.n_workers,
                   churn=args.churn, seed=args.seed,
                   log_every=args.log_every, device=dev)
    if dev.type == "cuda":
        print_mesh_timing(run, dev)
    losses = run.losses
    if args.closure_out:
        clo = ResearchClosure(
            arch=cfg.name, config=cfg,
            algorithm={"optimizer": args.optimizer, "lr": lr,
                       "reduce": "weighted-mean", "steps": args.steps},
            params=run.engine.state["params"],
            metrics=[{"step": i, "loss": float(v)}
                     for i, v in enumerate(losses)],
            step=args.steps)
        clo.save(args.closure_out)
        print(f"saved research closure -> {args.closure_out} "
              f"(digest {clo.digest})")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return 0


if __name__ == "__main__":
    main()
