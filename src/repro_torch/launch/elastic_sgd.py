"""The paper's Figure-1 scenario on the card: elastic, time-budgeted
distributed SGD of the MLitB §3.5 conv net (port of
``examples/elastic_sgd_demo.py``).

A researcher posts a learning problem; grid workstations, laptops and
phones join over time, contribute time-budgeted gradient computation, one
drops out — and the model converges anyway. The master event loop
(MLitB §3.3) reduces every iteration's messages through the packed §5.1
channel: top-1 per 32-entry block of each worker's error-corrected
gradient, all workers in ONE launch of the fused block-top-k CUDA kernel,
then AdaGrad (lr 0.02).

  python -m repro_torch.launch.elastic_sgd
  PYTHONPATH=src python -m repro_torch.launch.elastic_sgd --device cpu

Each iteration prints the simulated clock, the workers reduced, their
power, the loss, the held-out test error and the packed wire KiB; the
last line gives the kernel's launches and the host time per iteration.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from repro_torch.core import (AdaptiveScheduler, GradientCompressor,
                              JoinEvent, LeaveEvent, MasterEventLoop,
                              MasterReducer, UploadDataEvent)
from repro_torch.core.event_loop import IterationLog
from repro_torch.core.simulation import (LAPTOP, PHONE, WORKSTATION,
                                         SimulatedCluster, make_cnn_problem)
from repro_torch.data.datasets import synthetic_mnist
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.kernels.topk_compress import COUNTER
from repro_torch.optim import adagrad

# iteration -> membership events (the JAX example's schedule)
SCHEDULE = {
    2: [("join", "grid0", WORKSTATION), ("join", "grid1", WORKSTATION)],
    4: [("join", "laptop0", LAPTOP), ("join", "phone0", PHONE)],
    7: [("leave", "grid1", None)],           # tab closed
    9: [("join", "phone1", PHONE)],
}
N_TEST = 500
TEST_SEED = 123


@dataclass
class DemoRun:
    logs: List[IterationLog]
    test_err: List[float]
    iter_s: List[float]          # host seconds per iteration, ending in a
                                 # device sync (the eval is not included)
    loop: MasterEventLoop
    launches: int                # fused_compress kernel launches


def run_demo(*, iterations: int = 14, n_data: int = 6000, seed: int = 0,
             device: DeviceLike = "cuda", init_params=None,
             callback: Optional[Callable[[MasterEventLoop, IterationLog,
                                          float], None]] = None) -> DemoRun:
    """Run the scenario; ``init_params`` (a conv-net parameter dict on
    ``device``) replaces the seeded initialisation. Counts kernel
    launches from zero."""
    dev = resolve_device(device)
    init_p, grad_fn, eval_fn = make_cnn_problem(seed, device=dev)
    X, y = synthetic_mnist(n_data, seed=seed)
    Xt, yt = synthetic_mnist(N_TEST, seed=TEST_SEED)
    Xt, yt = torch.from_numpy(Xt).to(dev), torch.from_numpy(yt).to(dev)
    params = init_p() if init_params is None else init_params
    # workers ship the packed §5.1 channel: top-1 per 32-entry block = one
    # 8B (value, index) pair per 128 dense bytes
    red = MasterReducer(params, adagrad(lr=0.02),
                        compressor=GradientCompressor("blocktopk",
                                                      frac=1 / 32,
                                                      block_w=32))
    cluster = SimulatedCluster(grad_fn=grad_fn, data=(X, y), mode="real",
                               seed=seed, device=dev)
    loop = MasterEventLoop(reducer=red, cluster=cluster,
                           scheduler=AdaptiveScheduler(T=1.0))
    loop.submit(UploadDataEvent(range(n_data)))
    # the researcher's own workstation starts alone
    cluster.add_worker("desk0", WORKSTATION)
    loop.submit(JoinEvent("desk0", capacity=3000))
    COUNTER.reset()
    logs, errs, iter_s = [], [], []
    for it in range(iterations):
        for kind, w, prof in SCHEDULE.get(it, []):
            if kind == "join":
                cluster.add_worker(w, prof)
                loop.submit(JoinEvent(w, capacity=3000))
            else:
                loop.submit(LeaveEvent(w))
        t0 = time.perf_counter()
        log = loop.iteration()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        iter_s.append(time.perf_counter() - t0)
        err = eval_fn(red.params, Xt, yt)
        logs.append(log)
        errs.append(err)
        if callback is not None:
            callback(loop, log, err)
    return DemoRun(logs=logs, test_err=errs, iter_s=iter_s, loop=loop,
                   launches=COUNTER.count)


def format_line(loop: MasterEventLoop, log: IterationLog, err: float) -> str:
    """The example's per-iteration line."""
    evs = f" {log.events}" if log.events else ""
    return (f"t={loop.clock:6.1f}s iter {log.step:2d} "
            f"workers {log.n_workers} power {log.power:5.0f} v/s "
            f"loss {log.loss:6.3f} test-err {err:.3f} "
            f"wire {log.wire_bytes / 1024:5.1f}KiB{evs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iterations", type=int, default=14)
    ap.add_argument("--n-data", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--trace", action="store_true",
                    help="run the scenario a second time under "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = run_demo(iterations=args.iterations, n_data=args.n_data,
                   seed=args.seed, device=dev,
                   callback=lambda lp, lg, e: print(format_line(lp, lg, e)))
    print("\nper-device contribution (time-budgeted, heterogeneous):")
    for w, st in sorted(run.loop.scheduler.stats.items()):
        print(f"  {w:8s} power~{st.power:6.0f} v/s   "
              f"total {st.total_vectors} vectors")
    steps = run.loop.reducer.step
    print(f"device={dev} reduce steps {steps}, fused_compress kernel "
          f"launches {run.launches}, host "
          f"{1e3 * sum(run.iter_s) / max(len(run.iter_s), 1):.2f} ms per "
          f"iteration (mean of {len(run.iter_s)}; median "
          f"{1e3 * sorted(run.iter_s)[len(run.iter_s) // 2]:.2f})")
    if args.trace:
        print_trace(args, dev)
    return 0


def print_trace(args, dev: torch.device) -> None:
    """Run the scenario again (warm) under ``torch.profiler``; print the
    ops with the most self time on the device (or the CPU, without a
    card), the device's busy share of the wall time and the per-iteration
    host times."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run = run_demo(iterations=args.iterations, n_data=args.n_data,
                       seed=args.seed, device=dev)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    key = "self_device_time_total" if dev.type == "cuda" \
        else "self_cpu_time_total"
    print(ka.table(sort_by=key, row_limit=15))
    # device busy time: the device-side (kernel / memcpy) events only;
    # the aten ops that launched them carry the same time again
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type != torch.autograd.DeviceType.CPU)
    iters = len(run.iter_s)
    print(f"trace: wall {wall:.3f}s for {iters} iterations (eval "
          f"included); device busy {busy_us / 1e6:.3f}s "
          f"({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{busy_us / 1e3 / max(iters, 1):.2f} ms device time per "
          f"iteration; host ms per iteration "
          f"{[round(1e3 * x, 2) for x in run.iter_s]}")


if __name__ == "__main__":
    main()
