"""MLitB's fleet: ``MasterEventLoop.iteration`` over ``build_training``'s
simulated browsers, the paper's own §3.3 loop, as ``python -m
repro_torch.launch.train --simulate`` runs it.

Traffic keys: ``n_data`` windows of ``seq`` tokens (``traffic.
lm_windows``), ``T`` seconds of simulated time an iteration and the
deadline's ``deadline_quantile``, the top-k channel's ``frac``, AdaGrad's
``lr`` / ``eps``, ``check_reduces``, and ``schedule_seed``: the seed of
the simulated fleet's clock (latencies, stragglers, which rows each
worker takes). It is fixed, so every ``--seed`` gives the same schedule
and the same work, on other data and weights.

Set-up runs iterations until ``check_reduces`` reduce steps have been
taken, recording each worker's rows and the late set; the
reference replays them. The check compares each reduce's loss, each
leaf's norm of the first reduce's gradient (from AdaGrad's accumulator)
and each leaf's norm of the parameters' change after the last.
"""
from __future__ import annotations

import gc
import time
from typing import List

import torch

from perfbench import traffic, weights
from perfbench.drivers import Spans, Step, flat_tree, program_config
from perfbench.flops import train_flops_per_token
from perfbench.reference import fleet as ref_fleet
from perfbench.reference import train as ref
from perfbench.reference.train import Trace

MAX_SETUP_ITERATIONS = 24


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cfg = cell.config
        self.t = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.spans = Spans()
        self.flops_per_token = train_flops_per_token(self.cfg, self.t["seq"])
        self.precision = self.cfg["param_dtype"]
        self.iterations: List[ref_fleet.Iteration] = []
        self.prog = Trace()
        self._recording = False
        self.phases = {}

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import TrainingConfig
        from repro_torch.core.config import DeadlineConfig
        from repro_torch.core.flatbuf import flat_spec
        from repro_torch.launch.train_serve import build_training
        from repro_torch.optim import adagrad

        t = self.t
        clock = time.perf_counter()
        training = TrainingConfig(
            T=t["T"], deadline=DeadlineConfig(quantile=t["deadline_quantile"]))
        loop, cluster, _ = build_training(
            program_config(self.cfg), training=training,
            seed=t["schedule_seed"], n_data=t["n_data"], seq_len=t["seq"],
            frac=t["frac"], optimizer=adagrad(lr=t["lr"], eps=t["eps"]),
            churny=True, device=self.device,
            init_params=weights.nest(
                weights.make(self.cfg, self.seed, self.device)))
        X, y = traffic.lm_windows(self.cfg["vocab_size"], t["n_data"],
                                  t["seq"], self.seed)
        cluster.data = (torch.from_numpy(X).to(self.device),
                        torch.from_numpy(y).to(self.device))
        self.loop, self.cluster = loop, cluster
        self._wrap()

        self.phases["build"] = time.perf_counter() - clock
        clock = time.perf_counter()
        self._recording = True
        reduces = 0
        for _ in range(MAX_SETUP_ITERATIONS):
            self._begin()
            log = loop.iteration()
            it = self._current
            if it.kind == "reduce":
                reduces += 1
                self.prog.losses.append(log.loss)
                if reduces == 1:
                    acc = loop.reducer.opt_state["accum"]
                    spec = flat_spec(loop.reducer.params)
                    self.prog.grad_norms = {
                        "/".join(p): float(acc[o:o + s].double().sum().sqrt())
                        for p, o, s in zip(spec.paths, spec.offsets,
                                           spec.sizes)}
            if it.kind:
                self.iterations.append(it)
            if reduces == t["check_reduces"]:
                break
        else:
            raise RuntimeError(f"{t['check_reduces']} reduce steps not "
                               f"reached in {MAX_SETUP_ITERATIONS} iterations")
        self._recording = False
        self.phases["check_iterations"] = time.perf_counter() - clock
        p0 = weights.make(self.cfg, self.seed, self.device)
        self.prog.change_norms = ref.change_norms(
            flat_tree(loop.reducer.params), p0)
        del p0
        self.spans.clear()

    def _begin(self) -> None:
        self._current = ref_fleet.Iteration(kind="")
        self._worker = None

    def _wrap(self) -> None:
        """Record each iteration's replies, rows and late set while
        ``_recording``; in a trace run, time the map and the reduce."""
        cluster, reducer = self.cluster, self.loop.reducer
        compute, grad_fn = cluster.compute, cluster.grad_fn
        reduce, defer = reducer.reduce_and_step, reducer.defer_to_residual

        def rec_compute(worker, *a, **kw):
            self._worker = worker
            return compute(worker, *a, **kw)

        def rec_grad_fn(params, Xb, yb):
            if self._recording:
                self._current.rows[self._worker] = (Xb.clone(), yb.clone())
            return grad_fn(params, Xb, yb)

        def rec_reduce(messages, keep=None, defer=None):
            if self._recording:
                it = self._current
                it.kind = "reduce"
                it.late = frozenset(defer or ())
                it.rows = {w: it.rows[w] for w in messages}
            return reduce(messages, keep=keep, defer=defer)

        def rec_defer(worker, grad):
            if self._recording:
                self._current.kind = "defer"
            return defer(worker, grad)

        cluster.compute = rec_compute
        cluster.grad_fn = rec_grad_fn
        reducer.reduce_and_step = rec_reduce
        reducer.defer_to_residual = rec_defer
        if self.trace:
            cluster.compute = self.spans.host("fleet.map", cluster.compute)
            reducer.reduce_and_step = self.spans.device(
                "fleet.reduce", reducer.reduce_and_step)

    def step(self) -> Step:
        log = self.loop.iteration()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tokens = float(log.vectors * self.t["seq"])
        return Step(tokens=tokens,
                    failed=tokens > 0 and not log.loss == log.loss)

    def release(self) -> None:
        self.loop = self.cluster = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, mode: str = "f32", drop_half: bool = False):
        t = self.t
        return self.prog, ref_fleet.follow_fleet(
            self.cfg, self.seed, self.device, self.iterations, lr=t["lr"],
            eps=t["eps"], frac=t["frac"], mode=mode, drop_half=drop_half)

