"""The mesh engine: ``ElasticMeshSGD`` over ``build_train_step``, the
production path of ``python -m repro_torch.launch.train``.

Traffic keys: ``batch`` x ``seq`` tokens a step from ``n_tokens`` of
``traffic.synthetic_lm``, ``n_workers`` virtual workers (row slices, all
live), ``optimizer`` / ``lr`` / ``eps``, ``remat``, and ``check_steps``:
the first steps, run in set-up through ``ElasticMeshSGD.step`` on the
stream's first batches, which the reference follows.

The check compares each check step's loss, each leaf's norm of the first
gradient as AdaGrad received it (the square root of its accumulator
after one step, which starts at 0), and each leaf's norm of the
parameters' change after the check steps.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from perfbench import traffic, weights
from perfbench.drivers import Spans, Step, flat_tree, program_config
from perfbench.flops import train_flops_per_token
from perfbench.reference import train as ref
from perfbench.reference.train import Trace


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
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.prog = Trace()
        self.phases = {}

    # ------------------------------------------------------------------
    def _optimizer(self):
        from repro_torch.optim import get_optimizer

        opt = get_optimizer(self.t["optimizer"], lr=self.t["lr"],
                            eps=self.t["eps"])
        if not self.trace:
            return opt
        return dataclasses.replace(
            opt, update=self.spans.device("optimizer", opt.update))

    def setup(self) -> None:
        from repro_torch.core.mesh_engine import ElasticMeshSGD
        from repro_torch.train import step as step_mod

        t = self.t
        clock = time.perf_counter()
        opt = self._optimizer()
        state = step_mod.make_train_state(
            weights.nest(weights.make(self.cfg, self.seed, self.device)), opt)
        self.engine = ElasticMeshSGD(
            train_step=step_mod.build_train_step(
                program_config(self.cfg), opt, remat=t["remat"]),
            state=state, n_workers=t["n_workers"], global_batch=t["batch"])
        del state
        self.stream = traffic.lm_batches(self.cfg["vocab_size"], t["batch"],
                                         t["seq"], t["n_tokens"], self.seed)
        self.phases["build"] = time.perf_counter() - clock
        clock = time.perf_counter()
        for i in range(t["check_steps"]):
            b = next(self.stream)
            self.batches.append(b)
            m = self.engine.step(b)
            self.prog.losses.append(m["loss"])
            if i == 0:
                acc = flat_tree(self.engine.state["opt"]["accum"])
                self.prog.grad_norms = {
                    k: float(v.double().sum().sqrt())
                    for k, v in acc.items()}
                del acc
        self.phases["check_steps"] = time.perf_counter() - clock
        p0 = weights.make(self.cfg, self.seed, self.device)
        self.prog.change_norms = ref.change_norms(
            flat_tree(self.engine.state["params"]), p0)
        del p0
        self.spans.clear()

    def step(self) -> Step:
        m = self.engine.step(next(self.stream))
        return Step(tokens=m["tokens"], failed=not m["loss"] == m["loss"])

    def release(self) -> None:
        self.engine = None
        self.stream = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, mode: str = "f32", drop_half: bool = False):
        """The reference follows the check steps one worker's rows at a
        time."""
        t = self.t
        return self.prog, ref.follow_mesh(
            self.cfg, self.seed, self.device, self.batches, lr=t["lr"],
            eps=t["eps"], rows=t["batch"] // t["n_workers"], mode=mode,
            drop_half=drop_half)
