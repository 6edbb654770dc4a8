#!/usr/bin/env python3
"""Where a decode step's time goes for the MoE, hybrid, VLM and audio
families, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_families.py \
        [--archs llama4-scout-17b-a16e zamba2-7b paligemma-3b \
         whisper-large-v3]

``llama4-scout-17b-a16e`` at full width with 4 of its 48 layers (bf16)
serves ``chip_smoke.py``'s ``[moe]`` schedule (32 requests sized to 256
positions, seed 1) through the paged engine with flash decode, once to
warm up and once under ``torch.profiler``; ``zamba2-7b``,
``paligemma-3b`` and ``whisper-large-v3`` at full width and depth (bf16)
run ``launch.serve``'s single-shot batch (4 x 24 prompts with the
launcher's patch or frame embeddings, 12 tokens) the same way, the
prefill profiled apart from the lockstep steps. For each, it prints the
host and device time per decode step (device = the sum of the kernels'
time), the device's busy share of the wall time, and the ops with the
most device time per step, each as a ``[prof]`` line, with the card's
name and power limit. With no ``--archs``, the first two.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.serve import ONESHOT_GEN, oneshot_inputs
from repro_torch.models import transformer as tf
from repro_torch.serving import (PagingConfig, ServingConfig, ServingEngine,
                                 generate_requests)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def report(tag: str, prof, wall: float, steps: int, rows: int,
           name: str) -> None:
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    print(f"[prof] {tag}: wall {1e3 * wall / steps:.2f} ms a step over "
          f"{steps} steps, device {1e3 * busy / steps:.2f} ms a step, busy "
          f"{100 * busy / wall:.1f}% | {name}")
    ops = sorted((e for e in ka
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:rows]:
        print(f"[prof] {tag}:   {e.key[:48]:<48} "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms a step "
              f"({100 * e.self_device_time_total / 1e6 / busy:5.1f}%), "
              f"{e.count / steps:.1f} calls")


def moe(rows: int, name: str) -> None:
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=4)
    params = tf.init_params(cfg, seed=0, device="cuda")
    max_seq = 256
    reqs = generate_requests(
        32, rate_rps=60.0, vocab_size=cfg.vocab_size, prompt_rng=(4, 32),
        gen_short=(1, 12), gen_long=(64, 128), seed=1)

    def engine():
        return ServingEngine(params, cfg, serving=ServingConfig(
            max_batch=16, max_seq=max_seq, decode_kernel="flash",
            paging=PagingConfig(page_size=16)), device="cuda")
    engine().run_closed_loop(reqs)
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run_closed_loop(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("llama4-scout-17b-a16e 4 layers, paged engine, whole run "
           "(prefill included) per decode step", prof, wall,
           st.decode_dispatches, rows, name)


def oneshot(arch: str, rows: int, name: str) -> None:
    """``serve_batch``'s prefill, then its lockstep decode steps, each
    profiled on its own (after a warm-up run of both)."""
    cfg = get_config(arch)
    params = tf.init_params(cfg, seed=0, device="cuda")
    dev = params["embed"].device
    prompts, kw = oneshot_inputs(cfg, 0)
    prompts = torch.tensor(prompts, device=dev)
    kw = {k: torch.tensor(v, device=dev) for k, v in kw.items()}
    P = prompts.shape[1] + (cfg.n_prefix_tokens if cfg.arch_type == "vlm"
                            else 0)

    def prefill():
        logits, cache = tf.prefill(params, cfg, prompts, **kw)
        return logits[:, -1].argmax(-1)[:, None].to(torch.int32), cache

    def decode(tok, cache):
        for t in range(ONESHOT_GEN - 1):
            logits, cache = tf.decode_step(params, cfg, tok, P + t, cache)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        return tok

    with torch.inference_mode():
        decode(*prefill())
        torch.cuda.synchronize()
        for tag, steps in (("prefill", 1), ("decode", ONESHOT_GEN - 1)):
            if tag == "decode":
                tok, cache = prefill()
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = prefill()[0] if tag == "prefill" else decode(tok,
                                                                   cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            assert np.asarray(out.cpu()).shape == (4, 1)
            report(f"{arch} single-shot batch, "
                   + ("the prefill" if tag == "prefill"
                      else "per lockstep step"), prof, wall, steps, rows,
                   name)


ARCHS = ("llama4-scout-17b-a16e", "zamba2-7b", "paligemma-3b",
         "whisper-large-v3")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=12)
    ap.add_argument("--archs", nargs="+", default=list(ARCHS[:2]),
                    choices=ARCHS)
    args = ap.parse_args()
    name = card()
    for arch in args.archs:
        if arch == ARCHS[0]:
            moe(args.rows, name)
        else:
            oneshot(arch, args.rows, name)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
