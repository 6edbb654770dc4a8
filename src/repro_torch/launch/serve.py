"""Serving launcher: continuous-batching inference on the card.

The PyTorch counterpart of ``repro.launch.serve``: a seeded open-loop
request schedule (Poisson arrivals, mixed prompt/generation lengths)
streams through ``repro_torch.serving.ServingEngine`` and the run prints
throughput, latency and the engine's counters. Weights are random, drawn
from ``--seed``.

  python -m repro_torch.launch.serve --arch mlitb-lm-100m --page-size 16
  python -m repro_torch.launch.serve --arch mamba2-780m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mlitb-lm-100m \\
      --reduced --requests 8 --max-batch 4 --max-seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-scout-17b-a16e --reduced --device cpu

The default ``--arch`` is ``qwen3-4b``, as the reference's. Dense and MoE
archs stream through the engine; SSM and hybrid archs (``mamba2-780m``,
``zamba2-7b``) have no slot-cache engine and serve one reference batch
through ``serve_batch`` (4 x 24 random prompts, 12 tokens each).

``--page-size`` switches the KV cache to the paged pool with prefix
reuse; ``--shared-prefix N`` generates the matching system-prompt-heavy
workload. ``--decode-kernel flash`` (the default) runs decode attention
in the hand-written CUDA kernel; ``plain`` in PyTorch. ``--temperature``
/ ``--top-k`` sample instead of taking the argmax. ``--simulate`` times
the run on the discrete-event ``ServeCostModel`` clock (the model's
seconds, not the card's) instead of the wall clock, and ``--swap-every
S`` then hot-swaps the params in as a new version every S simulated
seconds (the same tree: it exercises in-flight version pinning, and the
histogram shows which version each request was served under).
``--speculative K`` drafts K tokens a round with a 1-layer sibling of
the served model (random, from ``--seed + 2``) and checks them in one
verify dispatch; the stream stays the exact greedy one, and no
flash-decode kernel runs. ``--closure PATH`` serves the weights of a
research closure (written by either package) instead of random ones.

``serve_batch`` is the single-shot reference path: one fixed batch,
prefilled once and decoded in lockstep, on the device its params lie on.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B,S,V) logits -> (B,1) int32 argmax of the last column."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


def serve_batch(params, cfg: ArchConfig, prompts, gen: int, *,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
    """REFERENCE single-shot path: one fixed-shape batch, every row the
    same prompt length, prefilled once and decoded in lockstep for
    ``gen`` steps. prompts: (B, P) int (array, or tensor on any device)
    -> generated (B, gen) int32, on the device the params lie on
    (``device``, when given, must name it; ``"cuda"`` raises without
    CUDA)."""
    dev = resolve_device(params["embed"].device if device is None
                         else device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, "
                         f"serve_batch was asked for {dev}")
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    P = prompts.shape[1]
    with torch.inference_mode():
        logits, cache = tf.prefill(params, cfg, prompts)
        tok = greedy_sample(logits)
        out = [tok]
        for t in range(gen - 1):
            logits, cache = tf.decode_step(params, cfg, tok, P + t, cache)
            tok = greedy_sample(logits)
            out.append(tok)
    return torch.cat(out, dim=1)


ONESHOT_BATCH, ONESHOT_PROMPT, ONESHOT_GEN = 4, 24, 12


def oneshot_prompts(cfg: ArchConfig, seed: int) -> np.ndarray:
    """``_serve_oneshot``'s prompts: (4, 24) int32 from
    ``np.random.RandomState(seed + 1)`` (the reference draws them with
    ``jax.random``, whose numbers no other library reproduces)."""
    return np.random.RandomState(seed + 1).randint(
        0, cfg.vocab_size, (ONESHOT_BATCH, ONESHOT_PROMPT)).astype(np.int32)


def _serve_oneshot(params, cfg: ArchConfig, args) -> torch.Tensor:
    """The families without an engine (SSM, hybrid): one reference batch
    of 4 x 24 random prompts through ``serve_batch``, 12 tokens each;
    prints the run and returns the tokens (4, 12) on the CPU."""
    import time

    prompts = oneshot_prompts(cfg, args.seed)
    t0 = time.time()
    out = serve_batch(params, cfg, prompts, ONESHOT_GEN)
    out = out.cpu()
    dt = time.time() - t0
    print(f"arch={cfg.name} [{cfg.arch_type}] one-shot reference path "
          f"(no continuous-batching engine for this family yet)")
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({out.numel() / dt:.1f} tok/s incl. warm-up)")
    print("sample:", out[0][:12].numpy())
    return out


def main(argv=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.core.simulation import ServeCostModel
    from repro_torch.serving import (PagingConfig, SamplingConfig,
                                     ServingConfig, ServingEngine,
                                     SpeculativeConfig, generate_requests)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--closure", default=None, metavar="PATH",
                    help="serve the params of this research closure")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=60.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--prompt-cap", type=int, default=None,
                    help="largest prefill bucket; longer prompts prefill "
                         "in chunks (default: max_seq, no chunking)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples with per-request draws")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help=">0 enables the PAGED KV cache with cross-request "
                         "prefix reuse; must divide max_seq. 0 = dense "
                         "slot cache")
    ap.add_argument("--pages", type=int, default=0,
                    help="with --page-size: pool size in pages (default "
                         "max_batch * max_seq / page_size)")
    ap.add_argument("--no-prefix-reuse", action="store_true",
                    help="with --page-size: disable the prefix trie")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one of 3 fixed system prompts of this "
                         "many tokens to ~70%% of requests")
    ap.add_argument("--decode-kernel", choices=("flash", "plain"),
                    default="flash",
                    help="decode attention: 'flash' = the CUDA flash-decode "
                         "kernel (its plain version on the CPU), 'plain' = "
                         "masked softmax in PyTorch")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help=">0 enables speculative decoding: a 1-layer "
                         "draft drafts K tokens per round and the served "
                         "model verifies them in one chunk dispatch "
                         "(greedy only)")
    ap.add_argument("--draft-window", type=int, default=32,
                    help="with --speculative: the draft LM's cacheless "
                         "context window")
    ap.add_argument("--simulate", action="store_true",
                    help="discrete-event clock instead of wall-clock")
    ap.add_argument("--swap-every", type=float, default=0.0,
                    help="with --simulate: hot-swap the params in as a "
                         "new version every S simulated seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--trace", action="store_true",
                    help="serve the schedule a second time under "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.closure:
        from repro_torch.checkpoint.convert import params_from_jax
        from repro_torch.core.closure import ResearchClosure
        clo = ResearchClosure.load(args.closure)
        cfg = clo.config
        params = params_from_jax(clo.params, cfg, device=device)
        print(f"loaded closure {args.closure} (arch={clo.arch}, "
              f"step={clo.step})")
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        params = init_params(cfg, seed=args.seed, device=device)

    if cfg.arch_type not in ("dense", "moe"):
        # ssm / hybrid: no slot-cache engine; serve one reference batch
        # through serve_batch (vlm / audio raise there: not ported)
        _serve_oneshot(params, cfg, args)
        return 0

    max_seq = args.max_seq
    if cfg.sliding_window:
        max_seq = min(max_seq, cfg.sliding_window)
    # size the workload so every draw fits prompt + max_new <= max_seq
    g_long_hi = max(2, max_seq // 2)
    g_long_lo = max(1, max_seq // 4)
    p_hi = max(1, min(max(8, max_seq // 8), max_seq - g_long_hi))
    shared = None
    if args.shared_prefix > 0:
        g_long_hi = min(g_long_hi, max(1, (max_seq - args.shared_prefix
                                           - p_hi) // 2))
        g_long_lo = min(g_long_lo, g_long_hi)
        shared = (3, args.shared_prefix, 0.7)
    reqs = generate_requests(
        args.requests, rate_rps=args.rate, vocab_size=cfg.vocab_size,
        prompt_rng=(min(4, p_hi), p_hi),
        gen_short=(1, min(12, g_long_lo)),
        gen_long=(g_long_lo, g_long_hi),
        shared_prefix=shared,
        seed=args.seed + 1)
    speculative = None
    if args.speculative > 0:
        # a 1-layer sibling of the served model, freshly drawn: draft
        # quality moves only the acceptance rate, never the stream
        draft_cfg = dataclasses.replace(cfg, name=cfg.name + "-draft",
                                        n_layers=1)
        speculative = SpeculativeConfig(
            draft_params=init_params(draft_cfg, seed=args.seed + 2,
                                     device=device),
            draft_cfg=draft_cfg, k=args.speculative,
            window=args.draft_window)
    paging = None
    if args.page_size:
        paging = PagingConfig(page_size=args.page_size,
                              n_pages=args.pages or None,
                              prefix_reuse=not args.no_prefix_reuse)
    engine = ServingEngine(params, cfg, serving=ServingConfig(
        max_batch=args.max_batch, max_seq=max_seq,
        prompt_cap=args.prompt_cap, decode_kernel=args.decode_kernel,
        sampling=SamplingConfig(temperature=args.temperature,
                                top_k=args.top_k, sample_seed=args.seed),
        paging=paging, speculative=speculative), device=device)
    if args.simulate:
        swaps = []
        if args.swap_every > 0:
            horizon = max(r.arrival for r in reqs) + 4.0
            t, ver = args.swap_every, 1
            while t < horizon:
                swaps.append((t, params, ver))
                t += args.swap_every
                ver += 1
        stats = engine.run_simulated(reqs, ServeCostModel(), swaps=swaps)
        mode = "simulated"
    else:
        stats = engine.run_closed_loop(reqs)
        mode = "wall-clock"
    print(f"arch={cfg.name} requests={stats.n_requests} "
          f"max_batch={args.max_batch} max_seq={max_seq} device={device}")
    print(f"{mode}: {stats.gen_tokens} tokens in {stats.makespan:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s), p50={stats.p50_latency:.3f}s "
          f"p95={stats.p95_latency:.3f}s")
    print(f"engine: {stats.engine_steps} steps, "
          f"{stats.decode_rows_live}/{stats.decode_rows_total} live decode "
          f"rows, prefill buckets {engine.buckets_seen}, peak concurrency "
          f"{stats.concurrency_peak}")
    if engine.paged:
        print(f"paged: {engine.n_pages} pages x {engine.page_size} tok, "
              f"peak resident {stats.pages_peak}, prefix hits "
              f"{stats.prefix_hits} ({stats.reused_tokens} tokens never "
              f"re-prefilled), {engine.trie_pages} pages cached for reuse")
    if engine.decode_kernel == "flash" and not engine.paged \
            and speculative is None:
        print(f"flash decode: {stats.decode_kv_tokens} live KV tokens "
              f"streamed (vs {stats.decode_rows_total * max_seq} dense)")
    if speculative is not None:
        rate = stats.accepted / max(stats.drafted, 1)
        print(f"speculative: drafted {stats.drafted}, accepted "
              f"{stats.accepted} ({100 * rate:.0f}%) over "
              f"{stats.spec_rounds} rounds, verify buckets "
              f"{engine.verify_buckets_seen}")
    if args.simulate:
        from repro_torch.launch.train_serve import format_version_histogram
        print(f"served version histogram ({stats.swap_count} in-flight "
              f"swaps applied):")
        for line in format_version_histogram(stats):
            print(line)
    first = min(stats.completions, key=lambda c: c.rid)
    print("sample:", first.tokens[:12])
    if args.trace:
        print_trace(engine, reqs, device)
    return 0


def print_trace(engine, reqs, device) -> None:
    """Serve ``reqs`` again (warm) under ``torch.profiler``; print the
    ops with the most self time on the device (or the CPU, without a
    card), the ops with the most host time, the speculative round's
    ``spec.draft`` / ``spec.verify`` spans, and the device's busy share
    of the wall time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stats = engine.run_closed_loop(reqs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    key = "self_device_time_total" if device.type == "cuda" \
        else "self_cpu_time_total"
    print(ka.table(sort_by=key, row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=10))
    for e in ka:
        if e.key.startswith("spec.") \
                and e.device_type == torch.autograd.DeviceType.CPU:
            print(f"span {e.key}: {e.count} calls, host "
                  f"{e.cpu_time_total / 1e3 / e.count:.2f} ms a call, "
                  f"device {e.device_time_total / 1e3 / e.count:.2f} ms a "
                  f"call (its kernels)")
    # device busy time: the device-side (kernel / memcpy) events only;
    # the aten ops that launched them carry the same time again
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type != torch.autograd.DeviceType.CPU
                  and not getattr(e, "is_user_annotation", False))
    steps = max(stats.decode_dispatches, 1)
    print(f"trace: wall {wall:.3f}s for {stats.engine_steps} steps "
          f"({stats.decode_dispatches} decode); device busy "
          f"{busy_us / 1e6:.3f}s ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{busy_us / 1e3 / steps:.2f} ms device time per decode step")


if __name__ == "__main__":
    main()
