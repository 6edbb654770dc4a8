"""Serving launcher: continuous-batching inference on the card.

The PyTorch counterpart of ``repro.launch.serve``: a seeded open-loop
request schedule (Poisson arrivals, mixed prompt/generation lengths)
streams through ``repro_torch.serving.ServingEngine`` and the run prints
throughput, latency and the engine's counters. Weights are random, drawn
from ``--seed``.

  python -m repro_torch.launch.serve --arch mlitb-lm-100m --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mlitb-lm-100m \\
      --reduced --requests 8 --max-batch 4 --max-seq 64 --device cpu

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
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import get_config
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.core.simulation import ServeCostModel
    from repro_torch.serving import (PagingConfig, SamplingConfig,
                                     ServingConfig, ServingEngine,
                                     generate_requests)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mlitb-lm-100m")
    ap.add_argument("--reduced", action="store_true")
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
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=device)

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
        paging=paging), device=device)
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
    if engine.decode_kernel == "flash" and not engine.paged:
        print(f"flash decode: {stats.decode_kv_tokens} live KV tokens "
              f"streamed (vs {stats.decode_rows_total * max_seq} dense)")
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
    card) and the device's busy share of the wall time."""
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
    # device busy time: the device-side (kernel / memcpy) events only;
    # the aten ops that launched them carry the same time again
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type != torch.autograd.DeviceType.CPU)
    steps = max(stats.decode_dispatches, 1)
    print(f"trace: wall {wall:.3f}s for {stats.engine_steps} steps "
          f"({stats.decode_dispatches} decode); device busy "
          f"{busy_us / 1e6:.3f}s ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{busy_us / 1e3 / steps:.2f} ms device time per decode step")


if __name__ == "__main__":
    main()
