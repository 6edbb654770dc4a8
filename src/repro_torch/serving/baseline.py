"""One-batch-at-a-time baseline on the simulated clock (port of
``repro.serving.baseline``).

The one-shot policy serves exactly one fixed-shape batch: it waits until
``batch_size`` requests have arrived, pads every prompt to the longest in
the batch, and decodes EVERY row for the longest generation in the batch
— short requests pay for the batch's tail, and nobody new boards until
the whole batch lands. ``simulate_static_batches`` charges that policy on
the same ``ServeCostModel`` clock as the engine, so the two compare on
identical workloads. It computes no tokens: only time.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from repro_torch.serving.engine import Completion, ServeRequest, ServeStats


def simulate_static_batches(requests: Sequence[ServeRequest],
                            batch_size: int, cost: Any) -> ServeStats:
    """Group requests into arrival-order batches of ``batch_size`` and
    charge each batch prefill(b, P_max) + (G_max - 1) decode steps of b
    rows (the first token comes from the prefill logits). Every request
    in a batch completes when the batch's LAST token lands."""
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    clock = 0.0
    out: List[Completion] = []
    steps = 0
    prefill_tokens = 0
    decode_rows_live = 0
    decode_rows_total = 0
    for start in range(0, len(reqs), batch_size):
        batch = reqs[start:start + batch_size]
        b = len(batch)
        p_max = max(len(r.prompt) for r in batch)
        g_max = max(r.max_new for r in batch)
        # the batch can only launch once its last member has arrived
        clock = max(clock, max(r.arrival for r in batch))
        clock += cost.prefill_time(b, p_max)
        prefill_tokens += b * p_max
        clock += (g_max - 1) * cost.decode_time(b)
        steps += g_max
        decode_rows_total += (g_max - 1) * b
        # rows stay allocated for the full g_max even after their own
        # generation finished — the utilization gap the engine closes
        decode_rows_live += sum(r.max_new - 1 for r in batch)
        for r in batch:
            out.append(Completion(
                rid=r.rid, prompt_len=len(r.prompt),
                tokens=np.zeros(r.max_new, np.int32),   # timing-only arm
                finish=clock,
                latency=clock - r.arrival + 2.0 * r.client_latency))
    lats = [c.latency for c in out]
    gen = sum(int(c.tokens.size) for c in out)
    return ServeStats(
        n_requests=len(out), gen_tokens=gen, makespan=clock,
        tokens_per_s=gen / clock if clock > 0 else float("inf"),
        p50_latency=float(np.percentile(lats, 50)) if lats else 0.0,
        p95_latency=float(np.percentile(lats, 95)) if lats else 0.0,
        engine_steps=steps, prefill_tokens=prefill_tokens,
        decode_rows_live=decode_rows_live,
        decode_rows_total=decode_rows_total, completions=out)
