#!/usr/bin/env python3
"""Check and time the training attention's kernels on one CUDA card.

    PYTHONPATH=src python3 scripts/time_attn_train.py [--label NAME]
        [--quick]

For each case (the LM's training shape, 16 x 1024 tokens at 12 / 4 heads
of 64, causal; the fleet's 16-token rows; a sliding window; a non-causal
ragged one with G = 1; a window without the causal mask):

- the fused function (``kernels/flash_attention/train.py``) forward and
  backward against a float64 softmax, beside the plain path it replaces
  (autograd through ``grouped_attend`` in float32, TF32 off): each of O,
  dQ, dK, dV as max |x - exact| over max |exact|, held to 2e-5 (the
  float32 tolerance the kernel API holds the forward to);
- the same seed run twice: every output bit-equal;
- device µs a call of the forward kernel and of the backward's two
  kernels (CUDA events over repeated launches), the plain path's forward
  and backward, ``torch.nn.functional.scaled_dot_product_attention``'s
  forward and backward as the library yardstick (timed only; the port
  never calls it), and the least time the card could take: the valid
  (query, key) pairs' 4 D flops forward and 10 D backward (five products)
  at 165 TFLOP/s (3xTF32), or the bytes at 3.35 TB/s where larger;
- at the fleet's shape, the host's µs a call (forward and backward
  queued without waiting) of the fused function and of the plain path.

Then the counters over one training step of the LM at full width (16 x
1024 tokens, forward, loss, backward). Prints one ``[attn-train]`` line
per result and writes them to ``chiprun_out/time_attn_train_<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import train as ft
from repro_torch.models import attention as attn

# max |x - exact| over max |exact| for O and each gradient: the float32
# tolerance the kernel API holds the forward to (``chip_smoke.TOL``)
REL_TOL = 2e-5
PEAK_3XTF32 = 495e12 / 3
HBM = 3.35e12
# (B, S, H, K, D, causal, window)
CASES = {
    "lm": (16, 1024, 12, 4, 64, True, 0),
    "fleet": (64, 16, 12, 4, 64, True, 0),
    "window": (4, 1024, 12, 4, 64, True, 256),
    "nomask-ragged": (2, 1000, 8, 8, 64, False, 0),
    "window-only": (2, 300, 6, 2, 64, False, 40),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def inputs(case: str, seed: int = 0):
    B, S, H, K, D, causal, window = CASES[case]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return (randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, D),
            randn(B, S, H, D), causal, window)


def mask(S: int, causal: bool, window: int, device):
    """The (S, S) bool mask of valid (query, key) pairs, or None."""
    if not causal and not window:
        return None
    pos = torch.arange(S, device=device)
    return attn.make_mask(pos, pos, causal, window)[0, 0]


def exact64(q, k, v, causal, window):
    """Float64 softmax attention (the yardstick of both paths)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, D),
                     k) * D ** -0.5
    m = mask(S, causal, window, q.device)
    if m is not None:
        s = s.masked_fill(~m, float("-inf"))
    return torch.einsum("bkgst,btkd->bskgd", torch.softmax(s, -1),
                        v).reshape(B, S, H, D)


def plain(q, k, v, causal, window):
    pos = torch.arange(q.shape[1], device=q.device)
    m = attn.make_mask(pos, pos, causal, window) \
        if causal or window else None
    return attn.grouped_attend(q, k, v, m)


def fused(q, k, v, causal, window):
    return ft.attention_train(q, k, v, causal=causal, window=window)


def run(fn, q, k, v, do, causal, window, dtype=None):
    """(O, dQ, dK, dV) of ``fn`` by autograd."""
    leaves = [(t.to(dtype) if dtype else t).detach().requires_grad_(True)
              for t in (q, k, v)]
    o = fn(*leaves, causal, window)
    grads = torch.autograd.grad(o, leaves, do.to(o.dtype))
    return (o.detach(),) + grads


def rel_err(x: torch.Tensor, exact: torch.Tensor) -> float:
    return float((x.double() - exact).abs().max()
                 / exact.abs().max().clamp_min(1e-300))


def valid_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per (batch row, head)."""
    n = 0
    for s in range(S):
        lo = s - window + 1 if window else 0
        hi = s if causal else S - 1
        n += max(0, hi - max(lo, 0) + 1)
    return n


def bound_us(case: str) -> dict:
    B, S, H, K, D, causal, window = CASES[case]
    pairs = B * H * valid_pairs(S, causal, window)
    f_flops, b_flops = 4 * D * pairs, 10 * D * pairs
    q_bytes, kv_bytes, row_bytes = 4 * B * S * H * D, 4 * B * S * K * D, \
        4 * B * H * S
    f_bytes = 2 * q_bytes + 2 * kv_bytes + row_bytes      # q,k,v -> o, L
    b_bytes = 4 * q_bytes + 4 * kv_bytes + row_bytes      # + o, dO, L -> d*
    out = {}
    for name, fl, by in (("forward", f_flops, f_bytes),
                         ("backward", b_flops, b_bytes)):
        ops_us, bytes_us = fl / PEAK_3XTF32 * 1e6, by / HBM * 1e6
        out[name] = {"bound_us": max(ops_us, bytes_us),
                     "bound_by": "operations" if ops_us >= bytes_us
                     else "bytes", "flops": fl}
    return out


def device_us(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / iters


def kernel_us(fn, iters: int = 5) -> dict:
    """Device µs a call of each kernel ``fn`` launches (the profiler's
    CUDA time by kernel name); empty where the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0)
        at = e.key.find("flash_attention")
        if us and at >= 0:
            out[e.key[at:].split("<")[0]] = us / iters
    return out


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call, queued without waiting (then one synchronise)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def check_case(case: str) -> dict:
    q, k, v, do, causal, window = inputs(case)
    exact = run(exact64, q, k, v, do, causal, window, torch.float64)
    got = run(fused, q, k, v, do, causal, window)
    again = run(fused, q, k, v, do, causal, window)
    base = run(plain, q, k, v, do, causal, window)
    torch.cuda.synchronize()
    row = {"case": case, "shape": CASES[case]}
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, base, exact):
        row[name] = {"rel_err": rel_err(a, c), "plain_rel_err": rel_err(b, c)}
    row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[attn-train] {case} {CASES[case]}: rel err "
          + ", ".join(f"{n} {row[n]['rel_err']:.2e} (plain "
                      f"{row[n]['plain_rel_err']:.2e})"
                      for n in ("o", "dq", "dk", "dv"))
          + f"; two runs bit-equal: {row['bit_equal']}", flush=True)
    bad = [n for n in ("o", "dq", "dk", "dv")
           if not row[n]["rel_err"] <= REL_TOL]
    if bad or not row["bit_equal"]:
        raise SystemExit(f"[attn-train] {case}: {bad} over {REL_TOL} or "
                         f"two runs differ")
    return row


def time_case(case: str, iters: int) -> dict:
    q, k, v, do, causal, window = inputs(case)
    qq, kk, vv, o, lse = ft._forward_kernel(q, k, v, causal, window)
    fwd = device_us(lambda: ft._forward_kernel(q, k, v, causal, window),
                    iters)
    bwd = device_us(lambda: ft._backward_kernel(qq, kk, vv, o, do, lse,
                                                causal, window), iters)
    plain_us = device_us(lambda: run(plain, q, k, v, do, causal, window),
                         max(2, iters // 4))
    B, S, H, K, D, _, _ = CASES[case]
    qs, ks, vs, dos = (t.transpose(1, 2) for t in (q, k, v, do))
    m = mask(S, causal, window, q.device)

    def sdpa():
        leaves = [t.detach().requires_grad_(True) for t in (qs, ks, vs)]
        out = F.scaled_dot_product_attention(
            *leaves, attn_mask=None if causal and not window else m,
            is_causal=causal and not window, enable_gqa=True)
        torch.autograd.grad(out, leaves, dos)
    try:
        lib_us = device_us(sdpa, max(2, iters // 4))
    except (RuntimeError, TypeError) as e:       # no kernel for the case
        print(f"[attn-train] {case}: SDPA failed: {e}", flush=True)
        lib_us = None
    b = bound_us(case)
    row = {"case": case, "forward_us": fwd, "backward_us": bwd,
           "plain_us": plain_us, "library_us": lib_us,
           "kernels_us": kernel_us(lambda: ft._backward_kernel(
               qq, kk, vv, o, do, lse, causal, window)), **b}
    print(f"[attn-train] {case} timing: forward {fwd:.1f} us (bound "
          f"{b['forward']['bound_us']:.1f}, {b['forward']['bound_by']}), "
          f"backward {bwd:.1f} us (bound {b['backward']['bound_us']:.1f}, "
          f"{b['backward']['bound_by']}); fused {fwd + bwd:.1f} us against "
          f"plain {plain_us:.1f} us and SDPA "
          + (f"{lib_us:.1f}" if lib_us is not None else "-")
          + " us (forward + backward); backward kernels "
          + ", ".join(f"{k} {v:.1f}" for k, v in row["kernels_us"].items()),
          flush=True)
    return row


def host_cost() -> dict:
    """Host µs a forward + backward call at the fleet's shape."""
    q, k, v, do, causal, window = inputs("fleet")
    out = {}
    for name, fn in (("fused", fused), ("plain", plain)):
        out[name + "_host_us"] = host_us(
            lambda fn=fn: run(fn, q, k, v, do, causal, window))
    print(f"[attn-train] fleet host us a call (forward + backward): fused "
          f"{out['fused_host_us']:.1f}, plain {out['plain_host_us']:.1f}",
          flush=True)
    return out


def lm_step_counters() -> dict:
    """The counters over one training step of the LM at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("mlitb-lm-100m")
    params = tf.init_params(cfg, seed=0, device="cuda")
    leaves = [t.requires_grad_(True) for t in params.parameters()]
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (16, 1024), generator=g,
                           device="cuda")
    names = ("attention.fused_calls", "attention.plain_calls",
             "flash_attention", "flash_attention.backward")
    before = {n: runtime.COUNTERS[n].count for n in names}
    torch.cuda.reset_peak_memory_stats()
    logits, _ = tf.forward(params, cfg, tokens, remat=False)
    loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    out = {n: runtime.COUNTERS[n].count - before[n] for n in names}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[attn-train] one LM step (16 x 1024, full width): {out}",
          flush=True)
    want = {"attention.fused_calls": cfg.n_layers,
            "attention.plain_calls": 0, "flash_attention": cfg.n_layers,
            "flash_attention.backward": 2 * cfg.n_layers}
    if any(out[n] != w for n, w in want.items()):
        raise SystemExit(f"[attn-train] counters {out}, want {want}")
    del params, leaves, logits
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="run")
    ap.add_argument("--quick", action="store_true",
                    help="checks only, no timing")
    args = ap.parse_args()
    runtime.resolve_device("cuda")
    card = card_line()
    built = ft.library()
    regs = sorted({ln.strip().split("info    : ")[-1]
                   for ln in built.log.splitlines()
                   if "registers" in ln or "spill" in ln})
    print(f"[attn-train] {built.path.name}: nvcc {built.seconds:.2f} s | "
          + "; ".join(regs) + f" | {card}", flush=True)
    res = {"card": card, "build_s": built.seconds, "ptxas": built.log,
           "checks": []}
    bad = []
    for c in CASES:
        try:
            res["checks"].append(check_case(c))
        except SystemExit as e:
            bad.append(str(e))
    if not args.quick:
        res["timing"] = [time_case(c, 20 if c != "fleet" else 200)
                         for c in CASES]
        res["host"] = host_cost()
        res["lm_step"] = lm_step_counters()
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_attn_train_{args.label}.json").write_text(
        json.dumps(res, indent=1, default=str))
    if bad:
        raise SystemExit("; ".join(bad))
    print(f"[attn-train] done | {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
