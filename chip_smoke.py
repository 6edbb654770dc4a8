#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

1. device  — torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``), ``require_hopper()``;
2. build   — nvcc builds every kernel of the serving path from the sources
   in this checkout (into ``build/torch_ext/``);
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card, at the served model's shapes, with the stated tolerance;
   then its time per launch (CUDA events) beside the plain version's, a
   library yardstick's and the least time the card could take;
4. serve   — ``mlitb-lm-100m`` at full width (random weights from a
   seed) serves 32 requests through the paged continuous-batching engine
   with prefix reuse and the flash-decode kernel on the decode path; the
   launch counters prove the kernel ran; the same schedule served with
   the plain decode path must give the same token streams (a differing
   token passes only where the plain path's top-2 logit gap is below
   1e-4, and that request is then not compared further);
5. a ``{"kernels": [...]}`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. Imports ``torch``,
``numpy`` and ``repro_torch`` only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import _pow2_kv_block  # noqa: E402
from repro_torch.serving import (PagingConfig, ServingConfig,  # noqa: E402
                                 ServingEngine, generate_requests)

ARCH = "mlitb-lm-100m"
# the served engine: paged pool, 16-token pages, 16 slots of 512 tokens
MAX_BATCH, MAX_SEQ, PAGE = 16, 512, 16
N_REQUESTS = 32
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores — the kernel accumulates in f32 on the
# CUDA cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
GAP_TIE = 1e-4


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# flash-decode cases at the served shapes
# ---------------------------------------------------------------------------
def decode_case(gen: torch.Generator, *, B=MAX_BATCH, H=12, K=4, D=64,
                ps=PAGE, P=MAX_SEQ // PAGE, N=None, layers=1,
                dtype=torch.float32):
    """A paged pool of ``layers`` layers + page maps with distinct pages
    per row up to ``pos // ps`` and ``N`` (no page) past it."""
    N = N if N is not None else B * P
    q = torch.randn(layers, B, H, D, generator=gen)
    kp = torch.randn(layers, N, ps, K, D, generator=gen)
    vp = torch.randn(layers, N, ps, K, D, generator=gen)
    pos = torch.randint(0, P * ps, (B,), generator=gen, dtype=torch.int32)
    perm = torch.randperm(N, generator=gen)
    pm = torch.full((B, P), N, dtype=torch.int32)
    for b in range(B):
        used = int(pos[b]) // ps + 1
        pm[b, :used] = perm[b * P:b * P + used].to(torch.int32)
    live = torch.ones(B, dtype=torch.int32)
    dev = "cuda"
    return dict(q=q.to(dev, dtype), kpool=kp.to(dev, dtype),
                vpool=vp.to(dev, dtype), page_map=pm.to(dev),
                pos=pos.to(dev), live=live.to(dev))


def check(name: str, args: dict, dtype) -> float:
    out = fd_ops.flash_decode(**args)
    ref = flash_decode_ref(**args)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    if not np.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > "
                             f"{TOL[dtype]}")
    dead = args["live"] == 0
    if bool(dead.any()) and bool((out[dead] != 0).any()):
        raise AssertionError(f"{name}: dead rows are not exact zeros")
    print(f"[kernel] flash_decode {name}: max |kernel - plain| = {err:.3e} "
          f"(bound {TOL[dtype]:.0e})")
    return err


def phase_kernels(card: str) -> dict:
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # (a) the served shapes: B=16, H=12, K=4, D=64, ps=16, P=32, N=512
        a = decode_case(gen, dtype=dtype)
        one = {k: (v[0] if k in ("q", "kpool", "vpool") else v)
               for k, v in a.items()}
        e = check(f"served-shapes/{tag}", one, dtype)
        # (b) ragged pos incl. 0 and page edges, with dead rows
        b = dict(one)
        b["pos"] = torch.tensor([0, 15, 16, 17, 31, 255, 256, 511] * 2,
                                dtype=torch.int32, device="cuda")
        b["live"] = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1] * 2,
                                 dtype=torch.int32, device="cuda")
        pm = torch.full_like(one["page_map"], 512)
        for r in range(MAX_BATCH):
            used = int(b["pos"][r]) // PAGE + 1
            pm[r, :used] = torch.arange(r * 32, r * 32 + used,
                                        dtype=torch.int32)
        b["page_map"] = pm
        e = max(e, check(f"ragged+dead/{tag}", b, dtype))
        # (c) pages mapped >= N inside the live range, aliased tails, and
        #     a row with no page at all
        c = dict(one)
        pm = one["page_map"].clone()
        pm[0, 0] = 512
        pm[1, 1::2] = 700
        pm[2, :] = 512
        used3 = int(one["pos"][3]) // PAGE + 1
        if used3 < pm.shape[1]:
            pm[3, used3:] = 0          # tail points at real pages: masked
        c["page_map"] = pm
        e = max(e, check(f"oob-pages/{tag}", c, dtype))
        # (d) the dense slot cache through the identity page map
        T = MAX_SEQ
        ps = _pow2_kv_block(T)
        nb = T // ps
        d = dict(one)
        ck = torch.randn(MAX_BATCH, T, 4, 64, generator=gen).to("cuda", dtype)
        cv = torch.randn(MAX_BATCH, T, 4, 64, generator=gen).to("cuda", dtype)
        d["kpool"] = ck.view(MAX_BATCH * nb, ps, 4, 64)
        d["vpool"] = cv.view(MAX_BATCH * nb, ps, 4, 64)
        d["page_map"] = torch.arange(MAX_BATCH * nb, dtype=torch.int32,
                                     device="cuda").reshape(MAX_BATCH, nb)
        e = max(e, check(f"dense-identity(ps={ps})/{tag}", d, dtype))
        errs[tag] = e
    # timing: the served shapes over 12 layers' pools, as a decode step
    timing = time_flash_decode(decode_case(gen, layers=12), card)
    return {"max_abs_err": errs["f32"], "max_abs_err_bf16": errs["bf16"],
            **timing}


def time_flash_decode(case: dict, card: str) -> dict:
    """Kernel, plain version and SDPA on the served shapes, cycling over
    12 layers' pools (200 MB, well past the 50 MB L2) as a decode step
    does."""
    L = case["q"].shape[0]
    q, kp, vp = case["q"], case["kpool"], case["vpool"]
    pm, pos, live = case["page_map"], case["pos"], case["live"]
    B, H, D = q.shape[1:]
    N, ps, K, _ = kp.shape[1:]
    P = pm.shape[1]
    it = [0]

    def layer_args():
        i = it[0] % L
        it[0] += 1
        return q[i], kp[i], vp[i], pm, pos, live

    def kernel():
        fd_ops.flash_decode(*layer_args())

    def plain():
        flash_decode_ref(*layer_args())

    # library yardstick: SDPA over the already-gathered dense view (the
    # page gather is NOT timed), GQA, boolean mask of valid keys
    T = P * ps
    pmc = pm.long().clamp(0, N - 1)
    kd = kp[:, pmc].reshape(L, B, T, K, D).permute(0, 1, 3, 2, 4).contiguous()
    vd = vp[:, pmc].reshape(L, B, T, K, D).permute(0, 1, 3, 2, 4).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :] <= pos.long()[:, None])
    mask = mask[:, None, None, :]
    qd = q[:, :, :, None, :]                               # (L,B,H,1,D)

    def sdpa():
        i = it[0] % L
        it[0] += 1
        F.scaled_dot_product_attention(qd[i], kd[i], vd[i], attn_mask=mask,
                                       enable_gqa=True)

    ms = cuda_ms(kernel, 240)
    plain_ms = cuda_ms(plain, 48)
    library_ms = cuda_ms(sdpa, 240)
    ms2 = cuda_ms(kernel, 240)
    live_tok = int(((pos.long() + 1) * (live != 0)).sum())
    esize = q.element_size()
    nbytes = (2 * live_tok * K * D * esize          # live K and V
              + 2 * B * H * D * esize               # q in, out
              + pm.numel() * 4 + 2 * B * 4)         # page map, pos, live
    flops = 4 * live_tok * (H // K) * K * D         # QK^T and PV
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    res = {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "live_tokens": live_tok}
    print(f"[kernel] flash_decode timing (B={B} H={H} K={K} D={D} ps={ps} "
          f"P={P}, {live_tok} live tokens, f32): kernel "
          f"{res['ms'] * 1e3:.1f} us/launch ({ms * 1e3:.1f}, "
          f"{ms2 * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, SDPA "
          f"{library_ms * 1e3:.1f} us, bound {res['bound_ms'] * 1e3:.2f} us "
          f"({res['bound_by']}) | {card}")
    return res


# ---------------------------------------------------------------------------
# the slice at full width
# ---------------------------------------------------------------------------
def schedule(cfg):
    return generate_requests(
        N_REQUESTS, rate_rps=60.0, vocab_size=cfg.vocab_size,
        prompt_rng=(4, 64), gen_short=(1, 12), gen_long=(128, 192),
        shared_prefix=(3, 64, 0.7), seed=1)


def serve(params, cfg, reqs, kernel: str):
    eng = ServingEngine(params, cfg, serving=ServingConfig(
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, decode_kernel=kernel,
        paging=PagingConfig(page_size=PAGE, prefix_reuse=True)),
        device="cuda")
    step_s = []
    inner = eng._step_decode

    def timed(*a):
        t0 = time.perf_counter()
        inner(*a)                     # ends in a device-to-host copy
        step_s.append(time.perf_counter() - t0)
    eng._step_decode = timed
    return eng, eng.run_closed_loop(reqs), step_s


def top2_gap(params, cfg, seq) -> float:
    """The plain path's next-token logits after ``seq``, recomputed solo
    with one prefill chunk over a fresh dense row; top-2 gap."""
    shape = (cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    cache = {"layers": {n: torch.zeros(shape, device="cuda")
                        for n in ("k", "v")}}
    tok = torch.tensor(np.asarray(seq, np.int64)[None], device="cuda")
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    logits, _ = tf.prefill_chunk(params, cfg, tok, zero,
                                 torch.tensor([len(seq)], device="cuda"),
                                 cache)
    top = torch.topk(logits[0, 0], 2).values
    return float(top[0] - top[1])


def phase_serve(card: str) -> dict:
    cfg = get_config(ARCH)
    params = tf.init_params(cfg, seed=0, device="cuda")
    reqs = schedule(cfg)
    # warm-up (cuBLAS handles, allocator) on two short requests
    serve(params, cfg, reqs[:2], "flash")
    runtime.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    eng, st, step_s = serve(params, cfg, reqs, "flash")
    torch.cuda.synchronize()
    launches = fd_ops.COUNTER.count
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or launches != st.decode_dispatches * cfg.n_layers:
        raise AssertionError(f"flash_decode launched {launches} times over "
                             f"{st.decode_dispatches} decode dispatches x "
                             f"{cfg.n_layers} layers")
    if st.n_requests != len(reqs) or st.prefix_hits == 0:
        raise AssertionError(f"served {st.n_requests}/{len(reqs)}, prefix "
                             f"hits {st.prefix_hits}")
    by_rid = {r.rid: r for r in reqs}
    for c in st.completions:
        if c.tokens.shape != (by_rid[c.rid].max_new,) \
                or c.tokens.min() < 0 or c.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {c.rid}: bad stream {c.tokens}")
    runtime.reset_counters()
    _, sp, step_p = serve(params, cfg, reqs, "plain")
    if fd_ops.COUNTER.count:
        raise AssertionError("the plain decode path launched the kernel")
    got = {c.rid: c.tokens.tolist() for c in st.completions}
    want = {c.rid: c.tokens.tolist() for c in sp.completions}
    compared, ties = 0, []
    for rid in sorted(want):
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                seq = list(by_rid[rid].prompt) + want[rid][:i]
                gap = top2_gap(params, cfg, seq)
                if gap >= GAP_TIE:
                    raise AssertionError(
                        f"request {rid} token {i}: flash {a} vs plain {b}, "
                        f"plain top-2 gap {gap:.3e} >= {GAP_TIE}")
                ties.append((rid, i, gap))
                print(f"[serve] request {rid} step {i}: near-tie (top-2 gap "
                      f"{gap:.2e}); not compared further")
                break
            compared += 1
    res = {
        "requests": st.n_requests, "gen_tokens": st.gen_tokens,
        "tokens_per_s": st.tokens_per_s, "plain_tokens_per_s":
        sp.tokens_per_s, "makespan_s": st.makespan,
        "decode_steps": st.decode_dispatches,
        "decode_step_ms": 1e3 * float(np.mean(step_s)),
        "plain_decode_step_ms": 1e3 * float(np.mean(step_p)),
        "launches": launches,
        "launches_per_step": launches / st.decode_dispatches,
        "peak_mem_bytes": peak, "prefix_hits": st.prefix_hits,
        "reused_tokens": st.reused_tokens, "pages_peak": st.pages_peak,
        "prefill_chunks": st.prefill_chunks, "tokens_compared": compared,
        "near_ties": ties, "p50_s": st.p50_latency, "p95_s": st.p95_latency}
    print(f"[serve] {ARCH} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}), paged ps={PAGE} x {eng.n_pages} pages, "
          f"{st.n_requests} requests, {st.gen_tokens} tokens: flash "
          f"{st.tokens_per_s:.1f} tok/s, decode step "
          f"{res['decode_step_ms']:.2f} ms mean over {len(step_s)}; plain "
          f"{sp.tokens_per_s:.1f} tok/s, {res['plain_decode_step_ms']:.2f} "
          f"ms; flash_decode launches {launches} "
          f"({res['launches_per_step']:.0f}/step); prefix hits "
          f"{st.prefix_hits}; peak mem {peak / 2**20:.0f} MiB; streams equal "
          f"on {compared} tokens, {len(ties)} near-ties | {card}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs "
              "on a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    name = runtime.require_hopper("cuda")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {name} | {card}")
    t0 = time.perf_counter()
    built = fd_ops.library()
    print(f"[build] {built.path.name}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built.seconds:.2f} s) | "
          + "; ".join(ln.strip().split("info    : ")[-1]
                      for ln in built.log.splitlines()
                      if "registers" in ln))
    kern = phase_kernels(card)
    srv = phase_serve(card)
    row = {"name": "flash_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_decode/flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode/flash_decode.py:47",
           "launches": srv["launches"], "max_abs_err": kern["max_abs_err"],
           "ms": kern["ms"], "plain_ms": kern["plain_ms"],
           "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
           "library_ms": kern["library_ms"]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": built.seconds, "ptxas": built.log, "kernel": kern,
         "serve": srv}, indent=1, default=str))
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
