#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases (one line or a few each; any failure exits non-zero and prints no
result):

1. device  — torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``), ``require_hopper()``;
2. build   — nvcc builds every kernel from the sources in this checkout
   (into ``build/torch_ext/``), one nvcc per source, all started
   together; nvcc seconds and ptxas registers per kernel;
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card: flash-decode at the served model's shapes within its stated
   tolerance, bf16 also row by row (ragged rows, dead rows, holes in the
   page map, the dense identity map, 64- and 128-key pages, one forced
   split and many, splits ending inside a page, 4096-position rows),
   each case launched twice and bit-identical; the fused
   error-feedback block-top-k
   compressor BIT-EXACT
   (values, indices, residual) on the JAX kernel tests' cases batched
   over 3 workers, rows with NaN / all zeros / magnitude ties, and the
   elastic-SGD demo's shape; then each kernel's time per launch (CUDA
   events; flash-decode's from CUDA graphs, its eager calls and the
   wrapper's host time per call beside it)
   beside its plain version's, a library yardstick's and the least time
   the card could take;
4. serve   — ``mlitb-lm-100m`` at full width (random weights from a
   seed) serves 32 requests through the paged continuous-batching engine
   with prefix reuse and the flash-decode kernel on the decode path; the
   launch counters prove the kernel ran; the same schedule served with
   the plain decode path must give the same token streams (a differing
   token passes only where the plain path's top-2 logit gap is below
   1e-4, and that request is then not compared further);
5. train   — the paper's elastic-SGD scenario
   (``repro_torch.launch.elastic_sgd``: 14 iterations, workers joining
   and leaving, the §3.5 conv net at full width, AdaGrad, the packed
   blocktopk channel) on the card with one compressor launch per reduce
   step, and again on the CPU (the plain version) in this process: events,
   worker counts, vectors and wire bytes equal, loss within 1e-3
   relative, test error within 0.01, final test error <= 0.05 on the card;
   the same card-vs-CPU gates again on three further seeds;
6. reduce at LM scale — the same ``MasterReducer`` over
   ``mlitb-lm-100m``'s flat parameter buffer (n = 100 682 496), 4 seeded
   workers, block_w 128, 3 reduce steps; the first step's kernel output
   bit-exact against the plain version on the same card tensors; kernel,
   plain and ``torch.topk`` times beside the bandwidth bound;
7. kernel API (slice 3) — the port's public kernel API
   (``repro_torch.kernels``) at full width, with the launch counters
   reset just before and read just after: ``flash_attention`` over
   ``mlitb-lm-100m``'s prefill (16 slots x 512 tokens, f32) and
   ``qwen3-4b``'s heads at 4096 tokens (bf16), ``ssd_scan`` at
   ``mamba2-780m``'s widths (B 4, S 2048, f32), ``block_topk`` over
   ``mlitb-lm-100m``'s flat buffer (f32 and bf16) and the conv net's;
8. flash_attention, ssd_scan, block_topk — each kernel against its plain
   PyTorch version: the JAX kernel tests' cases and the edge cases
   (S != T, fully masked rows, no keys at all, ragged non-causal keys,
   D = 256, sliding windows at full-width heads, the LM's heads in bf16;
   bf16 also row by row; Q not a power of two, bf16, N = 64, one chunk,
   S = chunk + 1, hd 32 and 128, N 4 and 12, a call cut into windows of
   chunks; NaN / signed-zero / infinity / tie rows, W > 1024), then the
   full-width outputs of phase 7 (and the scan at one sequence of
   ``mamba2-780m``); then each kernel's time per launch beside its plain
   version's, a library yardstick's (SDPA; ``torch.topk``; none for the
   scan) and the least time the card could take;
9. a ``{"kernels": [...]}`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. Imports ``torch``,
``numpy`` and ``repro_torch`` only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (GradientCompressor, MasterReducer,  # noqa: E402
                              flat_spec)
import repro_torch.kernels as api  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.topk_compress import ops as tk_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.topk_compress.ref import (  # noqa: E402
    block_topk_flat_ref, fused_block_topk_batched_ref)
from repro_torch.launch.elastic_sgd import run_demo  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adagrad  # noqa: E402
from repro_torch.models.attention import _pow2_kv_block  # noqa: E402
from repro_torch.serving import (PagingConfig, ServingConfig,  # noqa: E402
                                 ServingEngine, generate_requests)

ARCH = "mlitb-lm-100m"
# the served engine: paged pool, 16-token pages, 16 slots of 512 tokens
MAX_BATCH, MAX_SEQ, PAGE = 16, 512, 16
N_REQUESTS = 32
# the elastic-SGD demo runs card vs CPU on seed 0 (the main path, counted)
# and on these further seeds, to show the loss gate's margin
TRAIN_SEEDS = (0, 1, 2, 3)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores — the kernel accumulates in f32 on the
# CUDA cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# bf16 through the tensor cores, dense: the least time for bf16 inputs
BF16_FLOPS = 989e12
# TF32 through the tensor cores, dense: the float32 routes of
# flash_attention and ssd_scan are 3xTF32, three TF32 products for each
# float32-accurate one
TF32_FLOPS = 495e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 results are held row by row as well: ||kernel - plain|| / ||plain||
# over each output row of D values within 2^-6, four units of bf16's
# rounding (2^-8): the kernels round P (flash_attention) and the output
# to bf16, the plain versions round only the output. TOL alone is as
# large as a typical output at long rows (|out| ~ 0.03 at 4096 keys),
# where a dropped 128-key tile moves a row by ~0.2 of its norm.
ROW_TOL_BF16 = 2.0 ** -6
GAP_TIE = 1e-4


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ||out - ref|| / ||ref|| over the rows of the last dim; a
    row where ``ref`` is zero counts 0 if ``out`` is zero there, else
    inf."""
    d = (out.float() - ref.float()).flatten(0, -2).norm(dim=1)
    r = ref.float().flatten(0, -2).norm(dim=1)
    rel = torch.where(r > 0, d / r.clamp_min(1e-30),
                      torch.where(d > 0, torch.full_like(d, torch.inf),
                                  torch.zeros_like(d)))
    return float(rel.max()) if rel.numel() else 0.0


def host_us_per_call(fn, calls: int) -> float:
    """The host's time per ``fn()`` over ``calls`` calls queued without a
    sync (microseconds): a wrapper's own cost, where the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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


def check(name: str, args: dict, dtype, split=None) -> tuple:
    """The kernel against its plain version; ``split`` forces the keys per
    split (else the wrapper's choice). A second launch must give the same
    bits: the combine merges the splits in a fixed order. Returns the
    largest |kernel - plain| and, for bf16, the largest row error
    (``row_rel_err``, else 0)."""
    out = fd_ops._launch(**args, split=split)
    again = fd_ops._launch(**args, split=split)
    ref = flash_decode_ref(**args)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches differ")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    if not np.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > "
                             f"{TOL[dtype]}")
    rel = row_rel_err(out, ref) if dtype == torch.bfloat16 else 0.0
    if not rel <= ROW_TOL_BF16:
        raise AssertionError(f"{name}: row error ||kernel - plain|| / "
                             f"||plain|| = {rel} > {ROW_TOL_BF16}")
    dead = args["live"] == 0
    if bool(dead.any()) and bool((out[dead] != 0).any()):
        raise AssertionError(f"{name}: dead rows are not exact zeros")
    print(f"[kernel] flash_decode {name}"
          + (f" split={split}" if split is not None else "")
          + f": max |kernel - plain| = {err:.3e} (bound {TOL[dtype]:.0e})"
          + (f", row error {rel:.3e} (bound {ROW_TOL_BF16:.4g})"
             if dtype == torch.bfloat16 else "")
          + ", repeat bit-identical")
    return err, rel


def phase_kernels(card: str) -> dict:
    gen = torch.Generator().manual_seed(0)
    errs, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # (a) the served shapes: B=16, H=12, K=4, D=64, ps=16, P=32, N=512
        a = decode_case(gen, dtype=dtype)
        one = {k: (v[0] if k in ("q", "kpool", "vpool") else v)
               for k, v in a.items()}
        res = [check(f"served-shapes/{tag}", one, dtype)]
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
        res.append(check(f"ragged+dead/{tag}", b, dtype))
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
        res.append(check(f"oob-pages/{tag}", c, dtype))
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
        res.append(check(f"dense-identity(ps={ps})/{tag}", d, dtype))
        # (e) the split-KV partition forced: one split over all 512
        #     positions, 32-key splits (many per row, most past pos), and
        #     splits of 32 and 96 keys that end inside 64- and 128-key
        #     pages
        res.append(check(f"served-shapes one split/{tag}", one, dtype,
                         split=MAX_SEQ))
        res.append(check(f"ragged+dead many splits/{tag}", b, dtype,
                         split=32))
        res.append(check(f"oob-pages/{tag}", c, dtype, split=96))
        for pps in (64, 128):
            f = decode_case(gen, ps=pps, P=MAX_SEQ // pps, dtype=dtype)
            f = {k: (v[0] if k in ("q", "kpool", "vpool") else v)
                 for k, v in f.items()}
            res.append(check(f"ps={pps}/{tag}", f, dtype))
            for r in (32, 96):
                res.append(check(f"ps={pps}/{tag}", f, dtype, split=r))
        # (f) long context: 4 rows of up to 4096 positions, ragged pos
        g = decode_case(gen, B=4, P=4096 // PAGE, dtype=dtype)
        g = {k: (v[0] if k in ("q", "kpool", "vpool") else v)
             for k, v in g.items()}
        res.append(check(f"long context B=4 P*ps=4096/{tag}", g, dtype))
        errs[tag] = max(r[0] for r in res)
        rows[tag] = max(r[1] for r in res)
    # timing: the served shapes over 12 layers' pools, as a decode step
    timing = time_flash_decode(decode_case(gen, layers=12), card)
    return {"max_abs_err": errs["f32"], "max_abs_err_bf16": errs["bf16"],
            "max_row_rel_err_bf16": rows["bf16"], **timing}


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

    # the kernel's device time from CUDA graphs of 240 launches (the
    # wrapper's host cost per call, which a decode step pays on the host,
    # drops out); back-to-back eager calls beside it
    ms = graph_ms(kernel, 240)
    eager_ms = cuda_ms(kernel, 240)
    host_us = host_us_per_call(kernel, 240)
    plain_ms = cuda_ms(plain, 48)
    library_ms = cuda_ms(sdpa, 240)
    ms2 = graph_ms(kernel, 240)
    live_tok = int(((pos.long() + 1) * (live != 0)).sum())
    esize = q.element_size()
    nbytes = (2 * live_tok * K * D * esize          # live K and V
              + 2 * B * H * D * esize               # q in, out
              + pm.numel() * 4 + 2 * B * 4)         # page map, pos, live
    flops = 4 * live_tok * (H // K) * K * D         # QK^T and PV
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    res = {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "ms_eager": eager_ms,
           "host_us": host_us,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "live_tokens": live_tok}
    print(f"[kernel] flash_decode timing (B={B} H={H} K={K} D={D} ps={ps} "
          f"P={P}, {live_tok} live tokens, f32): kernel "
          f"{res['ms'] * 1e3:.1f} us/launch from CUDA graphs ({ms * 1e3:.1f},"
          f" {ms2 * 1e3:.1f}), {eager_ms * 1e3:.1f} us called eagerly "
          f"({host_us:.1f} us of host time per call); "
          f"plain {plain_ms * 1e3:.1f} us, SDPA "
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


# ---------------------------------------------------------------------------
# the fused error-feedback block-top-k compressor
# ---------------------------------------------------------------------------
def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-exact up to the NaN payload (NaN == NaN) and the sign of 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    ok = torch.isfinite(a) & torch.isfinite(b)
    d = (a[ok].double() - b[ok].double()).abs()
    return float(d.max()) if d.numel() else 0.0


def tk_check(name: str, g: torch.Tensor, r: torch.Tensor, k: int,
             W: int) -> float:
    out = tk_ops.fused_block_topk_batched(g, r, k=k, block_w=W)
    ref = fused_block_topk_batched_ref(g, r, k=k, block_w=W)
    torch.cuda.synchronize()
    for a, b, what in zip(out, ref, ("values", "indices", "residual")):
        if not same(a, b):
            diff = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"fused_compress {name}: {what} differ from "
                                 f"the plain version ({diff} entries)")
    err = max(max_err(out[0], ref[0]), max_err(out[2], ref[2]))
    print(f"[kernel] fused_compress {name}: bit-exact (values, indices, "
          f"residual)")
    return err


def tk_bound(Wk: int, n: int, W: int, k: int) -> dict:
    """Least time for one launch: g and r read once, residual, values and
    indices written once, over HBM bandwidth; or the f32 operations (one
    add per entry, |.| and a compare per entry per round) over the CUDA
    cores' peak."""
    R = -(-n // W)
    nbytes = 4 * Wk * n * 3 + 8 * Wk * R * k
    ops = Wk * n + 2 * k * Wk * R * W
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def graph_ms(fn, n: int, replays: int = 10) -> float:
    """Device time of one ``fn()`` from a CUDA graph of ``n`` calls
    replayed ``replays`` times (CUDA events): the host's per-call cost,
    which dominates a microsecond kernel called eagerly, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n)


def time_fused(g: torch.Tensor, r: torch.Tensor, k: int, W: int, *,
               iters: int, plain_iters: int, graph: bool) -> dict:
    """Kernel, plain version and the ``torch.topk`` yardstick (top-k of
    |g + r| per W-row: no residual, no promised tie order; rows padded
    with zeros when W does not divide n) on the same inputs. With
    ``graph`` the three are timed from CUDA graphs (device time; the
    eager back-to-back times, host-bound at small shapes, are kept as
    ``*_eager``); without, eagerly."""
    Wk, n = g.shape
    pad = (-n) % W

    def kernel():
        tk_ops.fused_block_topk_batched(g, r, k=k, block_w=W)

    def plain():
        fused_block_topk_batched_ref(g, r, k=k, block_w=W)

    def library():
        c = (g + r).abs()
        if pad:
            c = F.pad(c, (0, pad))
        torch.topk(c.view(-1, W), k, dim=1)

    eager = {"ms_eager": cuda_ms(kernel, iters),
             "plain_ms_eager": cuda_ms(plain, plain_iters, warmup=1),
             "library_ms_eager": cuda_ms(library, iters)}
    if graph:
        ms, plain_ms = graph_ms(kernel, iters), graph_ms(plain, plain_iters)
        library_ms, ms2 = graph_ms(library, iters), graph_ms(kernel, iters)
    else:
        ms, plain_ms = eager["ms_eager"], eager["plain_ms_eager"]
        library_ms, ms2 = eager["library_ms_eager"], cuda_ms(kernel, iters)
    return {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
            "library_ms": library_ms, **eager, **tk_bound(Wk, n, W, k)}


def phase_fused_kernel(card: str) -> dict:
    gen = torch.Generator().manual_seed(2)

    def cuda(x):
        return x.to("cuda")

    err = 0.0
    # the JAX kernel tests' (n, W, k) cases, batched over 3 workers
    for n, W, k in ((128, 8, 1), (1000, 16, 3), (64, 33, 5), (4096, 128, 2),
                    (7, 8, 3), (5, 4, 9)):
        g = torch.randn(3, n, generator=gen)
        r = torch.randn(3, n, generator=gen) * 0.3
        err = max(err, tk_check(f"n={n} W={W} k={k} x3", cuda(g), cuda(r),
                                k, W))
    # NaN, all-zero, signed-zero, tie and infinity rows, and integer rows
    rows = torch.tensor([[0.5, float("nan"), -2.0, 1.0], [0.0] * 4,
                         [3.0, -3.0, 3.0, 1.0], [-0.0, 0.0, -0.0, 0.0],
                         [1.0, 2.0, -2.0, 2.0],
                         [float("inf"), -float("inf"), 1.0, 0.0]])
    g = torch.stack([rows.reshape(-1), rows.flip(0).reshape(-1),
                     torch.round(rows.reshape(-1) * 2)])
    for k in (1, 2, 4):
        err = max(err, tk_check(f"nan/zero/tie rows k={k}", cuda(g),
                                cuda(torch.zeros_like(g)), k, 4))
    gi = torch.randint(-3, 4, (3, 999), generator=gen).float()
    ri = torch.randint(-1, 2, (3, 999), generator=gen).float()
    for W, k in ((8, 3), (32, 1), (128, 5), (1024, 2)):
        err = max(err, tk_check(f"integer ties W={W} k={k}", cuda(gi),
                                cuda(ri), k, W))
    # the elastic-SGD demo's reduce step: W_cap 8 (5 live rows, 3 vacant
    # zero rows), n = 31 786, W = 32, k = 1
    Wk, n = 8, 31786
    g = torch.randn(Wk, n, generator=gen) * 1e-2
    r = torch.randn(Wk, n, generator=gen) * 1e-3
    g[5:] = 0.0
    r[5:] = 0.0
    g, r = cuda(g), cuda(r)
    err = max(err, tk_check("demo shape W_cap=8 n=31786 W=32 k=1", g, r, 1,
                            32))
    t = time_fused(g, r, 1, 32, iters=100, plain_iters=20, graph=True)
    print(f"[kernel] fused_compress timing, demo shape (8 x 31786, W=32, "
          f"k=1, L2-warm, CUDA graphs): kernel {t['ms'] * 1e3:.2f} us/launch "
          f"({t['ms_runs'][0] * 1e3:.2f}, {t['ms_runs'][1] * 1e3:.2f}), "
          f"plain {t['plain_ms'] * 1e3:.1f} us, torch.topk "
          f"{t['library_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} "
          f"us ({t['bound_by']}, {t['bytes'] / 1e6:.2f} MB); called eagerly "
          f"{t['ms_eager'] * 1e3:.1f} / {t['plain_ms_eager'] * 1e3:.1f} / "
          f"{t['library_ms_eager'] * 1e3:.1f} us | {card}")
    return {"max_abs_err": err, "demo": t}


# ---------------------------------------------------------------------------
# the training slice at full width
# ---------------------------------------------------------------------------
def same_run(gpu, cpu, seed: int) -> float:
    """Hold the card's demo run against the CPU's: events, workers,
    vectors and wire bytes equal, loss within 1e-3 relative, test error
    within 0.01, final test error <= 0.05. Returns the largest relative
    loss difference."""
    if cpu.launches:
        raise AssertionError("the CPU run launched the kernel")
    for a, b, ea, eb in zip(gpu.logs, cpu.logs, gpu.test_err, cpu.test_err):
        if (a.events, a.n_workers, a.vectors, a.wire_bytes) \
                != (b.events, b.n_workers, b.vectors, b.wire_bytes):
            raise AssertionError(f"seed {seed} iteration {a.step}: card {a} "
                                 f"vs cpu {b}")
        if not np.isfinite(a.loss) or abs(a.loss - b.loss) > 1e-3 * abs(
                b.loss) or abs(ea - eb) > 0.01:
            raise AssertionError(
                f"seed {seed} iteration {a.step}: loss {a.loss} vs {b.loss}, "
                f"test error {ea} vs {eb}")
    if gpu.test_err[-1] > 0.05:
        raise AssertionError(f"seed {seed}: final test error "
                             f"{gpu.test_err[-1]} > 0.05")
    return max(abs(a.loss - b.loss) / abs(b.loss)
               for a, b in zip(gpu.logs, cpu.logs))


def phase_train(card: str, kernel_ms: float) -> dict:
    starts, ends = [], []
    inner = MasterReducer.reduce_and_step

    def timed(self, *a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        out = inner(self, *a, **kw)
        e.record()
        starts.append(s)
        ends.append(e)
        return out

    runtime.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    MasterReducer.reduce_and_step = timed
    try:
        gpu = run_demo(device="cuda")
    finally:
        MasterReducer.reduce_and_step = inner
    torch.cuda.synchronize()
    launches = tk_ops.COUNTER.count
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    steps = gpu.loop.reducer.step
    if launches == 0 or launches != steps or fd_ops.COUNTER.count:
        raise AssertionError(f"fused_compress launched {launches} times over "
                             f"{steps} reduce steps (flash_decode "
                             f"{fd_ops.COUNTER.count})")
    t0 = time.perf_counter()
    cpu = run_demo(device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = same_run(gpu, cpu, 0)
    # the margin: the same gates on further seeds (data, weights, fleet)
    rel_seeds = {0: rel}
    for seed in TRAIN_SEEDS[1:]:
        rel_seeds[seed] = same_run(run_demo(device="cuda", seed=seed),
                                   run_demo(device="cpu", seed=seed), seed)
    res = {
        "iterations": len(gpu.logs), "reduce_steps": steps,
        "launches": launches,
        "host_ms_per_iter": 1e3 * float(np.mean(gpu.iter_s)),
        "host_ms_per_iter_median": 1e3 * float(np.median(gpu.iter_s)),
        "host_ms_all": [1e3 * x for x in gpu.iter_s],
        "cpu_host_ms_per_iter": 1e3 * float(np.mean(cpu.iter_s)),
        "cpu_run_s": cpu_s,
        "reduce_step_ms": float(np.mean(step_ms)), "reduce_step_ms_all":
        step_ms, "peak_mem_bytes": peak,
        "loss": [lg.loss for lg in gpu.logs],
        "cpu_loss": [lg.loss for lg in cpu.logs],
        "test_err": gpu.test_err, "cpu_test_err": cpu.test_err,
        "max_loss_rel": rel, "max_loss_rel_by_seed": rel_seeds,
        "workers": [lg.n_workers for lg in gpu.logs],
        "wire_bytes": [lg.wire_bytes for lg in gpu.logs],
        "trace_count": gpu.loop.reducer.trace_count}
    margin = ", ".join(f"{k}: {v:.1e}" for k, v in rel_seeds.items())
    print(f"[train] elastic SGD, mlitb-cnn full width, {len(gpu.logs)} "
          f"iterations, workers {res['workers']}: final loss "
          f"{gpu.logs[-1].loss:.4f}, test error {gpu.test_err[-1]:.3f}; "
          f"matches the CPU run (loss within {rel:.1e} rel, events/vectors/"
          f"wire equal; by seed {margin}); "
          f"fused_compress launches {launches} = reduce steps {steps}; host "
          f"{res['host_ms_per_iter']:.2f} ms/iteration (median "
          f"{res['host_ms_per_iter_median']:.2f}; CPU run "
          f"{res['cpu_host_ms_per_iter']:.2f}), reduce step "
          f"{res['reduce_step_ms']:.3f} ms (CUDA events; the kernel alone "
          f"{kernel_ms * 1e3:.2f} us/launch at this shape from CUDA graphs, "
          f"L2-warm); peak mem {peak / 2**20:.0f} MiB | {card}")
    return res


def phase_reduce_lm(card: str) -> dict:
    cfg = get_config(ARCH)
    params = tf.init_params(cfg, seed=0, device="cuda")
    red = MasterReducer(params, adagrad(lr=0.02), GradientCompressor(
        "blocktopk", frac=1 / 128, block_w=128))
    del params
    spec = flat_spec(red.params)
    n = red.flat_n
    if n != cfg.n_params():
        raise AssertionError(f"flat buffer {n} != n_params {cfg.n_params()}")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def messages():
        return {f"w{i}": (spec.unflatten(torch.randn(
            n, generator=gen, device="cuda")), 1000 + i) for i in range(4)}

    msgs = messages()
    G = torch.stack([spec.flatten(msgs[w][0]) for w in sorted(msgs)])
    Z = torch.zeros_like(G)
    err = tk_check(f"LM scale 4 x {n} W=128 k=1", G, Z, 1, 128)
    out = tk_ops.fused_block_topk_batched(G, Z, k=1, block_w=128)
    del Z
    runtime.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for s in range(3):
        if s:
            msgs = messages()
        t0 = time.perf_counter()
        red.reduce_and_step(msgs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if s == 0:
            for i, w in enumerate(sorted(msgs)):
                if not same(red._residuals[w], out[2][i]):
                    raise AssertionError(f"reduce step 1: {w}'s residual is "
                                         f"not the kernel's")
            del out
    launches = tk_ops.COUNTER.count
    peak = torch.cuda.max_memory_allocated()
    if launches != 3:
        raise AssertionError(f"fused_compress launched {launches} times in 3 "
                             f"reduce steps")
    R = -(-n // 128)
    if red.last_wire_bytes != 4 * 8 * R \
            or not bool(torch.isfinite(red.flat_params).all()):
        raise AssertionError(f"wire bytes {red.last_wire_bytes} != "
                             f"{4 * 8 * R} or non-finite params")
    # time the kernel on step-4 gradients against real residuals
    msgs = messages()
    G = torch.stack([spec.flatten(msgs[w][0]) for w in sorted(msgs)])
    Rs = torch.stack([red._residuals[w] for w in sorted(msgs)])
    del msgs
    t = time_fused(G, Rs, 1, 128, iters=20, plain_iters=2, graph=False)
    res = {"n": n, "launches": launches, "max_abs_err": err,
           "reduce_step_ms": [1e3 * x for x in step_s],
           "peak_mem_bytes": peak, **t}
    print(f"[reduce] {ARCH} flat buffer n={n}, 4 workers, W=128, k=1: 3 "
          f"reduce steps {', '.join(f'{1e3 * x:.2f}' for x in step_s)} ms; "
          f"fused_compress launches {launches}; kernel {t['ms']:.3f} ms/"
          f"launch ({t['ms_runs'][0]:.3f}, {t['ms_runs'][1]:.3f}), plain "
          f"{t['plain_ms']:.3f} ms, torch.topk {t['library_ms']:.3f} ms, "
          f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}, "
          f"{t['bytes'] / 1e9:.3f} GB); peak mem {peak / 2**30:.2f} GiB "
          f"| {card}")
    return res


# ---------------------------------------------------------------------------
# slice 3: the public kernel API at full width
# ---------------------------------------------------------------------------
# flash_attention: mlitb-lm-100m's prefill over the served engine's 16
# slots x 512 tokens (f32), and qwen3-4b's heads at train_4k's length
# (bf16)
FA_SHAPES = {
    "mlitb-lm-100m prefill": dict(B=MAX_BATCH, H=12, K=4, S=MAX_SEQ,
                                  T=MAX_SEQ, D=64, dtype=torch.float32),
    "qwen3-4b 4k": dict(B=1, H=32, K=8, S=4096, T=4096, D=128,
                        dtype=torch.bfloat16)}
# ssd_scan: mamba2-780m (d_inner 3072 = 48 heads x 64, N 128, chunk 128)
SSD_SHAPE = dict(B=4, S=2048, nh=48, hd=64, N=128, chunk=128)
# block_topk: mlitb-lm-100m's flat buffer (blocktopk frac 1/128) and the
# conv net's (frac 1/32)
BT_SHAPES = {"lm f32": (100_682_496, 128, torch.float32),
             "lm bf16": (100_682_496, 128, torch.bfloat16),
             "cnn f32": (31_786, 32, torch.float32)}
SLICE3 = ("flash_attention", "ssd_scan", "block_topk")


def fa_inputs(gen, *, B, H, K, S, T, D, dtype):
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, H, S, D), (B, K, T, D), (B, K, T, D)))


def ssd_inputs(gen, *, B, S, nh, hd, N, dtype=torch.float32, **_):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, S, nh, hd)
    dt = F.softplus(randn(B, S, nh))
    A = -torch.exp(randn(nh) * 0.5)
    Bm, Cm = randn(B, S, N) * 0.5, randn(B, S, N) * 0.5
    return (x.to(dtype), dt.to(dtype), A, Bm.to(dtype), Cm.to(dtype))


def phase_api(card: str) -> dict:
    """The slice's main path: ``repro_torch.kernels`` at full width, the
    launch counters set to 0 just before and read just after."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    fa_in = {n: fa_inputs(gen, **shape) for n, shape in FA_SHAPES.items()}
    ssd_in = ssd_inputs(gen, **SSD_SHAPE)
    bt_in = {n: torch.randn(size, generator=gen, device="cuda").to(dtype)
             for n, (size, _, dtype) in BT_SHAPES.items()}
    torch.cuda.synchronize()
    runtime.reset_counters()
    t0 = time.perf_counter()
    fa_out = {n: api.flash_attention(*a) for n, a in fa_in.items()}
    ssd_out = api.ssd_scan(*ssd_in, chunk=SSD_SHAPE["chunk"])
    bt_out = {n: api.block_topk(bt_in[n], block_w=W)
              for n, (_, W, _) in BT_SHAPES.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: runtime.COUNTERS[n].count for n in SLICE3}
    want = {"flash_attention": len(FA_SHAPES), "ssd_scan": 1,
            "block_topk": len(BT_SHAPES)}
    others = {n: c.count for n, c in runtime.COUNTERS.items()
              if n not in SLICE3 and c.count}
    if launches != want or others:
        raise AssertionError(f"kernel API launches {launches} (want {want}), "
                             f"other kernels {others}")
    for n, a in fa_in.items():
        if fa_out[n].shape != a[0].shape or fa_out[n].dtype != a[0].dtype \
                or not bool(torch.isfinite(fa_out[n]).all()):
            raise AssertionError(f"flash_attention {n}: bad output")
    if ssd_out.shape != ssd_in[0].shape \
            or not bool(torch.isfinite(ssd_out).all()):
        raise AssertionError("ssd_scan: bad output")
    for n, (size, W, dtype) in BT_SHAPES.items():
        kept = (bt_out[n] != 0).sum()
        if bt_out[n].dtype != dtype or int(kept) > -(-size // W):
            raise AssertionError(f"block_topk {n}: {int(kept)} entries kept")
    print(f"[api] repro_torch.kernels at full width: flash_attention "
          f"({', '.join(FA_SHAPES)}), ssd_scan (mamba2-780m, B 4, S 2048), "
          f"block_topk ({', '.join(BT_SHAPES)}): launches {launches} in "
          f"{seconds * 1e3:.1f} ms | {card}")
    return {"launches": launches, "seconds": seconds,
            "flash_attention": (fa_in, fa_out), "ssd_scan": (ssd_in, ssd_out),
            "block_topk": (bt_in, bt_out)}


def fa_valid(S: int, T: int, causal: bool, window: int) -> torch.Tensor:
    s_pos = torch.arange(S, device="cuda")[:, None]
    t_pos = torch.arange(T, device="cuda")[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device="cuda")
    if causal:
        mask &= t_pos <= s_pos
    if window:
        mask &= t_pos > s_pos - window
    return mask


def fa_check(name: str, q, k, v, *, causal=True, window=0, out=None
             ) -> tuple:
    """The kernel against its plain version: max |kernel - plain| within
    TOL, bf16 rows within ROW_TOL_BF16, rows with no valid key exact
    zeros. Returns the max error and the row error (0 for f32)."""
    if out is None:
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"flash_attention {name}: {out.shape}/"
                             f"{out.dtype} vs {ref.shape}/{ref.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    if not np.isfinite(err) or err > TOL[q.dtype]:
        raise AssertionError(f"flash_attention {name}: max |kernel - plain| "
                             f"= {err} > {TOL[q.dtype]}")
    bf16 = q.dtype == torch.bfloat16
    rel = row_rel_err(out, ref) if bf16 else 0.0
    if not rel <= ROW_TOL_BF16:
        raise AssertionError(f"flash_attention {name}: row error ||kernel - "
                             f"plain|| / ||plain|| = {rel} > {ROW_TOL_BF16}")
    dead = ~fa_valid(q.shape[2], k.shape[2], causal, window).any(dim=1)
    if bool(dead.any()) and bool((out[:, :, dead] != 0).any()):
        raise AssertionError(f"flash_attention {name}: rows with no valid "
                             f"key are not exact zeros")
    print(f"[kernel] flash_attention {name}: max |kernel - plain| = "
          f"{err:.3e} (bound {TOL[q.dtype]:.0e})"
          + (f", row error {rel:.3e} (bound {ROW_TOL_BF16:.4g})" if bf16
             else "")
          + (f", {int(dead.sum())} rows with no key exact zeros"
             if bool(dead.any()) else ""))
    return err, rel


def fa_bound(q, k, causal=True, window=0) -> dict:
    """Least time: q, k, v read and out written once over HBM bandwidth,
    or the two products' multiply-adds (4 D flops per valid (query, key)
    pair; the exps not counted) over the tensor cores' peak for the
    kernel's route: bf16 at 989 TFLOP/s, f32 as 3xTF32, three times the
    flops at 495 TFLOP/s."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    pairs = int(fa_valid(S, T, causal, window).sum())
    flops = 4 * D * pairs * B * H
    nbytes = q.element_size() * (2 * B * H * S * D + 2 * B * K * T * D)
    # f32 is computed as 3xTF32: three TF32 products per f32 product
    t_ops = (flops / BF16_FLOPS if q.dtype == torch.bfloat16
             else 3 * flops / TF32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_fa(name: str, q, k, v, card: str, iters: int, plain_iters: int
            ) -> dict:
    def kernel():
        fa_ops.flash_attention(q, k, v)

    def plain():
        attention_ref(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    # the same call on K/V repeated to H heads beforehand (not timed),
    # which SDPA's fused backends take where enable_gqa is not supported
    G = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)

    def sdpa_expanded():
        F.scaled_dot_product_attention(q, ke, ve, is_causal=True)

    ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(plain, plain_iters, warmup=1)
    library_ms = cuda_ms(sdpa, iters)
    expanded_ms = cuda_ms(sdpa_expanded, iters)
    ms2 = cuda_ms(kernel, iters)
    sdpa_err = float((sdpa().float() - attention_ref(q, k, v).float())
                     .abs().max())
    res = {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": library_ms, "sdpa_expanded_kv_ms": expanded_ms,
           "sdpa_err": sdpa_err, **fa_bound(q, k)}
    print(f"[kernel] flash_attention timing, {name} {tuple(q.shape)} kv "
          f"{tuple(k.shape)} {str(q.dtype)[6:]}, causal: kernel "
          f"{res['ms']:.3f} ms/launch ({ms:.3f}, {ms2:.3f}), plain "
          f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms (|SDPA - plain| "
          f"{sdpa_err:.1e}; on K/V repeated to H heads {expanded_ms:.3f} "
          f"ms), bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}, {res['flops'] / 1e9:.2f} GFLOP, "
          f"{res['bytes'] / 1e6:.1f} MB) | {card}")
    return res


def phase_flash_attention(card: str, main: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = [0.0]

    def held(dtype, res):
        errs[dtype] = max(errs[dtype], res[0])
        rows[0] = max(rows[0], res[1])

    def case(name, B, H, K, S, T, D, dtype=torch.float32, **kw):
        args = fa_inputs(gen, B=B, H=H, K=K, S=S, T=T, D=D, dtype=dtype)
        held(dtype, fa_check(name, *args, **kw))

    # the JAX kernel tests' cases (tests/test_kernels_flash.py)
    for c in ((1, 1, 1, 32, 32, 32, 0), (2, 4, 2, 128, 128, 64, 0),
              (1, 8, 1, 64, 64, 128, 0), (2, 4, 4, 96, 96, 64, 0),
              (1, 4, 2, 128, 128, 64, 32), (1, 2, 2, 256, 256, 32, 96)):
        case(f"case {c}", *c[:6], window=c[6])
    case("bf16 (2,4,2,64,64,64)", 2, 4, 2, 64, 64, 64, torch.bfloat16)
    for D in (64, 128):
        case(f"no keys T=0 bf16 D={D}", 1, 2, 1, 16, 0, D, torch.bfloat16)
    # S != T, rows with no valid key, ragged keys without causality
    case("S<T", 1, 4, 2, 48, 80, 32)
    case("S>T window 16", 1, 2, 1, 80, 48, 32, window=16)
    case("causal window 1", 1, 2, 2, 32, 32, 32, window=1)
    case("non-causal window past the keys", 1, 2, 2, 64, 16, 32,
         causal=False, window=8)
    case("ragged non-causal T=24", 1, 2, 1, 40, 24, 32, causal=False)
    case("ragged non-causal T=40", 2, 4, 2, 40, 40, 64, causal=False)
    # D = 256 (paligemma-3b's heads, MQA) and sliding windows at
    # full-width heads
    for dtype in (torch.float32, torch.bfloat16):
        case("paligemma-3b heads D=256", 1, 8, 1, 1024, 1024, 256, dtype)
    case("qwen3-4b heads window 512", 1, 32, 8, 2048, 2048, 128,
         torch.bfloat16, window=512)
    case("mlitb-lm-100m heads window 128", 4, 12, 4, 512, 512, 64,
         window=128)
    case("mlitb-lm-100m prefill heads bf16", MAX_BATCH, 12, 4, MAX_SEQ,
         MAX_SEQ, 64, torch.bfloat16)
    # the main path's full-width outputs
    fa_in, fa_out = main["flash_attention"]
    for n, args in fa_in.items():
        held(args[0].dtype, fa_check(f"{n} (main path)", *args,
                                     out=fa_out[n]))
    timing = {n: time_fa(n, *args, card, iters=8 if n.startswith("qwen")
                         else 20, plain_iters=2 if n.startswith("qwen")
                         else 5)
              for n, args in fa_in.items()}
    return {"max_abs_err": errs[torch.float32],
            "max_abs_err_bf16": errs[torch.bfloat16],
            "max_row_rel_err_bf16": rows[0], "timing": timing}


def ssd_tol(ref: torch.Tensor) -> float:
    """The JAX tests' 5e-4 at S = 256 with values O(5), scaled by the
    largest |y| of the case: the error grows with y's size and with the
    depth of the sums (the float32 cumsum of dt * A)."""
    return 5e-4 * max(1.0, float(ref.float().abs().max()) / 5.0)


def ssd_check(name: str, args, chunk: int, out=None, rows=False) -> float:
    """The kernel against its plain version: max |kernel - plain| within
    ``ssd_tol`` (f32) or 0.15 (bf16); with ``rows`` (bf16 outputs of |y|
    >= 32, where one bf16 step is 0.25) each output row of hd values
    within ||kernel - plain|| / ||plain|| <= ROW_TOL_BF16 instead. Returns
    the measured error."""
    if out is None:
        out = ssd_ops.ssd_scan(*args, chunk=chunk)
    ref = ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"ssd_scan {name}: {out.shape}/{out.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    ymax = float(ref.float().abs().max())
    if rows:
        rel = row_rel_err(out, ref)
        if not rel <= ROW_TOL_BF16:
            raise AssertionError(f"ssd_scan {name}: row error ||kernel - "
                                 f"plain|| / ||plain|| = {rel} > "
                                 f"{ROW_TOL_BF16}")
        print(f"[kernel] ssd_scan {name}: row error {rel:.3e} (bound "
              f"{ROW_TOL_BF16:.4g}), max |kernel - plain| = {err:.3e}, max "
              f"|y| {ymax:.1f}")
        return rel
    tol = 0.15 if out.dtype == torch.bfloat16 else ssd_tol(ref)
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"ssd_scan {name}: max |kernel - plain| = "
                             f"{err} > {tol}")
    print(f"[kernel] ssd_scan {name}: max |kernel - plain| = {err:.3e} "
          f"(bound {tol:.1e}, max |y| {ymax:.1f})")
    return err


def ssd_bound(B, S, nh, hd, N, Q) -> dict:
    """Least time: x, dt, A, Bm, Cm read and y written once, or the
    multiply-adds x 2 (C B^T once per (b, chunk) and causal half; G x
    causal half; the state's read-out and update) over the peak of the
    kernel's route, 3xTF32 on the tensor cores: three TF32 products per
    float32 one at 495 TFLOP/s (``bound_ms``); beside it the same work on
    the CUDA cores' float32 67 TFLOP/s (``bound_f32_ms``)."""
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2
    flops = 2 * (B * nc * N * tri
                 + B * nh * nc * (hd * tri + 2 * Q * N * hd))
    nbytes = 4 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * N)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": max(t_bytes, flops / F32_FLOPS * 1e3)}


def time_ssd(name: str, args, chunk: int, card: str, iters: int,
             plain_iters: int) -> dict:
    def kernel():
        ssd_ops.ssd_scan(*args, chunk=chunk)

    def plain():
        ssd_scan_ref(*args, chunk=chunk)

    ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(plain, plain_iters, warmup=1)
    ms2 = cuda_ms(kernel, iters)
    B, S, nh, hd = args[0].shape
    N = args[3].shape[-1]
    ctas = ssd_ops.launch_ctas(B, S, nh, hd, N, chunk,
                               args[0].device.index)
    res = {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": None, "ctas": ctas,
           **ssd_bound(B, S, nh, hd, N, min(chunk, S))}
    print(f"[kernel] ssd_scan timing, {name} (B {B}, S {S}, nh {nh}, hd {hd}, "
          f"N {N}, chunk {chunk}, f32): kernel {res['ms']:.3f} ms/launch "
          f"({ms:.3f}, {ms2:.3f}), plain {plain_ms:.3f} ms, no library call, "
          f"bound {res['bound_ms']:.4f} ms as 3xTF32 ({res['bound_by']}), "
          f"{res['bound_f32_ms']:.4f} ms on the f32 CUDA cores "
          f"({res['flops'] / 1e9:.2f} GFLOP, {res['bytes'] / 1e6:.1f} MB); "
          f"CTAs: chunk states {ctas['chunk_state']}, state pass "
          f"{ctas['state_pass']}, chunk scan {ctas['chunk_scan']} | {card}")
    return res


def phase_ssd(card: str, main: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    err = 0.0

    def case(name, chunk, **shape):
        nonlocal err
        err = max(err, ssd_check(name, ssd_inputs(gen, **shape), chunk))

    # the JAX kernel tests' cases (tests/test_kernels_ssd.py)
    for B, S, nh, hd, N, chunk in ((1, 32, 1, 32, 16, 16),
                                   (2, 64, 4, 32, 64, 16),
                                   (1, 128, 2, 64, 128, 32),
                                   (2, 50, 3, 32, 64, 16),
                                   (1, 256, 8, 64, 128, 128)):
        case(f"case {(B, S, nh, hd, N, chunk)}", chunk, B=B, S=S, nh=nh,
             hd=hd, N=N)
    # Q = 80 (S < chunk, not a power of two), a ragged tail, N = 64
    # (zamba2-7b's d_state, 112 heads of 64), and bf16 inputs
    case("Q=80", 128, B=2, S=80, nh=2, hd=32, N=32)
    case("S=300 chunk 128", 128, B=2, S=300, nh=4, hd=64, N=128)
    case("zamba2-7b N=64", 128, B=1, S=1024, nh=112, hd=64, N=64)
    bf16 = ssd_check("bf16", ssd_inputs(gen, B=1, S=64, nh=2, hd=32, N=32,
                                        dtype=torch.bfloat16), 16)
    # the seams of the three-kernel design: one chunk (no state pass), a
    # second chunk of one step, hd 32 and 128 (the scan single-buffered),
    # N 4 and 12 (padded to k-steps of 8), and a call cut into windows of
    # chunks (chunk 16 over 8192 steps: 512 chunks, 512 MiB of workspace
    # per 84)
    case("B=1 one chunk, mamba2-780m widths", 128, B=1, S=128, nh=48, hd=64,
         N=128)
    case("S=chunk+1", 128, B=2, S=129, nh=4, hd=64, N=128)
    case("hd=32", 128, B=2, S=256, nh=4, hd=32, N=128)
    case("hd=128", 128, B=1, S=384, nh=4, hd=128, N=128)
    case("N=4", 64, B=1, S=200, nh=3, hd=64, N=4)
    case("N=12", 48, B=2, S=300, nh=5, hd=32, N=12)
    case("windows: chunk 16, S 8192", 16, B=4, S=8192, nh=48, hd=64, N=128)
    bf16_rows = ssd_check("bf16 mamba2-780m widths", ssd_inputs(
        gen, B=1, S=512, nh=48, hd=64, N=128, dtype=torch.bfloat16), 128,
        rows=True)
    # the main path's full-width output, then one sequence at its widths
    args, out = main["ssd_scan"]
    chunk = SSD_SHAPE["chunk"]
    err = max(err, ssd_check("mamba2-780m B=4 S=2048 (main path)", args,
                             chunk, out=out))
    b1 = ssd_inputs(gen, **dict(SSD_SHAPE, B=1))
    err = max(err, ssd_check("mamba2-780m B=1 S=2048", b1, chunk))
    res = time_ssd("mamba2-780m", args, chunk, card, 10, 3)
    res_b1 = time_ssd("mamba2-780m one sequence", b1, chunk, card, 20, 3)
    return {"max_abs_err": err, "max_abs_err_bf16": bf16,
            "max_row_rel_err_bf16": bf16_rows, **res, "b1": res_b1}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit: -0.0 differs from +0.0, NaN payloads compared."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def bt_check(name: str, x: torch.Tensor, W: int, out=None) -> None:
    if out is None:
        out = tk_ops.block_topk(x, block_w=W)
    ref = block_topk_flat_ref(x, block_w=W)
    torch.cuda.synchronize()
    if not same_bits(out, ref):
        diff = int((out != ref).sum()) if out.shape == ref.shape else -1
        raise AssertionError(f"block_topk {name}: differs from the plain "
                             f"version ({diff} entries)")
    print(f"[kernel] block_topk {name}: bit-exact")


def bt_bound(n: int, esize: int) -> dict:
    """Least time: x read and y written once, or an abs and a compare per
    entry over the f32 peak."""
    nbytes = 2 * n * esize
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2 * n / F32_FLOPS * 1e3
    return {"bytes": nbytes, "ops": 2 * n, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_bt(x: torch.Tensor, W: int, *, iters: int, plain_iters: int,
            graph: bool) -> dict:
    """Kernel, plain version and the ``torch.topk`` yardstick (top-1 of
    |x| per W-row, zero-padded: no scatter back, no NaN rule, no promised
    tie order), from CUDA graphs or eagerly as ``time_fused``."""
    pad = (-x.numel()) % W

    def kernel():
        tk_ops.block_topk(x, block_w=W)

    def plain():
        block_topk_flat_ref(x, block_w=W)

    def library():
        c = x.abs()
        if pad:
            c = F.pad(c, (0, pad))
        torch.topk(c.view(-1, W), 1, dim=1)

    timer = graph_ms if graph else cuda_ms
    ms, plain_ms = timer(kernel, iters), timer(plain, plain_iters)
    library_ms, ms2 = timer(library, iters), timer(kernel, iters)
    return {"ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
            "library_ms": library_ms,
            **bt_bound(x.numel(), x.element_size())}


def phase_block_topk(card: str, main: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(6)
    # the JAX kernel tests' shapes (tests/test_kernels_topk.py), W > 1024
    for shape, W in (((128,), 8), ((1000,), 16), ((64, 33), 128),
                     ((3, 5, 7), 8), ((4096,), 128), ((2, 2), 8),
                     ((5000,), 2048), ((3, 1500), 1100)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            bt_check(f"{shape} W={W} {str(dtype)[6:]}", x, W)
    # NaN, all-zero, signed-zero, tie and infinity rows; a ragged tail
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([[0.5, nan, -2.0, 1.0], [0.0] * 4,
                         [-0.0, 0.0, -0.0, 0.0], [3.0, -3.0, 3.0, 1.0],
                         [-3.0, 3.0, 1.0, -0.0], [inf, -inf, 1.0, 0.0],
                         [-inf, 2.0, nan, 0.0], [1.0, -0.0, -0.0, -5.0]],
                        device="cuda").reshape(-1)
    for dtype in (torch.float32, torch.bfloat16):
        for x in (rows, rows[:-2]):
            bt_check(f"NaN/zero/tie/inf rows n={x.numel()} "
                     f"{str(dtype)[6:]}", x.to(dtype), 4)
    gi = torch.randint(-3, 4, (4999,), generator=gen, device="cuda").float()
    bt_check("integer ties W=64", gi, 64)
    # the main path's full-width outputs
    bt_in, bt_out = main["block_topk"]
    for n, (_, W, _) in BT_SHAPES.items():
        bt_check(f"{n} n={bt_in[n].numel()} W={W} (main path)", bt_in[n], W,
                 out=bt_out[n])
    timing = {}
    for n, (_, W, _) in BT_SHAPES.items():
        small = n.startswith("cnn")
        timing[n] = t = time_bt(bt_in[n], W, iters=100 if small else 20,
                                plain_iters=20 if small else 3, graph=small)
        print(f"[kernel] block_topk timing, {n} (n={bt_in[n].numel()}, W={W}"
              f"{', CUDA graphs, L2-warm' if small else ''}): kernel "
              f"{t['ms'] * 1e3:.2f} us/launch ({t['ms_runs'][0] * 1e3:.2f}, "
              f"{t['ms_runs'][1] * 1e3:.2f}), plain {t['plain_ms'] * 1e3:.1f} "
              f"us, torch.topk {t['library_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
              f"{t['bytes'] / 1e6:.2f} MB) | {card}")
    return {"max_abs_err": 0.0, "timing": timing}


def build_all() -> dict:
    """Build every kernel from this checkout, one nvcc per source, all
    started together."""
    libs = {"flash_decode": fd_ops.library, "fused_compress": tk_ops.library,
            "block_topk": tk_ops.block_topk_library,
            "flash_attention": fa_ops.library, "ssd_scan": ssd_ops.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libs)) as ex:
        futs = {name: ex.submit(fn) for name, fn in libs.items()}
        built = {name: f.result() for name, f in futs.items()}
    for name, b in built.items():
        regs = sorted({ln.strip().split("info    : ")[-1]
                       for ln in b.log.splitlines() if "registers" in ln})
        print(f"[build] {b.path.name}: nvcc {b.seconds:.2f} s | "
              + "; ".join(regs))
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs "
              "on a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    name = runtime.require_hopper("cuda")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {name} | {card}")
    built = build_all()
    kern = phase_kernels(card)
    fused = phase_fused_kernel(card)
    srv = phase_serve(card)
    train = phase_train(card, fused["demo"]["ms"])
    lm = phase_reduce_lm(card)
    main_api = phase_api(card)
    fa = phase_flash_attention(card, main_api)
    ssd = phase_ssd(card, main_api)
    bt = phase_block_topk(card, main_api)
    launches = main_api.pop("launches")
    del main_api
    demo = fused["demo"]
    fa_t = fa["timing"]["mlitb-lm-100m prefill"]
    bt_t = bt["timing"]["lm f32"]
    rows = [
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/flash_decode.py:47",
         "design": "split-KV (32-key tiles across pages, 3-stage cp.async "
                   "ring) + combine kernel",
         "launches": srv["launches"], "max_abs_err": kern["max_abs_err"],
         "max_abs_err_bf16": kern["max_abs_err_bf16"],
         "max_row_rel_err_bf16": kern["max_row_rel_err_bf16"],
         "row_rel_tol_bf16": ROW_TOL_BF16,
         "ms": kern["ms"], "ms_eager": kern["ms_eager"],
         "plain_ms": kern["plain_ms"],
         "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
         "library_ms": kern["library_ms"]},
        {"name": "fused_compress", "route": "cuda",
         "source": "src/repro_torch/kernels/topk_compress/topk_compress.cu",
         "replaces": "src/repro/kernels/topk_compress/topk_compress.py:51",
         "launches": train["launches"],
         "max_abs_err": max(fused["max_abs_err"], lm["max_abs_err"]),
         "ms": demo["ms"], "plain_ms": demo["plain_ms"],
         "bound_ms": demo["bound_ms"], "bound_by": demo["bound_by"],
         "library_ms": demo["library_ms"]},
        {"name": "block_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/topk_compress/block_topk.cu",
         "replaces": "src/repro/kernels/topk_compress/topk_compress.py:22",
         "launches": launches["block_topk"],
         "max_abs_err": bt["max_abs_err"], "ms": bt_t["ms"],
         "plain_ms": bt_t["plain_ms"], "bound_ms": bt_t["bound_ms"],
         "bound_by": bt_t["bound_by"], "library_ms": bt_t["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:32",
         "design": "bf16 D 64/128: wgmma, TMA producer warp + 2 consumer "
                   "warpgroups, 3-4-stage mbarrier ring; else mma.sync "
                   "(bf16) / 3xTF32 (f32), 2-stage cp.async K/V",
         "launches": launches["flash_attention"],
         "max_abs_err": fa["max_abs_err"],
         "max_abs_err_bf16": fa["max_abs_err_bf16"],
         "max_row_rel_err_bf16": fa["max_row_rel_err_bf16"],
         "row_rel_tol_bf16": ROW_TOL_BF16, "ms": fa_t["ms"],
         "plain_ms": fa_t["plain_ms"], "bound_ms": fa_t["bound_ms"],
         "bound_by": fa_t["bound_by"], "library_ms": fa_t["library_ms"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:25",
         "design": "chunk states (wgmma) + C B^T once per (b, chunk) "
                   "(mma.sync), state pass, chunk scan (wgmma); 3xTF32",
         "launches": launches["ssd_scan"], "max_abs_err": ssd["max_abs_err"],
         "max_abs_err_bf16": ssd["max_abs_err_bf16"],
         "max_row_rel_err_bf16": ssd["max_row_rel_err_bf16"],
         "row_rel_tol_bf16": ROW_TOL_BF16,
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "bound_f32_ms": ssd["bound_f32_ms"],
         "library_ms": ssd["library_ms"], "ms_b1": ssd["b1"]["ms"],
         "plain_ms_b1": ssd["b1"]["plain_ms"],
         "bound_ms_b1": ssd["b1"]["bound_ms"]},
    ]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": {k: b.seconds for k, b in built.items()},
         "ptxas": {k: b.log for k, b in built.items()}, "kernel": kern,
         "fused_compress": fused, "serve": srv, "train": train,
         "reduce_lm": lm, "api_launches": launches, "flash_attention": fa,
         "ssd_scan": ssd, "block_topk": bt,
         "total_s": time.perf_counter() - t_start},
        indent=1, default=str))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
