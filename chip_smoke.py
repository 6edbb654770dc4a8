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
   elastic-SGD demo's shape, and the CUDA route refusing block_w 2048
   (the plain version takes it); then each kernel's time per launch (CUDA
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
4b. serve-spec (slice 8) — the same engine and schedule with speculative
   decoding: a full-width 1-layer draft from seed 2 proposes 4 tokens a
   round (window 32) and one verify dispatch checks them; streams equal
   the flash stream of phase 4 under the near-tie rule, flash_decode
   launched 0 times (counters reset just before, read just after);
   drafted / accepted / rounds, verify dispatches against phase 4's
   decode steps, ms per round (the draft's and each verify dispatch's
   beside) against phase 4's ms per decode step, tokens/s. Then a perfect draft (the served params,
   window 64) on 16 requests of <= 60 tokens: accepted / drafted >= 0.95,
   streams equal the plain engine's on the same schedule, fewer verify
   dispatches than its decode steps;
4c. oneshot (slice 8) — ``serve_batch`` (prefill + lockstep decode over a
   kpos-tagged cache) on 8 prompts of 64 tokens, 32 generated: tokens
   equal the dense-slot engine's (flash decode, 8 x 128) under the
   near-tie rule; prefill ms and median ms per lockstep decode step;
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
7. train LM (slice 6) — ``python -m repro_torch.launch.train --simulate``'s
   path: ``build_training``'s fleet trains ``mlitb-lm-100m`` at full width
   (random weights from seed 0, AdaGrad, the fused top-k reduce) for 8
   iterations with CUDA-event timers around each worker's forward and
   backward, the reduce step, its stable sort, segment-sum and AdaGrad:
   every loss finite and the last below the first; then at
   ``mlitb-lm-100m.reduced()`` on the card and on the CPU in this
   process: the plain run (events, worker counts, vectors and wire bytes
   equal, loss within 1e-3 relative at every iteration), a chaos run
   (a NaN and a garbage fault profile on one worker, plain SGD,
   guardrails on: per-iteration quarantines and rollbacks equal) and an
   adaptive-keep run (blocktopk at block_w 128, three uplinks, the
   per-worker keep controller: per-worker keeps and wire bytes equal,
   ``fused_compress`` launched once per reduce step on the card);
8. train-serve (slice 7) — ``run_train_serve``, the live train->serve
   loop, at ``mlitb-lm-100m``'s full width: 12 iterations of the churny
   fleet (AdaGrad lr 0.003, a publish every 2) hot-swapping into the
   paged engine (16-token pages, 16 slots x 256, prompt cap 64, flash
   decode, greedy) while 64 requests of the train-serve launcher's shape
   arrive at 30 rps from 1 s before the publish of step 4 (its clock
   read from a training-only pass of the same seeded loop); the launch
   counters reset just before and read just after: flash_decode once
   per layer per version per decode step, at least one decode step over
   two versions, every reduced loss finite and falling; every completion
   replayed solo under its pinned version on the plain decode path
   (streams equal up to the near-tie rule); host ms per iteration, wall
   ms per single- and mixed-version decode step, host us per swap, peak
   memory, and the cost model's simulated tokens/s and p50/p95;
9. train-serve-small — the same loop at ``mlitb-lm-100m.reduced()`` on
   the card and on the CPU with a burst overloading a 2-slot engine and
   a 4-deep ``drop_oldest`` queue with an admission deadline: training
   events and wire bytes, publishes, sheds, versions served and every
   completion's clock equal; the sampler card = CPU on one logits tensor
   at T 0.8, top-k 20 and 1 (top-k 1 = argmax); a TrainState written on
   the card after 4 iterations, reloaded and resumed for 4 more equal to
   the uninterrupted run bit for bit (else the phase names where they
   part), and an engine seeded from it serving what the loop's params
   serve; then the loop again with speculative decoding (k 2, the served
   arch at init from seed 2, a burst opening before the first publish)
   on the card and the CPU: publishes, sheds, completion clocks and the
   speculative counters equal, token streams equal under the near-tie
   rule (each request against its pinned version), at least one step on
   the card verifying two versions, no flash_decode launch;
9b. hier (slice 9) — ``python -m repro_torch.launch.train --simulate
   --regions 4``'s path (``run_hierarchy``): ``mlitb-lm-100m`` at full
   width (depth not cut) through 4 regional sub-masters, each over
   ``build_training``'s four-worker fleet and a quarter of the data, H 4,
   8 steps = 2 outer steps of top-k 0.25 WAN gossip, AdaGrad lr 0.003:
   every region's loss finite where a reduce ran, every outer loss
   finite, the WAN bytes exactly 8 k (R - 1) R per outer step, the spread
   finite, the consensus unflattening to the model's shapes; host ms per
   inner iteration, ms per outer exchange (CUDA events), WAN share, peak
   memory;
9c. hier-small — that hierarchy at ``mlitb-lm-100m.reduced()`` on the
   card and on the CPU, region r1 parked before outer step 2 and rejoined
   before 3: every OuterLog's clock, vectors, WAN bytes, region steps and
   events and every region's iteration events, wire bytes and keeps
   equal, losses and params within 1e-3 relative; a two-tier TrainState
   written after 2 outer steps and resumed equal to the uninterrupted
   card run bit for bit; ``serving_params_from_train_state`` =
   ``consensus_flat``; then sub-masters on the blocktopk channel (1/32,
   block_w 32), card = CPU, ``fused_compress`` launched once per region
   per reduce step (counters reset just before, read just after);
9d. randk — the fused reducer's randk branch over the LM's flat buffer
   (4 seeded workers, frac 1/128, 3 steps): k distinct indices per row,
   scatter(vals) + res == g + r bit for bit, new masks each step, the
   card's scores and picks equal to the CPU's on the first 2^22
   entries; ms per reduce step, peak memory;
9e. dense-reduce — ``MasterReducer(fused=False)`` at the reduced LM:
   uncompressed within 1e-5 of the fused path; topk, blocktopk and randk
   channels card = CPU in masks and wire bytes bit for bit, params
   within 1e-6;
9f. moe (slice 10) — ``llama4-scout-17b-a16e`` at full width (d 5120,
   40/8 heads of 128, 16 experts top-1 + the shared expert, vocab
   202 048, bf16; depth cut to 4 of 48 layers, ~21.8 GB) through the
   paged engine (16-token pages, 16 x 256) on
   ``launch.serve``'s schedule sized to 256 (32 requests, seed 1) with
   flash decode: flash_decode launched 4 x decode dispatches (counters
   reset just before, read just after); the schedule again, flash and
   plain decode, recording each decode step's top-2 logits and every
   layer's router top-2 probabilities: streams equal up to the first
   flip, which must be a near tie in both runs (a token flip: top-2
   logit gaps < 0.1; a routing flip: router gaps < 1e-2), over a
   nonzero count of tokens, drift printed; the kernel on the captured
   live step's every layer against its plain version (3e-2, 2^-6 a
   row) and timed there beside its bound, plain version and SDPA; ms
   per decode step, tokens/s, init seconds, peak memory;
9g. moe-small — ``llama4-scout-17b-a16e.reduced()`` and
   ``arctic-480b.reduced()`` (top-2, dense residual), f32: init equal on
   card and CPU; engine streams card = CPU, dense and paged; the sort
   dispatch = the einsum one; a dense and a MoE 1-layer draft = the
   greedy stream; capacity factor 1.0 (tokens drop) card = CPU, drop
   counts equal;
9h. ssm / hybrid — ``mamba2-780m`` (48 layers, d 1536) and ``zamba2-7b``
   (13 supers of 5 SSM + 1 attention, 3 tail layers, d 3584) at full
   width and depth through the launcher's single-shot path
   (``_serve_oneshot``: 4 x 24 prompts, 12 generated): in bf16 timed
   (prefill ms, ms per lockstep step, peak memory) with its drift from
   the growing forward printed; in float32 the tokens = a cacheless
   greedy ``forward`` over the growing sequence up to the first near
   tie (gaps < 1e-2; the recurrent decode with its conv ring against
   the chunked scan);
9i. ssm-small — both ``.reduced()``, f32: single-shot tokens card = CPU,
   logits within 1e-4;
9j. vlm / audio (slice 11) — ``paligemma-3b`` (18 layers, d 2048, 8/1
   heads of 256, 256 patch tokens, vocab 257 216, tied head) and
   ``whisper-large-v3`` (32 encoder + 32 decoder layers, d 1280, 20
   heads of 64, 1500 frames, vocab 51 866) at full width and depth, as
   9h, with the launcher's random patch / frame embeddings (the vision
   tower and the audio frontend are stubs): bf16 timed, float32 tokens =
   the growing ``forward(prefix= / frames=)`` (the encoder re-run every
   step) up to the first near tie (gaps < 1e-2); the tree's parameter
   count;
9k. c7-small — both ``.reduced()``, f32: ``forward`` logits card = CPU
   within 1e-4, single-shot tokens equal and logits within 1e-4; then
   the VLM's ragged decode steps, 4 steps from a ragged prefix-offset
   prefill, the flash arm (``decode_step_ragged(flash=True)`` over the
   dense slot cache and ``decode_step_ragged_paged_flash`` over a page
   pool) against the plain arm on the same tokens: live rows' logits and
   the caches within 2e-5, the first layer's cache bit for bit;
   flash_decode launched once per layer per step (counters reset just
   before, read just after);
9l. mesh-train (slice 12) — ``python -m repro_torch.launch.train``
   without ``--simulate`` (``examples/train_e2e.py``'s ``100m`` preset):
   ``main`` in this process trains ``mlitb-lm-100m`` at full width
   through ``ElasticMeshSGD`` (300 steps of 8 x 256, 4 virtual workers,
   worker 1 leaving at step 100 and rejoining at 200, AdaGrad lr 0.003,
   the counters reset just before and read just after: no kernel
   launched): every loss finite, tokens exactly 2048 / 1536 at 4 / 3 live
   workers, the last 20 steps' mean loss below the first 20's; the
   research closure it writes reloads to the trained params bit for bit
   and ``serve_batch`` (8 x 32 prompts, 16 tokens) serves the same tokens
   from both; ms per step (CUDA events and the host clock ending in the
   metrics' host copy), tokens/s, peak memory; the reference's default
   lr (AdaGrad 0.05) for 20 steps, printed, not gated; remat against
   none, 10 steps each (ms, peak, losses within 1e-4); then at
   ``.reduced()`` card against CPU with sgd: the engine under leave /
   join (masks, tokens and live counts equal, losses and params within
   1e-4 relative) and 2 ``build_train_step`` steps for one config per
   family (losses within 1e-4 relative, aux and params within 1e-4);
9m. dist-collectives (slice 13) — one ``torch.distributed`` world of 4
   gloo ranks on the card (``repro_torch.distributed.world``, spawned
   after kernel 3 was built), mesh (pod 2, data 2):
   ``weighted_psum_reduce`` and ``hierarchical_weighted_reduce`` within
   1e-6 of the one-process weighted mean; ``compressed_reduce`` over
   ``mlitb-lm-100m``'s 100 682 496-entry flat buffer at block 128 with
   NaN, signed-zero and tie blocks: on every rank the sparsified payload
   equal bit for bit to kernel 3's plain route on the same card tensors
   (and the kernel's output to its plain version's), sent + residual =
   corrected, the reduced result within 1e-6 of the one-process sum,
   kernel 3 launched once per rank (counters reset just before, read
   just after), the wire bytes counted;
9n. mesh-dist — in the same world, ``ElasticMeshSGD(jit_kwargs=dict(
   in_shardings=, out_shardings=))`` trains ``mlitb-lm-100m`` at full
   width on mesh (data 2, model 2): 8 x 256 from ``data_stream``, 4
   workers, worker 1 away for steps 5-9, 15 sgd steps (each collective
   timed after a sync), then 10 AdaGrad steps at lr 0.003 (timed, nothing
   synced): every rank the same metrics; tokens and live counts equal to
   the single-device engine's on the card, losses and the gathered
   params within 1e-5 relative; then one sgd step at lr 1e4, whose
   update dwarfs the params: that update within 1e-5 of the
   single-device one per leaf (f32's rounding of the params hides small
   updates, so the 15-step update's difference is printed, not gated);
   each rank's stored bytes and wire bytes
   per step equal ``run_dryrun``'s; no kernel launched; ms per step, the
   collectives' share (the gathers' and the activation all-reduces' host
   ms apart), peak memory per rank. Since slice 14 the step splits its
   compute over ``model`` (heads, FF, vocab; ``tensor_parallel``) and
   gathers each split leaf over ``data`` only;
9p. mesh-moe (slice 14) — first, in this process, the single-device
   engine trains ``llama4-scout-17b-a16e`` at full width cut to 1 of 48
   layers (bf16, 8 x 256, 3 sgd steps at lr 0.01) on the card, and the
   ``.reduced()`` f32 model (8 x 32, 6 sgd steps at lr 0.1, worker 2
   away for steps 3-4) with each MoE impl on the card and on the CPU;
   then in the same world as mesh-dist the sharded engine runs both on
   (data 2, model 2), a batch split of 2, experts split over ``model``:
   every rank the same metrics; full width: losses within 2e-2
   relative and aux within 1e-2 of the single-device engine's (bf16,
   PR 20's rule), stored and wire bytes per rank = ``run_dryrun``'s,
   ms per step with the gathers' and activation all-reduces' host ms,
   peak memory per rank; reduced: losses and aux within 1e-5 of both
   single-device engines, the gathered params within 1e-5 (per leaf
   ``||a - b|| / ||b||``); no kernel launched;
9o. mesh-nccl — a NCCL world of ``torch.cuda.device_count()`` ranks, one
   card each, 10 of those sgd steps: within 1e-6 of the single-device
   engine, and whether bit for bit;
10. kernel API (slice 3) — the port's public kernel API
   (``repro_torch.kernels``) at full width, with the launch counters
   reset just before and read just after: ``flash_attention`` over
   ``mlitb-lm-100m``'s prefill (16 slots x 512 tokens, f32) and
   ``qwen3-4b``'s heads at 4096 tokens (bf16), ``ssd_scan`` at
   ``mamba2-780m``'s widths (B 4, S 2048, f32), ``block_topk`` over
   ``mlitb-lm-100m``'s flat buffer (f32 and bf16) and the conv net's;
11. flash_attention, ssd_scan, block_topk — each kernel against its plain
   PyTorch version: the JAX kernel tests' cases and the edge cases
   (S != T, fully masked rows, no keys at all, ragged non-causal keys,
   D = 256, sliding windows at full-width heads, the LM's heads in bf16;
   bf16 also row by row; Q not a power of two, bf16, N = 64, one chunk,
   S = chunk + 1, hd 32 and 128, N 4 and 12, a call cut into windows of
   chunks; NaN / signed-zero / infinity / tie rows, W > 1024), then the
   full-width outputs of phase 10 (and the scan at one sequence of
   ``mamba2-780m``); then each kernel's time per launch beside its plain
   version's, a library yardstick's (SDPA; ``torch.topk``; none for the
   scan) and the least time the card could take;
12. a ``{"kernels": [...]}`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. Imports ``torch``,
``numpy`` and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AdaptiveFracController,  # noqa: E402
                              AdaptiveScheduler, GradientCompressor,
                              GuardrailConfig, HierarchyConfig, JoinEvent,
                              MasterEventLoop, MasterReducer, TrainingConfig,
                              UploadDataEvent, flat_spec)
from repro_torch.core.closure import ResearchClosure, torchify  # noqa: E402
from repro_torch.core.compression import (randk_indices,  # noqa: E402
                                          randk_scores)
from repro_torch.core.flatbuf import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.guardrails import make_lm_probe  # noqa: E402
from repro_torch.core import reducer as reducer_mod  # noqa: E402
from repro_torch.core import simulation as sim  # noqa: E402
from repro_torch.core.config import DeadlineConfig  # noqa: E402
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
from repro_torch.core.mesh_engine import ElasticMeshSGD  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
import repro_torch.distributed.world as dist_world  # noqa: E402
from repro_torch.launch.dryrun import run_dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.elastic_sgd import run_demo  # noqa: E402
import repro_torch.launch.train as train_mod  # noqa: E402
from repro_torch.launch.train import run_hierarchy, run_lm  # noqa: E402
from repro_torch.launch.train_serve import (build_training,  # noqa: E402
                                            run_train_serve)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
import repro_torch.launch.serve as serve_mod  # noqa: E402
import repro_torch.optim as optim  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                    make_train_state)
from repro_torch.optim import adagrad, sgd  # noqa: E402
from repro_torch.models.attention import _pow2_kv_block  # noqa: E402
from repro_torch.serving import (PagingConfig, ServeRequest,  # noqa: E402
                                 ServingConfig, ServingEngine,
                                 SpeculativeConfig, generate_requests)

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
          f"P={P}, {live_tok} live tokens, {str(q.dtype)[6:]}): kernel "
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


def timed_call(fn, rec: list):
    """``fn`` recording its host seconds in ``rec``; the callers' calls
    end in a device-to-host copy, so the clock sees the device's work."""
    def call(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        rec.append(time.perf_counter() - t0)
        return out
    return call


def synced_call(fn, rec: list):
    """``fn`` recording in ``rec`` the seconds from a device sync before
    the call to one after it: the call's host issue and device work."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        rec.append(time.perf_counter() - t0)
        return out
    return call


def serve(params, cfg, reqs, kernel: str, speculative=None,
          draft_s: list = None, verify_s: list = None):
    """The paged engine of ``[serve]``; host seconds of each decode step
    (or, speculative, each round: draft plus verify; ``draft_s`` and
    ``verify_s`` take the draft's and each verify dispatch's seconds)."""
    eng = ServingEngine(params, cfg, serving=ServingConfig(
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, decode_kernel=kernel,
        paging=PagingConfig(page_size=PAGE, prefix_reuse=True),
        speculative=speculative), device="cuda")
    step_s = []
    if speculative is None:
        eng._step_decode = timed_call(eng._step_decode, step_s)
    else:
        eng._step_speculative = timed_call(eng._step_speculative, step_s)
        if draft_s is not None:
            draft = eng._draft
            eng._draft = timed_call(lambda *a: draft(*a).cpu(), draft_s)
        if verify_s is not None:
            eng._programs = dataclasses.replace(
                eng._programs,
                verify=synced_call(eng._programs.verify, verify_s))
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


def streams(stats) -> dict:
    return {c.rid: c.tokens.tolist() for c in stats.completions}


def near_tie_compare(params, cfg, prompts: dict, got: dict, want: dict,
                     tag: str) -> tuple:
    """``got`` against ``want`` (rid -> tokens), token by token: a
    differing token passes only where the plain path's top-2 gap after
    ``want``'s prefix is below GAP_TIE, and that request is then not
    compared further. Returns (tokens compared, near-ties)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag} answered {sorted(got)}, expected "
                             f"{sorted(want)}")
    compared, ties = 0, []
    for rid in sorted(want):
        if len(got[rid]) != len(want[rid]):
            raise AssertionError(f"{tag} request {rid}: {len(got[rid])} "
                                 f"tokens, expected {len(want[rid])}")
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                seq = list(prompts[rid]) + want[rid][:i]
                gap = top2_gap(params, cfg, seq)
                if gap >= GAP_TIE:
                    raise AssertionError(
                        f"{tag} request {rid} token {i}: {a} vs {b}, plain "
                        f"top-2 gap {gap:.3e} >= {GAP_TIE}")
                ties.append((rid, i, gap))
                print(f"{tag} request {rid} step {i}: near-tie (top-2 gap "
                      f"{gap:.2e}); not compared further")
                break
            compared += 1
    return compared, ties


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
    got = streams(st)
    compared, ties = near_tie_compare(
        params, cfg, {r.rid: r.prompt for r in reqs}, got, streams(sp),
        "[serve] flash vs plain")
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
        "near_ties": ties, "p50_s": st.p50_latency, "p95_s": st.p95_latency,
        "streams": got}
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
# slice 8: speculative decoding and the single-shot path
# ---------------------------------------------------------------------------
# the launcher's draft: a 1-layer sibling of the served model from seed 2
SPEC_K, SPEC_WINDOW = 4, 32
# the perfect draft (the served params) sees the whole history: every
# prompt + generation <= PERFECT_WINDOW - SPEC_K
PERFECT_WINDOW, PERFECT_REQUESTS = 64, 16
ONESHOT_B, ONESHOT_P, ONESHOT_GEN = 8, 64, 32


def perfect_schedule(cfg):
    return generate_requests(
        PERFECT_REQUESTS, rate_rps=60.0, vocab_size=cfg.vocab_size,
        prompt_rng=(4, 24), gen_short=(2, 12), gen_long=(24, 36), seed=3)


def phase_serve_spec(card: str, srv: dict, serve_streams: dict) -> dict:
    cfg = get_config(ARCH)
    params = tf.init_params(cfg, seed=0, device="cuda")
    reqs = schedule(cfg)
    prompts = {r.rid: r.prompt for r in reqs}
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1)
    spec = SpeculativeConfig(
        draft_params=tf.init_params(dcfg, seed=2, device="cuda"),
        draft_cfg=dcfg, k=SPEC_K, window=SPEC_WINDOW)
    serve(params, cfg, [dataclasses.replace(r, max_new=8) for r in reqs[:2]],
          "flash", spec)                                  # warm-up
    # (a) the launcher's draft on [serve]'s schedule
    runtime.reset_counters()
    draft_s, verify_s = [], []
    eng, st, round_s = serve(params, cfg, reqs, "flash", spec, draft_s,
                             verify_s)
    torch.cuda.synchronize()
    launches = fd_ops.COUNTER.count
    if launches:
        raise AssertionError(f"[serve-spec] flash_decode launched "
                             f"{launches} times in a speculative run")
    compared, ties = near_tie_compare(params, cfg, prompts, streams(st),
                                      serve_streams,
                                      "[serve-spec] speculative vs [serve]")
    if st.drafted == 0 or eng.verify_buckets_seen != [(MAX_BATCH, 8)]:
        raise AssertionError(f"[serve-spec] drafted {st.drafted}, verify "
                             f"buckets {eng.verify_buckets_seen}")
    # (b) a perfect draft: the served params, whole history in the window
    preqs = perfect_schedule(cfg)
    perfect = SpeculativeConfig(draft_params=params, draft_cfg=cfg,
                                k=SPEC_K, window=PERFECT_WINDOW)
    _, pst, _ = serve(params, cfg, preqs, "flash", perfect)
    _, pbase, _ = serve(params, cfg, preqs, "flash")
    share = pst.accepted / max(pst.drafted, 1)
    pcompared, pties = near_tie_compare(
        params, cfg, {r.rid: r.prompt for r in preqs}, streams(pst),
        streams(pbase), "[serve-spec] perfect draft vs plain decode")
    if share < 0.95 or pst.decode_dispatches >= pbase.decode_dispatches:
        raise AssertionError(
            f"[serve-spec] perfect draft: accepted {pst.accepted}/"
            f"{pst.drafted}, {pst.decode_dispatches} verify dispatches "
            f"against {pbase.decode_dispatches} decode steps")
    res = {"drafted": st.drafted, "accepted": st.accepted,
           "rounds": st.spec_rounds, "verify_dispatches": st.decode_dispatches,
           "serve_decode_steps": srv["decode_steps"],
           "round_ms": 1e3 * float(np.mean(round_s)),
           "round_ms_median": 1e3 * float(np.median(round_s)),
           "draft_ms_median": 1e3 * float(np.median(draft_s)),
           "verify_ms_median": 1e3 * float(np.median(verify_s)),
           "verify_ms": 1e3 * float(np.mean(verify_s)),
           "serve_decode_step_ms": srv["decode_step_ms"],
           "tokens_per_s": st.tokens_per_s,
           "serve_tokens_per_s": srv["tokens_per_s"],
           "flash_decode_launches": launches, "tokens_compared": compared,
           "near_ties": ties, "perfect_drafted": pst.drafted,
           "perfect_accepted": pst.accepted, "perfect_share": share,
           "perfect_verify_dispatches": pst.decode_dispatches,
           "perfect_decode_steps": pbase.decode_dispatches,
           "perfect_tokens_per_s": pst.tokens_per_s,
           "perfect_plain_tokens_per_s": pbase.tokens_per_s,
           "perfect_compared": pcompared, "perfect_near_ties": pties}
    print(f"[serve-spec] {ARCH} full width, paged ps={PAGE}, {st.n_requests} "
          f"requests, 1-layer draft (seed 2) k {SPEC_K} window "
          f"{SPEC_WINDOW}: drafted {st.drafted}, accepted {st.accepted}, "
          f"{st.spec_rounds} row rounds, {st.decode_dispatches} verify "
          f"dispatches against [serve]'s {srv['decode_steps']} decode steps; "
          f"{res['round_ms']:.2f} ms per round (median "
          f"{res['round_ms_median']:.2f}; draft {res['draft_ms_median']:.2f}"
          f", verify dispatch {res['verify_ms_median']:.2f}, medians)"
          f" against [serve]'s {srv['decode_step_ms']:.2f} ms per decode "
          f"step; {st.tokens_per_s:.1f} tok/s (serve "
          f"{srv['tokens_per_s']:.1f}); flash_decode launches {launches}; "
          f"streams equal [serve]'s on {compared} tokens, {len(ties)} "
          f"near-ties | {card}")
    print(f"[serve-spec] perfect draft (the served params, window "
          f"{PERFECT_WINDOW}), {len(preqs)} requests of <= 60 tokens: "
          f"accepted {pst.accepted}/{pst.drafted} ({100 * share:.1f}%), "
          f"{pst.decode_dispatches} verify dispatches against "
          f"{pbase.decode_dispatches} decode steps; {pst.tokens_per_s:.1f} "
          f"tok/s against {pbase.tokens_per_s:.1f}; streams equal on "
          f"{pcompared} tokens, {len(pties)} near-ties | {card}")
    return res


def phase_oneshot(card: str) -> dict:
    cfg = get_config(ARCH)
    params = tf.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(4)
    prompts = rng.randint(0, cfg.vocab_size,
                          size=(ONESHOT_B, ONESHOT_P)).astype(np.int32)
    serve_mod.serve_batch(params, cfg, prompts[:2], 2)     # warm-up
    times = {"prefill": [], "decode": []}
    prefill, decode_step = serve_mod.tf.prefill, serve_mod.tf.decode_step
    serve_mod.tf.prefill = synced_call(prefill, times["prefill"])
    serve_mod.tf.decode_step = synced_call(decode_step, times["decode"])
    try:
        t0 = time.perf_counter()
        out = serve_mod.serve_batch(params, cfg, prompts, ONESHOT_GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve_mod.tf.prefill, serve_mod.tf.decode_step = prefill, decode_step
    if out.shape != (ONESHOT_B, ONESHOT_GEN) \
            or out.device != params["embed"].device \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"[oneshot] serve_batch gave {out.shape} on "
                             f"{out.device}")
    eng = ServingEngine(params, cfg, serving=ServingConfig(
        max_batch=ONESHOT_B, max_seq=128, decode_kernel="flash"),
        device="cuda")
    st = eng.run_closed_loop([ServeRequest(rid=i, prompt=prompts[i],
                                           max_new=ONESHOT_GEN)
                              for i in range(ONESHOT_B)])
    got = {i: out[i].tolist() for i in range(ONESHOT_B)}
    compared, ties = near_tie_compare(
        params, cfg, dict(enumerate(prompts)), got, streams(st),
        "[oneshot] serve_batch vs engine")
    res = {"prefill_ms": 1e3 * times["prefill"][0],
           "decode_ms_median": 1e3 * float(np.median(times["decode"])),
           "decode_steps": len(times["decode"]), "wall_s": wall,
           "tokens_per_s": ONESHOT_B * ONESHOT_GEN / wall,
           "tokens_compared": compared, "near_ties": ties}
    print(f"[oneshot] {ARCH} full width, serve_batch {ONESHOT_B} x "
          f"{ONESHOT_P} prompt tokens, {ONESHOT_GEN} generated: prefill "
          f"{res['prefill_ms']:.2f} ms, lockstep decode "
          f"{res['decode_ms_median']:.2f} ms median over "
          f"{len(times['decode'])} steps, {wall:.2f} s in all "
          f"({res['tokens_per_s']:.1f} tok/s); tokens equal the dense "
          f"engine's (flash decode, {ONESHOT_B} x 128) on {compared}, "
          f"{len(ties)} near-ties | {card}")
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
    # the CUDA kernel's widest block is MAX_BLOCK_W (1024); wider blocks
    # (the CPU's plain version takes them) must be refused, not launched
    g = torch.ones(2, 5000, device="cuda")
    before = tk_ops.COUNTER.count
    try:
        tk_ops.fused_block_topk_batched(g, g, k=4, block_w=2048)
    except ValueError as e:
        if "block_w=2048" not in str(e) or "CUDA kernel" not in str(e):
            raise
    else:
        raise AssertionError("fused_compress took block_w=2048 on the card")
    if tk_ops.COUNTER.count != before:
        raise AssertionError("the refused block_w=2048 call launched")
    print("[kernel] fused_compress block_w=2048 on the card: refused "
          "(MAX_BLOCK_W 1024)")
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
    timer = StageTimer()
    with stage_timers(timer):
        opt = optim.adagrad(lr=0.02)            # its updates are timed
    red = MasterReducer(params, opt, GradientCompressor(
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
        with stage_timers(timer):
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
    stages = timer.ms()
    res = {"n": n, "launches": launches, "max_abs_err": err,
           "reduce_step_ms": [1e3 * x for x in step_s],
           "stage_ms": stages, "peak_mem_bytes": peak, **t}
    print(f"[reduce] {ARCH} flat buffer n={n}, 4 workers, W=128, k=1: 3 "
          f"reduce steps {', '.join(f'{1e3 * x:.2f}' for x in step_s)} ms "
          f"(in them: compressor "
          f"{', '.join(f'{x:.2f}' for x in stages['compress'])}, "
          f"segment-sum "
          f"{', '.join(f'{x:.2f}' for x in stages['segment-sum'])}, "
          f"adagrad {', '.join(f'{x:.2f}' for x in stages['adagrad'])}); "
          f"fused_compress launches {launches}; kernel {t['ms']:.3f} ms/"
          f"launch ({t['ms_runs'][0]:.3f}, {t['ms_runs'][1]:.3f}), plain "
          f"{t['plain_ms']:.3f} ms, torch.topk {t['library_ms']:.3f} ms, "
          f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}, "
          f"{t['bytes'] / 1e9:.3f} GB); peak mem {peak / 2**30:.2f} GiB "
          f"| {card}")
    return res


# ---------------------------------------------------------------------------
# slice 6: the simulated fleet trains mlitb-lm-100m
# ---------------------------------------------------------------------------
LM_STEPS = 10                # full-width iterations
# AdaGrad's first step moves every sent entry by lr: build_training's 0.1
# diverges the full-width LM (weights of std 0.02-0.04); 0.003 trains it
LM_LR = 0.003
# the same lr for the card-vs-CPU run at the reduced size: at 0.1 a top-k
# pick that rounding flips moves its entry by the whole step, and the
# two losses parted by 1.26e-3 relative by iteration 8
LM_SMALL_STEPS = 8           # each reduced-size run, card and CPU
# the adaptive-keep fleet's uplinks (bytes/s): with T 0.5 and comm_frac
# 0.5 they ask for about 8, 2 and 1 keeps per 128-entry block of the
# reduced LM's buffer
KEEP_UPLINKS = (8e5, 2e5, 5e4)


class StageTimer:
    """CUDA-event ranges by stage name, recorded on the current stream
    (no sync while the run goes on)."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        yield
        ev[1].record()
        self.events.setdefault(name, []).append(ev)

    def ms(self) -> dict:
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


@contextlib.contextmanager
def stage_timers(timer: StageTimer):
    """Times, for the runs inside the block: each worker's map step
    (``SimulatedCluster.compute``: the batch gather, forward, backward),
    the reducer's compressor kernel (blocktopk) or stable sort (topk),
    its segment-sum and every AdaGrad update of optimizers made by
    ``optim.adagrad``."""
    compute = sim.SimulatedCluster.compute
    compress = reducer_mod.fused_block_topk_batched
    sort = reducer_mod.stable_topk_indices
    segsum = reducer_mod._segment_sum
    make_adagrad = optim.adagrad

    def timed(name, fn):
        def inner(*a, **kw):
            with timer(name):
                return fn(*a, **kw)
        return inner

    def timed_adagrad(*a, **kw):
        opt = make_adagrad(*a, **kw)
        return optim.Optimizer(opt.name, opt.init,
                               timed("adagrad", opt.update))

    sim.SimulatedCluster.compute = timed("worker", compute)
    reducer_mod.fused_block_topk_batched = timed("compress", compress)
    reducer_mod.stable_topk_indices = timed("sort", sort)
    reducer_mod._segment_sum = timed("segment-sum", segsum)
    optim.adagrad = timed_adagrad
    try:
        yield
    finally:
        sim.SimulatedCluster.compute = compute
        reducer_mod.fused_block_topk_batched = compress
        reducer_mod.stable_topk_indices = sort
        reducer_mod._segment_sum = segsum
        optim.adagrad = make_adagrad


def same_lm_logs(gpu, cpu, what: str, loss_rtol=1e-3) -> float:
    """Card against CPU, iteration by iteration: events, workers, vectors,
    wire bytes (per worker too), quarantines and rollbacks equal; losses
    finite alike and within ``loss_rtol`` relative (None: not compared).
    Returns the largest relative loss difference."""
    rel = 0.0
    if len(gpu) != len(cpu):
        raise AssertionError(f"{what}: {len(gpu)} vs {len(cpu)} iterations")
    for a, b in zip(gpu, cpu):
        ka = (a.events, a.n_workers, a.vectors, a.wire_bytes,
              a.per_worker_wire_bytes, a.n_quarantined, a.rolled_back)
        kb = (b.events, b.n_workers, b.vectors, b.wire_bytes,
              b.per_worker_wire_bytes, b.n_quarantined, b.rolled_back)
        if ka != kb:
            raise AssertionError(f"{what} iteration {a.step}: card {ka} vs "
                                 f"cpu {kb}")
        if math.isfinite(a.loss) != math.isfinite(b.loss):
            raise AssertionError(f"{what} iteration {a.step}: loss "
                                 f"{a.loss} vs {b.loss}")
        if math.isfinite(b.loss):
            r = abs(a.loss - b.loss) / abs(b.loss)
            rel = max(rel, r)
            if loss_rtol is not None and r > loss_rtol:
                raise AssertionError(f"{what} iteration {a.step}: loss "
                                     f"{a.loss} vs {b.loss} ({r:.2e} rel)")
    return rel


def chaos_run(cfg, device):
    """``build_training``'s fleet with a NaN and a garbage fault profile
    on w1, plain SGD (AdaGrad's normalised step would absorb the
    garbage), guardrails on."""
    training = TrainingConfig(T=0.5, deadline=DeadlineConfig(quantile=0.5),
                              guardrails=GuardrailConfig())
    return run_lm(cfg, steps=LM_SMALL_STEPS, seed=0, device=device,
                  training=training, optimizer=sgd(lr=0.05),
                  fault_profiles={"w1": sim.FaultProfile(nan_p=0.25,
                                                         garbage_p=0.25)})


def keep_run(cfg, device):
    """The reduced LM on three uplinks with the per-worker keep
    controller and the blocktopk channel (block_w 128): every reduce is
    one ``fused_compress`` launch over the workers' ragged keeps.
    Returns (logs, reduce steps)."""
    (X, y), grad_fn = sim.make_lm_problem(cfg, seed=0, device=device)
    red = MasterReducer(tf.init_params(cfg, seed=0, device=device),
                        adagrad(lr=0.1), compressor=GradientCompressor(
                            "blocktopk", frac=1 / 8, block_w=128))
    cluster = sim.SimulatedCluster(grad_fn=grad_fn, data=(X, y),
                                   mode="real", seed=0, device=device)
    loop = MasterEventLoop(
        reducer=red, cluster=cluster,
        frac_controller=AdaptiveFracController(
            comm_frac=0.5, frac_min=1 / 2048, frac_max=0.12),
        scheduler=AdaptiveScheduler(T=0.5, prior_power=300.0,
                                    prior_bandwidth=6e4),
        training=TrainingConfig(T=0.5))
    loop.submit(UploadDataEvent(range(len(X))))
    for i, bw in enumerate(KEEP_UPLINKS):
        cluster.add_worker(f"w{i}", sim.DeviceProfile(
            f"up{i}", 300.0, 0.010, 0.20, uplink_bps=bw))
        loop.submit(JoinEvent(f"w{i}", capacity=len(X)))
    return loop.run(LM_SMALL_STEPS), red.step


def phase_train_lm(card: str) -> dict:
    cfg = get_config(ARCH)
    # -- full width: the launcher's run_lm, stages timed ------------------
    timer = StageTimer()
    runtime.reset_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with stage_timers(timer):
        run = run_lm(cfg, steps=LM_STEPS, seed=0, device="cuda", lr=LM_LR)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in runtime.COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    logs = run.logs
    losses = [lg.loss for lg in logs]
    # an iteration whose every reply missed the deadline reduces nothing
    # and has no loss (NaN, as in the JAX package): the first ones, while
    # the upload EWMA learns that an 80 MB message takes 6.4 s
    reduced = [lg for lg in logs if lg.n_workers > 0]
    for lg in logs:
        if (lg.n_workers > 0) != math.isfinite(lg.loss) or (
                lg.n_workers == 0 and (lg.n_late == 0 or lg.wire_bytes)):
            raise AssertionError(f"{ARCH} iteration {lg.step}: loss "
                                 f"{lg.loss}, {lg.n_workers} workers "
                                 f"reduced, {lg.n_late} late")
    first, last = reduced[0].loss, reduced[-1].loss
    if len(reduced) < 6 or not last < first:
        raise AssertionError(f"{ARCH} training losses {losses}: fewer than "
                             f"6 reduce steps, or the last not below the "
                             f"first")
    red = run.loop.reducer
    if red.flat_n != cfg.n_params() or red.step != len(run.reduce_ms) \
            or red.step != len(reduced):
        raise AssertionError(f"flat buffer {red.flat_n}, {red.step} reduce "
                             f"steps, {len(run.reduce_ms)} timed")
    # medians per call: the first iteration carries cuBLAS's set-up
    stage_ms = timer.ms()
    med = {k: float(np.median(v)) for k, v in stage_ms.items()}
    med["reduce"] = float(np.median(run.reduce_ms))
    iter_ms = [1e3 * x for x in run.iter_s]
    sort_share = med["sort"] / med["reduce"]
    full = {
        "iterations": len(logs), "n_params": red.flat_n,
        "w_cap": red._w_cap, "kmax": red.compressor.flat_k(red.flat_n),
        "host_ms_per_iter": iter_ms,
        "host_ms_median": float(np.median(iter_ms)),
        "reduce_ms": run.reduce_ms,
        "reduce_ms_median": float(np.median(run.reduce_ms)),
        "stage_ms": stage_ms, "stage_ms_median": med,
        "sort_share_of_reduce": sort_share, "loss": losses,
        "lr": LM_LR, "reduce_steps": red.step,
        "events": [lg.events for lg in logs],
        "workers": [lg.n_workers for lg in logs],
        "vectors": [lg.vectors for lg in logs],
        "wire_bytes": [lg.wire_bytes for lg in logs],
        "n_late": [lg.n_late for lg in logs],
        "sim_clock_s": run.loop.clock, "peak_mem_bytes": peak,
        "launches": launches}
    del run, red, logs, reduced
    gc.collect()            # the loop's reference cycles hold 10+ GB
    torch.cuda.empty_cache()
    print(f"[train-lm] {ARCH} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {full['n_params']} parameters), "
          f"{full['iterations']} iterations of build_training's fleet "
          f"(AdaGrad lr {LM_LR}), {full['reduce_steps']} reduce steps: "
          f"loss {first:.3f} -> {last:.3f} (all {losses}); host "
          f"ms/iteration "
          f"median {full['host_ms_median']:.1f} (range {min(iter_ms):.1f}-"
          f"{max(iter_ms):.1f}); reduce step median "
          f"{full['reduce_ms_median']:.1f} ms (range "
          f"{min(full['reduce_ms']):.1f}-{max(full['reduce_ms']):.1f}; "
          f"W_cap {full['w_cap']} x {full['n_params']}, kmax "
          f"{full['kmax']}); medians per call: worker map step "
          f"{med['worker']:.1f} ms ({len(stage_ms['worker'])} calls), "
          f"reduce step {med['reduce']:.1f} = sort {med['sort']:.1f} + "
          f"segment-sum {med['segment-sum']:.1f} + adagrad "
          f"{med['adagrad']:.1f} + the rest; the sort is "
          f"{100 * sort_share:.1f}% of the reduce step; workers "
          f"{full['workers']}, vectors {full['vectors']}, wire bytes "
          f"{full['wire_bytes']}, events {full['events']}; kernel launches "
          f"{launches}; peak mem {peak / 2**30:.2f} GiB | {card}")

    # -- reduced: card against CPU, plain / chaos / adaptive keep ---------
    small = cfg.reduced()
    gpu = run_lm(small, steps=LM_SMALL_STEPS, seed=0, device="cuda",
                 lr=LM_LR)
    cpu = run_lm(small, steps=LM_SMALL_STEPS, seed=0, device="cpu",
                 lr=LM_LR)
    rel = same_lm_logs(gpu.logs, cpu.logs, "reduced LM")
    chaos_gpu, chaos_cpu = chaos_run(small, "cuda"), chaos_run(small, "cpu")
    chaos_rel = same_lm_logs(chaos_gpu.logs, chaos_cpu.logs, "chaos",
                             loss_rtol=None)
    quar = [lg.n_quarantined for lg in chaos_gpu.logs]
    rolled = [lg.rolled_back for lg in chaos_gpu.logs]
    if sum(quar) == 0 or not any(rolled):
        raise AssertionError(f"chaos run: quarantines {quar}, rollbacks "
                             f"{rolled}: the guardrails were not exercised")
    runtime.reset_counters()
    keep_gpu, steps = keep_run(small, "cuda")
    torch.cuda.synchronize()
    keep_launches = tk_ops.COUNTER.count
    runtime.reset_counters()
    keep_cpu, _ = keep_run(small, "cpu")
    if tk_ops.COUNTER.count:
        raise AssertionError("the CPU keep run launched the kernel")
    keep_rel = same_lm_logs(keep_gpu, keep_cpu, "adaptive keep",
                            loss_rtol=None)
    if keep_launches == 0 or keep_launches != steps:
        raise AssertionError(f"fused_compress launched {keep_launches} "
                             f"times over {steps} reduce steps")
    rows = -(-small.n_params() // 128)
    keeps = [{w: b // 8 // rows for w, b in lg.per_worker_wire_bytes.items()}
             for lg in keep_gpu]
    if len(set(keeps[-1].values())) < 2:
        raise AssertionError(f"adaptive keep: per-block keeps {keeps}")
    res = {"full": full, "reduced_loss_rel": rel,
           "reduced_loss": [lg.loss for lg in gpu.logs],
           "reduced_cpu_loss": [lg.loss for lg in cpu.logs],
           "chaos_quarantined": quar, "chaos_rolled_back": rolled,
           "chaos_events": [lg.events for lg in chaos_gpu.logs],
           "chaos_loss_rel": chaos_rel, "keep_per_block": keeps,
           "keep_wire_bytes": [lg.wire_bytes for lg in keep_gpu],
           "keep_launches": keep_launches, "keep_reduce_steps": steps,
           "keep_loss_rel": keep_rel}
    print(f"[train-lm] {ARCH}.reduced() card vs CPU, {LM_SMALL_STEPS} "
          f"iterations each: plain run equal (loss within {rel:.1e} rel); "
          f"chaos run quarantines {quar}, rollbacks "
          f"{[int(x) for x in rolled]} equal (loss within {chaos_rel:.1e} "
          f"rel where finite); adaptive keep per-block keeps "
          f"{[sorted(k.values()) for k in keeps]} and wire bytes equal "
          f"(loss within {keep_rel:.1e} rel), fused_compress launches "
          f"{keep_launches} = reduce steps {steps} | {card}")
    return res


# ---------------------------------------------------------------------------
# slice 7: the live train->serve loop
# ---------------------------------------------------------------------------
# full width: run_train_serve's loop at the reference CLI's shape, on the
# paged engine with the flash-decode kernel; AdaGrad at LM_LR (the
# default 0.1 diverges the full-width LM)
TS_ITERS, TS_PUBLISH, TS_REQUESTS, TS_RATE = 12, 2, 64, 30.0
# at full width a reduce's 80 MB uploads take ~6.3 s of the fleet's
# clock, so publishes land ~14 s apart: the schedule opens TS_LEAD_S
# before the publish of step TS_CENTER_STEP (read from a training-only
# pass: serving never moves the training clock) so that requests in
# flight under the old version meet admissions under the new one
TS_CENTER_STEP, TS_LEAD_S = 4, 1.0
TS_SERVE = dict(max_batch=16, max_seq=256, prompt_cap=64, page_size=16)
TS_REPLAY_S = 60.0           # replay every completion within this budget
# reduced size, card against CPU: a burst overloads a 2-slot engine with
# a 4-deep queue, so requests shed both ways (displaced, deadline)
TS_SMALL_ITERS = 8
TS_SMALL_SERVE = dict(max_batch=2, max_seq=64, prompt_cap=16, page_size=8,
                      max_queue=4, shed_policy="drop_oldest",
                      admission_deadline=0.04)
TS_SMALL_LOAD = dict(n=64, rate=8.0, burst=(1.5, 0.8, 12.0))
# the speculative run's burst opens just before the first publish (1.37
# s on the fleet's clock), so rows of version 0 are still in flight when
# rows of version 2 are admitted: some rounds verify both versions
TS_SPEC_BURST = (1.3, 0.8, 12.0)
RESUME_AT, RESUME_MORE = 4, 4


def ts_requests(cfg, n: int, max_seq: int, rate: float, burst=None):
    """``launch.train_serve``'s request shape for ``max_seq``."""
    g_hi = max(2, max_seq // 4)
    return generate_requests(
        n, rate_rps=rate, vocab_size=cfg.vocab_size,
        prompt_rng=(4, max(8, max_seq - g_hi - 1)),
        gen_short=(2, max(3, g_hi // 2)), gen_long=(g_hi // 2 + 1, g_hi),
        burst=burst, seed=1)


@contextlib.contextmanager
def train_serve_timers(rec: dict):
    """Host clocks, for the runs inside the block: each training
    iteration (ending in a device sync), each engine decode step (one
    dispatch per live version; ends in a device-to-host copy) with its
    number of versions and, for mixed steps, the rids it served, and each
    ``swap_params``."""
    iteration = MasterEventLoop.iteration
    step_decode = ServingEngine._step_decode
    swap = ServingEngine.swap_params

    def timed_iteration(self):
        t0 = time.perf_counter()
        out = iteration(self)
        torch.cuda.synchronize()
        rec["iter_s"].append(time.perf_counter() - t0)
        return out

    def timed_decode(self, *a):
        live = [s for s in range(self.max_batch) if self._live[s]]
        vers = {self._slots[s].ver for s in live}
        rids = [self._slots[s].req.rid for s in live]
        t0 = time.perf_counter()
        out = step_decode(self, *a)
        rec["decode"].append((len(vers), time.perf_counter() - t0))
        if len(vers) > 1:
            rec["mixed_rids"].update(rids)
        return out

    def timed_swap(self, *a, **kw):
        t0 = time.perf_counter()
        out = swap(self, *a, **kw)
        rec["swap_s"].append(time.perf_counter() - t0)
        return out

    MasterEventLoop.iteration = timed_iteration
    ServingEngine._step_decode = timed_decode
    ServingEngine.swap_params = timed_swap
    try:
        yield
    finally:
        MasterEventLoop.iteration = iteration
        ServingEngine._step_decode = step_decode
        ServingEngine.swap_params = swap


def check_reduce_losses(logs, what: str) -> list:
    """Every iteration that reduced has a finite loss, the others none;
    the last reduced loss is below the first. Returns the losses."""
    reduced = [lg for lg in logs if lg.n_workers > 0]
    for lg in logs:
        if (lg.n_workers > 0) != math.isfinite(lg.loss):
            raise AssertionError(f"{what} iteration {lg.step}: loss "
                                 f"{lg.loss}, {lg.n_workers} workers")
    if len(reduced) < 2 or not reduced[-1].loss < reduced[0].loss:
        raise AssertionError(f"{what}: losses {[lg.loss for lg in logs]}: "
                             f"fewer than 2 reduces, or the last not below "
                             f"the first")
    return [lg.loss for lg in reduced]


def replay_completions(cfg, out, reqs, mixed: set) -> dict:
    """Replay completions solo on a fresh dense engine under their pinned
    version with the plain decode path; each greedy stream must equal the
    served one up to the near-tie rule. One completion per version and
    every one that shared a decode step with another version first, then
    the rest while the budget lasts."""
    by_rid = {r.rid: r for r in reqs}
    comps = sorted(out["stats"].completions, key=lambda c: c.rid)
    must, seen = [], set()
    for c in comps:
        if c.version not in seen or c.rid in mixed:
            must.append(c)
            seen.add(c.version)
    rest = [c for c in comps if c not in must]
    engines, replayed, ties, compared = {}, [], [], 0
    t0 = time.perf_counter()
    for c in must + rest:
        if c not in must and time.perf_counter() - t0 > TS_REPLAY_S:
            break
        params = out["versions"][c.version]
        if c.version not in engines:
            engines[c.version] = ServingEngine(
                params, cfg, serving=ServingConfig(
                    max_batch=1, max_seq=TS_SERVE["max_seq"],
                    prompt_cap=TS_SERVE["prompt_cap"],
                    decode_kernel="plain"), device="cuda")
        req = by_rid[c.rid]
        solo = engines[c.version].run_closed_loop([ServeRequest(
            rid=c.rid, prompt=req.prompt, max_new=req.max_new)])
        want = solo.completions[0].tokens.tolist()
        for i, (a, b) in enumerate(zip(c.tokens.tolist(), want)):
            if a != b:
                gap = top2_gap(params, cfg, list(req.prompt) + want[:i])
                if gap >= GAP_TIE:
                    raise AssertionError(
                        f"[train-serve] request {c.rid} (v{c.version}) "
                        f"token {i}: served {a} vs solo replay {b}, plain "
                        f"top-2 gap {gap:.3e} >= {GAP_TIE}: corrupted")
                ties.append((c.rid, i, gap))
                break
            compared += 1
        replayed.append(c.rid)
    return {"replayed": replayed, "n_completions": len(comps),
            "mixed_rids": sorted(mixed), "tokens_compared": compared,
            "near_ties": ties, "replay_s": time.perf_counter() - t0}


def phase_train_serve(card: str) -> dict:
    cfg = get_config(ARCH)
    loop_kw = dict(iterations=TS_ITERS, publish_every=TS_PUBLISH, T=0.5,
                   seed=0, lr=LM_LR, decode_kernel="flash", device="cuda",
                   **TS_SERVE)
    dry = run_train_serve(cfg, [], **loop_kw)["published"]
    t_pub = dict((v, t) for t, v in dry)[TS_CENTER_STEP]
    gc.collect()
    reqs = [dataclasses.replace(r, arrival=r.arrival + t_pub - TS_LEAD_S)
            for r in ts_requests(cfg, TS_REQUESTS, TS_SERVE["max_seq"],
                                 TS_RATE)]
    rec = {"iter_s": [], "decode": [], "mixed_rids": set(), "swap_s": []}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counters()
    with train_serve_timers(rec):
        out = run_train_serve(cfg, reqs, **loop_kw)
    torch.cuda.synchronize()
    launches = fd_ops.COUNTER.count
    other = {k: c.count for k, c in runtime.COUNTERS.items()
             if c.count and k != fd_ops.COUNTER.name}
    peak = torch.cuda.max_memory_allocated()
    st, eng = out["stats"], out["engine"]
    losses = check_reduce_losses(out["logs"], f"[train-serve] {ARCH}")
    single = [dt for nv, dt in rec["decode"] if nv == 1]
    mixed = [dt for nv, dt in rec["decode"] if nv > 1]
    mixed_dispatches = sum(nv for nv, _ in rec["decode"] if nv > 1)
    if not mixed:
        raise AssertionError("[train-serve] no decode step mixed versions")
    if launches != st.decode_dispatches * cfg.n_layers or other:
        raise AssertionError(f"flash_decode launched {launches} times over "
                             f"{st.decode_dispatches} decode dispatches x "
                             f"{cfg.n_layers} layers; others {other}")
    if out["published"] != dry:
        raise AssertionError(f"[train-serve] publishes {out['published']} "
                             f"vs the training-only pass's {dry}")
    if st.n_requests != len(reqs) or st.n_shed or eng.has_work \
            or len(st.versions_served) < 2 or st.swap_count < 2:
        raise AssertionError(f"[train-serve] served {st.n_requests}/"
                             f"{len(reqs)}, shed {st.n_shed}, versions "
                             f"{st.versions_served}, swaps {st.swap_count}")
    by_rid = {r.rid: r for r in reqs}
    for c in st.completions:
        if c.tokens.shape != (by_rid[c.rid].max_new,) \
                or c.tokens.min() < 0 or c.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {c.rid}: bad stream {c.tokens}")
    replay = replay_completions(cfg, out, reqs, rec["mixed_rids"])
    iter_ms = [1e3 * s for s in rec["iter_s"]]
    res = {
        "iterations": len(out["logs"]), "loss": losses,
        "schedule_opens_s": reqs[0].arrival,
        "publishes": out["published"], "swaps": st.swap_count,
        "versions_served": st.versions_served,
        "decode_steps": len(rec["decode"]),
        "decode_dispatches": st.decode_dispatches,
        "mixed_decode_steps": len(mixed),
        "launches": launches,
        "launches_single_version": (st.decode_dispatches - mixed_dispatches)
        * cfg.n_layers,
        "launches_mixed_version": mixed_dispatches * cfg.n_layers,
        "host_ms_per_iter": iter_ms,
        "host_ms_median": float(np.median(iter_ms)),
        "decode_step_ms_single": 1e3 * float(np.median(single)),
        "decode_step_ms_mixed": 1e3 * float(np.median(mixed)),
        "swap_us": [1e6 * s for s in rec["swap_s"]],
        "peak_mem_bytes": peak, "w_cap": out["loop"].reducer._w_cap,
        "workers": [lg.n_workers for lg in out["logs"]],
        "prefix_hits": st.prefix_hits,
        "sim_tokens_per_s": st.tokens_per_s,
        "sim_window_tokens_per_s": st.gen_tokens
        / (st.makespan - reqs[0].arrival), "sim_p50_s": st.p50_latency,
        "sim_p95_s": st.p95_latency, "sim_makespan_s": st.makespan,
        "gen_tokens": st.gen_tokens, "replay": replay}
    print(f"[train-serve] {ARCH} full width, {TS_ITERS} iterations of "
          f"run_train_serve (lr {LM_LR}, publish every {TS_PUBLISH}), "
          f"{st.n_requests} requests on the paged engine (ps "
          f"{TS_SERVE['page_size']}, {TS_SERVE['max_batch']} x "
          f"{TS_SERVE['max_seq']}, flash decode; arrivals at {TS_RATE} rps "
          f"from {reqs[0].arrival:.2f} s of the fleet's clock, "
          f"{TS_LEAD_S} s before the publish of step {TS_CENTER_STEP}): "
          f"loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; {len(out['published'])} publishes "
          f"{out['published']}, {st.swap_count} swaps, versions served "
          f"{dict(sorted(st.versions_served.items()))}; decode steps "
          f"{len(rec['decode'])} ({len(mixed)} mixed-version), flash_decode "
          f"launches {launches} ({res['launches_single_version']} single-"
          f"version, {res['launches_mixed_version']} mixed); host ms per "
          f"training iteration median {res['host_ms_median']:.1f} (range "
          f"{min(iter_ms):.1f}-{max(iter_ms):.1f}); wall ms per decode step "
          f"median {res['decode_step_ms_single']:.2f} single-version, "
          f"{res['decode_step_ms_mixed']:.2f} mixed; swap_params host us "
          f"median {np.median(res['swap_us']):.1f} (max "
          f"{max(res['swap_us']):.1f}); workers {res['workers']}, W_cap "
          f"{res['w_cap']}; peak mem {peak / 2**30:.2f} GiB | {card}")
    print(f"[train-serve] cost model's simulated clock (not the card's): "
          f"{st.gen_tokens} tokens, {res['sim_window_tokens_per_s']:.1f} "
          f"tok/s from the first arrival to the last completion "
          f"({st.tokens_per_s:.1f} over the session from 0), p50 "
          f"{st.p50_latency:.3f} s, p95 {st.p95_latency:.3f} s")
    print(f"[train-serve] replayed {len(replay['replayed'])}/"
          f"{replay['n_completions']} completions solo under their pinned "
          f"versions (plain decode) in {replay['replay_s']:.1f} s, "
          f"including rids {replay['mixed_rids']} that shared a decode step "
          f"with another version: {replay['tokens_compared']} tokens equal, "
          f"{len(replay['near_ties'])} near-ties {replay['near_ties']}")
    del out, eng, st
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_state_parts(loop) -> dict:
    """The reducer's mutable tensors, for a bitwise comparison."""
    red = loop.reducer
    parts = {"flat": red.flat_params}
    for i, x in enumerate(tree_leaves(red.opt_state)):
        parts[f"optimizer state leaf {i}"] = x
    for w, r in red._residuals.items():
        parts[f"residual of {w}"] = r
    return parts


def first_difference(a_logs, b_logs, a_loop, b_loop) -> str:
    """Where two card runs part: the first iteration whose events, wire
    bytes or loss differ, else the first reducer tensor not bit-equal;
    '' if none."""
    for a, b in zip(a_logs, b_logs):
        if (a.events, a.wire_bytes, a.per_worker_wire_bytes) != (
                b.events, b.wire_bytes, b.per_worker_wire_bytes):
            return f"iteration {a.step}: events or wire bytes"
        if not (a.loss == b.loss or (a.loss != a.loss and b.loss != b.loss)):
            return (f"iteration {a.step}: loss {a.loss!r} vs {b.loss!r} (the "
                    f"workers' forward/backward on the card)")
    pa, pb = train_state_parts(a_loop), train_state_parts(b_loop)
    if sorted(pa) != sorted(pb):
        return f"reducer state keys {sorted(pa)} vs {sorted(pb)}"
    for k in pa:
        if not same_bits(pa[k], pb[k]):
            return f"the reducer's {k}"
    return ""


def phase_train_serve_small(card: str) -> dict:
    from repro_torch.checkpoint.io import (TrainState, load_train_state,
                                           save_train_state,
                                           serving_params_from_train_state)
    from repro_torch.serving.sampling import sample_tokens

    small = get_config(ARCH).reduced()
    reqs = ts_requests(small, TS_SMALL_LOAD["n"], TS_SMALL_SERVE["max_seq"],
                       TS_SMALL_LOAD["rate"], TS_SMALL_LOAD["burst"])
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = run_train_serve(
            small, reqs, iterations=TS_SMALL_ITERS, publish_every=TS_PUBLISH,
            T=0.5, seed=0, lr=LM_LR, decode_kernel="flash", device=dev,
            **TS_SMALL_SERVE)
    g, c = runs["cuda"], runs["cpu"]
    rel = same_lm_logs(g["logs"], c["logs"], "[train-serve-small]")
    gs, cs = g["stats"], c["stats"]
    checks = {
        "published": (g["published"], c["published"]),
        "shed": ([(s.rid, s.reason, s.t) for s in gs.shed],
                 [(s.rid, s.reason, s.t) for s in cs.shed]),
        "versions_served": (gs.versions_served, cs.versions_served),
        "swap_count": (gs.swap_count, cs.swap_count),
        "completions (rid, version, finish, latency)": (
            sorted((x.rid, x.version, x.finish, x.latency)
                   for x in gs.completions),
            sorted((x.rid, x.version, x.finish, x.latency)
                   for x in cs.completions))}
    for what, (a, b) in checks.items():
        if a != b:
            raise AssertionError(f"[train-serve-small] {what}: card {a} vs "
                                 f"cpu {b}")
    reasons = {s.reason for s in gs.shed}
    if reasons != {"displaced", "deadline"} or len(gs.versions_served) < 2:
        raise AssertionError(f"[train-serve-small] shed reasons {reasons}, "
                             f"versions {gs.versions_served}")
    gs_published = g["published"]
    del runs, g, c

    # -- speculative decoding in the live loop, card against CPU ---------
    t_spec = time.perf_counter()
    spec_reqs = ts_requests(small, TS_SMALL_LOAD["n"],
                            TS_SMALL_SERVE["max_seq"], TS_SMALL_LOAD["rate"],
                            TS_SPEC_BURST)
    spec_runs = {}
    # versions verified in each engine step on the card: > 1 is a round
    # whose rows of different versions went through one group-masked
    # verify dispatch each
    step_versions = []
    engine_step = ServingEngine.step

    def recorded_step(self, *a, **kw):
        rep = engine_step(self, *a, **kw)
        step_versions.append(len(rep.verify_shapes))
        return rep
    for dev in ("cuda", "cpu"):
        runtime.reset_counters()
        if dev == "cuda":
            ServingEngine.step = recorded_step
        try:
            out = run_train_serve(
                small, spec_reqs, iterations=TS_SMALL_ITERS,
                publish_every=TS_PUBLISH, T=0.5, seed=0, lr=LM_LR,
                decode_kernel="flash", device=dev,
                speculative=SpeculativeConfig(
                    draft_params=tf.init_params(small, seed=2, device=dev),
                    draft_cfg=small, k=2, window=32), **TS_SMALL_SERVE)
        finally:
            ServingEngine.step = engine_step
        if dev == "cuda":
            card_versions = out["versions"]
        st = out["stats"]
        spec_runs[dev] = {
            "published": out["published"],
            "completions (rid, version, finish, latency)": sorted(
                (x.rid, x.version, x.finish, x.latency)
                for x in st.completions),
            "shed": [(x.rid, x.reason, x.t) for x in st.shed],
            "drafted, accepted, rounds, verify dispatches": (
                st.drafted, st.accepted, st.spec_rounds,
                st.decode_dispatches),
            "tokens": {x.rid: x.tokens.tolist() for x in st.completions}}
        if dev == "cuda" and fd_ops.COUNTER.count:
            raise AssertionError("[train-serve-small] the speculative loop "
                                 "launched flash_decode")
    tok_eq = sum(spec_runs["cuda"]["tokens"][r] == t
                 for r, t in spec_runs["cpu"]["tokens"].items())
    for what in spec_runs["cuda"]:
        a, b = spec_runs["cuda"][what], spec_runs["cpu"][what]
        if what != "tokens" and a != b:
            raise AssertionError(f"[train-serve-small] speculative {what}: "
                                 f"card {a} vs cpu {b}")
    # the streams, request by request under the version each was pinned
    # to (completions' versions are equal above): the card's verify must
    # give the CPU's tokens, a near-tie of that version's plain path apart
    spec_ties, spec_compared = [], 0
    by_version = {}
    for rid, ver, _, _ in spec_runs["cpu"]["completions (rid, version, "
                                           "finish, latency)"]:
        by_version.setdefault(ver, []).append(rid)
    prompts_small = {r.rid: r.prompt for r in spec_reqs}
    for ver, rids in sorted(by_version.items()):
        n, t = near_tie_compare(
            card_versions[ver], small, prompts_small,
            {r: spec_runs["cuda"]["tokens"][r] for r in rids},
            {r: spec_runs["cpu"]["tokens"][r] for r in rids},
            f"[train-serve-small] speculative, version {ver}, card vs cpu")
        spec_compared += n
        spec_ties += t
    spec_small = spec_runs["cuda"]["drafted, accepted, rounds, "
                                   "verify dispatches"]
    mixed_rounds = sum(v > 1 for v in step_versions)
    if spec_small[0] == 0 or not spec_runs["cuda"]["published"] \
            or mixed_rounds == 0:
        raise AssertionError(f"[train-serve-small] speculative run drafted "
                             f"{spec_small}, {mixed_rounds} steps verified "
                             f"more than one version")
    n_spec = len(spec_runs["cpu"]["tokens"])
    del spec_runs, card_versions
    spec_s = time.perf_counter() - t_spec

    # -- the sampler on the same logits, card against CPU ----------------
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(MAX_BATCH, 32768, generator=gen) * 3.0
    logits[:, 7] = logits[:, 11] = logits.max() + 1.0   # tied maxima
    rids = torch.arange(MAX_BATCH, dtype=torch.int64) * 7919
    gidx = torch.arange(MAX_BATCH, dtype=torch.int64) % 5
    sampled = {}
    for T, k in ((0.8, 20), (0.8, 1), (0.8, 0), (0.0, 0)):
        a = sample_tokens(logits.cuda(), rids.cuda(), gidx.cuda(),
                          temperature=T, top_k=k, seed=0).cpu()
        b = sample_tokens(logits, rids, gidx, temperature=T, top_k=k, seed=0)
        sampled[(T, k)] = (a, b)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    for key in ((0.8, 20), (0.8, 1)):
        a, b = sampled[key]
        if not torch.equal(a, b):
            raise AssertionError(f"sampler T={key[0]} top_k={key[1]}: card "
                                 f"{a.tolist()} vs cpu {b.tolist()}")
    if not torch.equal(sampled[(0.8, 1)][0], greedy) \
            or not torch.equal(sampled[(0.0, 0)][0], greedy):
        raise AssertionError("sampler: top_k=1 or temperature 0 is not the "
                             "argmax")
    full_equal = int((sampled[(0.8, 0)][0] == sampled[(0.8, 0)][1]).sum())

    # -- TrainState: snapshot on the card, reload, resume ----------------
    def fleet():
        return build_training(small, seed=0, lr=LM_LR, device="cuda")

    loop, cluster, _ = fleet()
    straight = loop.run(RESUME_AT + RESUME_MORE)
    loop_a, cluster_a, _ = fleet()
    loop_a.run(RESUME_AT)
    path = str(ROOT / "build" / "train_state.npz")
    (ROOT / "build").mkdir(exist_ok=True)
    save_train_state(path, TrainState.capture(loop_a, cluster_a))
    state = load_train_state(path)
    loop_b, cluster_b, template = fleet()
    state.restore(loop_b, cluster_b)
    resumed = loop_b.run(RESUME_MORE)
    where = first_difference(straight[RESUME_AT:], resumed, loop, loop_b)
    if where:
        raise AssertionError(f"[train-serve-small] resumed TrainState parts "
                             f"from the uninterrupted card run at {where}: "
                             f"the card is not deterministic there")
    # --from-snapshot: an engine seeded from the state serves what an
    # engine built on the snapshot loop's own params serves
    params, step = serving_params_from_train_state(state, template)
    streams = []
    for p, v in ((params, step), (loop_a.reducer.params, loop_a.step)):
        eng = ServingEngine(p, small, serving=ServingConfig(
            max_batch=2, max_seq=64, start_version=v), device="cuda")
        st = eng.run_closed_loop([ServeRequest(
            rid=0, prompt=reqs[0].prompt[:16], max_new=12)])
        streams.append(st.completions[0].tokens.tolist())
    if streams[0] != streams[1] or step != RESUME_AT:
        raise AssertionError(f"--from-snapshot engine (step {step}) served "
                             f"{streams[0]}, the loop's params {streams[1]}")
    res = {"loss_rel": rel, "published": gs_published,
           "shed": [(s.rid, s.reason, s.t) for s in gs.shed],
           "versions_served": gs.versions_served,
           "sampler_equal_top_k_0": full_equal,
           "resume_losses": [lg.loss for lg in resumed],
           "snapshot_stream": streams[0],
           "speculative": {"drafted_accepted_rounds_verify": spec_small,
                           "tokens_equal": tok_eq, "completions": n_spec,
                           "tokens_compared": spec_compared,
                           "near_ties": spec_ties,
                           "mixed_version_steps": mixed_rounds,
                           "seconds": spec_s}}
    print(f"[train-serve-small] {ARCH}.reduced() card vs CPU, "
          f"{TS_SMALL_ITERS} iterations: training events and wire bytes "
          f"equal (loss within {rel:.1e} rel), publishes, "
          f"{len(res['shed'])} sheds {sorted(reasons)}, versions served "
          f"{dict(sorted(gs.versions_served.items()))} and every "
          f"completion's version, finish and latency equal; sampler card = "
          f"CPU on {MAX_BATCH} rows x 32768 at T 0.8 top-k 20 and 1 (top-k "
          f"1 and T 0 = argmax; full vocabulary equal on {full_equal}/"
          f"{MAX_BATCH} rows); TrainState written after {RESUME_AT} "
          f"iterations, reloaded and resumed {RESUME_MORE}: events, wire, "
          f"losses and the reducer's flat buffer, optimizer state and "
          f"residuals bit-equal to the uninterrupted run; --from-snapshot "
          f"stream equal | {card}")
    print(f"[train-serve-small] speculative k 2 (the served arch at init, "
          f"seed 2) card vs CPU: publishes, sheds, every completion's "
          f"version, finish and latency equal; drafted, accepted, rounds, "
          f"verify dispatches {spec_small} equal; {mixed_rounds} steps "
          f"verified two or more versions; token streams equal on "
          f"{tok_eq}/{n_spec} ({spec_compared} tokens compared, "
          f"{len(spec_ties)} near-ties); flash_decode launched 0 times "
          f"| {card}")
    return res


# ---------------------------------------------------------------------------
# slice 9: the two-tier hierarchy, randk and the dense reducer path
# ---------------------------------------------------------------------------
# run_simulated(regions=4)'s shape: 4 regions of build_training's fleet,
# H 4 inner iterations per outer step, top-k 0.25 gossip; 8 steps = 2
# outer steps at full width (AdaGrad at LM_LR)
HIER_REGIONS, HIER_H, HIER_STEPS, HIER_GOSSIP = 4, 4, 8, 0.25
# the reduced runs, card against CPU: 4 outer steps, region r1 parked
# before outer step 2 and rejoined before outer step 3; a TrainState
# written after HIER_RESUME_AT outer steps resumes the rest
HIER_SMALL_OUTER, HIER_RESUME_AT = 4, 2
HIER_CHURN = {1: "leave", 2: "join"}
# the blocktopk sub-masters: the elastic-SGD demo's channel
HIER_BLOCK = dict(frac=1 / 32, block_w=32)
RANDK_FRAC, RANDK_SLICE = 1 / 128, 1 << 22
# card vs CPU, each region's ||params_card - params_cpu|| / ||params_cpu||
# (same_hier says why the bound is not 1e-3); the probe batch of the
# consensus params' loss
HIER_PARAM_RTOL, HIER_PROBE = 5e-2, 64
DENSE_CHANNELS = (("topk", 0.1), ("blocktopk", 1 / 32), ("randk", 1 / 32))


def hier_config() -> HierarchyConfig:
    return HierarchyConfig(n_regions=HIER_REGIONS, inner_steps=HIER_H,
                           gossip=True, gossip_frac=HIER_GOSSIP)


def check_region_losses(master, what: str) -> list:
    """Every region's iterations: a loss where a reduce ran, none where
    every reply was late; every outer step's loss finite. Returns the
    outer losses."""
    for r, loop in sorted(master.regions.items()):
        for lg in loop.history:
            if (lg.n_workers > 0) != math.isfinite(lg.loss) or (
                    lg.n_workers == 0 and lg.n_late == 0):
                raise AssertionError(f"{what} {r} iteration {lg.step}: loss "
                                     f"{lg.loss}, {lg.n_workers} workers "
                                     f"reduced, {lg.n_late} late")
    losses = [lg.loss for lg in master.history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: outer losses {losses}")
    return losses


def phase_hier(card: str) -> dict:
    """The full-width two-tier hierarchy: run_simulated(regions=4)'s
    path, timed by run_hierarchy."""
    cfg = get_config(ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    runtime.reset_counters()
    run = run_hierarchy(cfg, outer_steps=HIER_STEPS // HIER_H,
                        hierarchy=hier_config(), T=0.5, seed=0,
                        device="cuda", lr=LM_LR)
    launches = {k: c.count for k, c in runtime.COUNTERS.items()}
    master = run.master
    losses = check_region_losses(master, f"[hier] {ARCH}")
    n = cfg.n_params()
    k = int(HIER_GOSSIP * n)
    want = 8 * k * (HIER_REGIONS - 1) * HIER_REGIONS
    wan = [lg.wan_bytes for lg in run.logs]
    if master.regions["r0"].reducer.flat_n != n or wan != [want] * len(wan):
        raise AssertionError(f"[hier] WAN bytes {wan} per outer step, want "
                             f"{want} (8 k (R-1) R, k = {k})")
    spread = [lg.spread for lg in run.logs]
    if not all(math.isfinite(x) for x in spread):
        raise AssertionError(f"[hier] spread {spread}")
    consensus = master.params
    template = tf.init_params(cfg, seed=0, device="cpu")
    got = [(p, tuple(x.shape), x.dtype) for p, x in
           zip(flat_spec(consensus).paths, tree_leaves(consensus))]
    exp = [(p, tuple(x.shape), x.dtype) for p, x in
           zip(flat_spec(template).paths, tree_leaves(template))]
    del template
    if got != exp or not bool(torch.isfinite(master.consensus_flat()).all()):
        raise AssertionError("[hier] the consensus params do not unflatten "
                             "to the model's shapes, or are not finite")
    s = master.summary()
    iter_ms = [1e3 * x for x in run.iter_s]
    res = {"regions": HIER_REGIONS, "inner_steps": HIER_H,
           "outer_steps": master.outer_step, "n_params": n, "gossip_k": k,
           "loss": losses, "spread": spread, "wan_bytes": wan,
           "wan_time_s": [lg.wan_time for lg in run.logs],
           "summary": s, "clock_s": master.clock,
           "region_losses": {r: [lg.loss for lg in lp.history]
                             for r, lp in master.regions.items()},
           "host_ms_per_inner_iter": iter_ms,
           "host_ms_median": float(np.median(iter_ms)),
           "outer_exchange_ms": run.outer_ms,
           "peak_mem_bytes": run.peak_mem_bytes, "launches": launches}
    del run, master, consensus
    gc.collect()            # the loops' reference cycles hold the state
    torch.cuda.empty_cache()
    print(f"[hier] {ARCH} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n} parameters), {HIER_REGIONS} regions x "
          f"build_training's fleet ({HIER_REGIONS * 4} workers), H "
          f"{HIER_H}, {res['outer_steps']} outer steps (AdaGrad lr "
          f"{LM_LR}, top-k 0.1 within regions, gossip top-k {HIER_GOSSIP}): "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; host ms per inner "
          f"iteration median {res['host_ms_median']:.1f} (range "
          f"{min(iter_ms):.1f}-{max(iter_ms):.1f}, {len(iter_ms)} "
          f"iterations); ms per outer exchange "
          f"{', '.join(f'{x:.1f}' for x in res['outer_exchange_ms'])} "
          f"(CUDA events: compress + gossip + correction, 4 regions); WAN "
          f"{wan} bytes per outer step (= 8 k (R-1) R), "
          f"{100 * s['wan_bytes_frac']:.2f}% of all gradient traffic; "
          f"spread {', '.join(f'{x:.3e}' for x in spread)}; simulated clock "
          f"{res['clock_s']:.2f} s; kernel launches {launches}; peak mem "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB | {card}")
    return res


def small_hier(small, device: str, blocktopk: bool = False):
    """build_training's two-tier hierarchy at the reduced size; with
    ``blocktopk`` the sub-masters use the fused block-top-k channel
    (swapped in before any reduce, so no step closure exists yet)."""
    master, cluster, params = build_training(
        small, training=TrainingConfig(
            T=0.5, deadline=DeadlineConfig(quantile=0.5),
            hierarchy=hier_config()), seed=0, lr=LM_LR, device=device)
    if blocktopk:
        for loop in master.regions.values():
            loop.reducer.compressor = GradientCompressor("blocktopk",
                                                         **HIER_BLOCK)
    return master, cluster, params


def drive_hier(master, until: int) -> None:
    """Outer steps up to ``until``, parking region r1 and rejoining it at
    the steps HIER_CHURN names."""
    while master.outer_step < until:
        ev = HIER_CHURN.get(master.outer_step)
        if ev == "leave":
            master.leave_region("r1")
        elif ev == "join":
            master.join_region("r1")
        master.iteration()


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over two flat parameter buffers."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def same_hier(gpu, cpu, what: str, probe) -> dict:
    """Card against CPU: every OuterLog's clock, vectors, WAN bytes,
    region steps and events equal, and every region's IterationLogs
    (events, workers, vectors, wire bytes, per-worker keeps); every loss
    within 1e-3 relative, and the consensus params' loss on ``probe`` (a
    fixed batch, on the CPU) within 1e-3. The params themselves part
    further: a top-k pick that rounding flips between the card and the
    CPU moves its entry by a whole AdaGrad step and changes the error
    feedback from then on: two CPU runs of this hierarchy whose gradients
    differ by 1e-6 relative noise part by 1.04e-2 to 1.07e-2 in
    ``rel_diff`` (``scripts/hier_flip_drift.py``). So each region's
    ``rel_diff`` is held to HIER_PARAM_RTOL, about 5x that. Returns the
    largest relative differences."""
    loss_rel = 0.0
    if len(gpu.history) != len(cpu.history):
        raise AssertionError(f"{what}: outer steps differ")
    for a, b in zip(gpu.history, cpu.history):
        ka = (a.clock, a.vectors, a.wan_bytes, a.wan_time, a.region_steps,
              a.events)
        kb = (b.clock, b.vectors, b.wan_bytes, b.wan_time, b.region_steps,
              b.events)
        if ka != kb:
            raise AssertionError(f"{what} outer step {a.outer_step}: card "
                                 f"{ka} vs cpu {kb}")
        r = abs(a.loss - b.loss) / abs(b.loss)
        if not r <= 1e-3:
            raise AssertionError(f"{what} outer step {a.outer_step}: loss "
                                 f"{a.loss} vs {b.loss}")
        loss_rel = max(loss_rel, r)
    param_rel = 0.0
    for r in sorted(gpu.regions):
        loss_rel = max(loss_rel, same_lm_logs(
            gpu.regions[r].history, cpu.regions[r].history, f"{what} {r}"))
        d = rel_diff(gpu.regions[r].reducer.flat_params,
                     cpu.regions[r].reducer.flat_params)
        if not d <= HIER_PARAM_RTOL:
            raise AssertionError(f"{what} {r}: params {d:.2e} apart "
                                 f"(||card - cpu|| / ||cpu||)")
        param_rel = max(param_rel, d)
    pg = probe(tree_map(lambda x: x.cpu(), gpu.params))
    pc = probe(cpu.params)
    probe_rel = abs(pg - pc) / abs(pc)
    if not probe_rel <= 1e-3:
        raise AssertionError(f"{what}: the consensus params' probe loss "
                             f"{pg} on the card vs {pc} on the CPU")
    return {"loss_rel": loss_rel, "param_rel": param_rel,
            "probe_rel": probe_rel, "probe_loss": pc}


def hier_parts(master) -> dict:
    """The hierarchy's mutable tensors, for a bitwise comparison."""
    parts = {}
    for r, loop in sorted(master.regions.items()):
        for k, v in train_state_parts(loop).items():
            parts[f"{r} {k}"] = v
    for r, g in master._ghosts.items():
        parts[f"{r} ghost"] = g
    for r, v in master._residuals.items():
        if v is not None:
            parts[f"{r} gossip residual"] = v
    return parts


def phase_hier_small(card: str) -> dict:
    from repro_torch.checkpoint.io import (TrainState, load_train_state,
                                           save_train_state,
                                           serving_params_from_train_state)

    small = get_config(ARCH).reduced()
    (X, y), _ = sim.make_lm_problem(small, seed=0, device="cpu")
    probe = make_lm_probe(small, X[:HIER_PROBE], y[:HIER_PROBE],
                          device="cpu")
    # -- the topk hierarchy with regional churn, card and CPU -------------
    gpu, _, template = small_hier(small, "cuda")
    drive_hier(gpu, HIER_SMALL_OUTER)
    cpu, _, _ = small_hier(small, "cpu")
    drive_hier(cpu, HIER_SMALL_OUTER)
    rel = same_hier(gpu, cpu, "[hier-small] topk", probe)
    losses = check_region_losses(gpu, "[hier-small] topk")
    events = [e for lg in gpu.history for e in lg.events]
    if events != ["region-leave:r1", "region-join:r1"]:
        raise AssertionError(f"[hier-small] outer events {events}")
    # -- the two-tier TrainState: written mid-run, resumed ---------------
    a, cluster_a, _ = small_hier(small, "cuda")
    drive_hier(a, HIER_RESUME_AT)
    path = str(ROOT / "build" / "hier_state.npz")
    (ROOT / "build").mkdir(exist_ok=True)
    save_train_state(path, TrainState.capture(a, cluster_a))
    b, cluster_b, _ = small_hier(small, "cuda")
    load_train_state(path).restore(b, cluster_b)
    drive_hier(b, HIER_SMALL_OUTER)
    for x, y in zip(gpu.history, b.history):
        if x != y:
            raise AssertionError(f"[hier-small] resumed outer step "
                                 f"{y.outer_step}: {y} vs the uninterrupted "
                                 f"{x}")
    for r in sorted(gpu.regions):
        where = first_difference(gpu.regions[r].history,
                                 b.regions[r].history, gpu.regions[r],
                                 b.regions[r])
        if where:
            raise AssertionError(f"[hier-small] resumed region {r} parts "
                                 f"from the uninterrupted run at {where}")
    pa, pb = hier_parts(gpu), hier_parts(b)
    bad = [k for k in pa if k not in pb or not same_bits(pa[k], pb[k])]
    if bad or sorted(pa) != sorted(pb):
        raise AssertionError(f"[hier-small] resumed state differs: {bad}")
    params, version = serving_params_from_train_state(
        TrainState.capture(gpu), template)
    if not same_bits(flat_spec(params).flatten(params),
                     gpu.consensus_flat()) or version != max(
                         lp.step for lp in gpu.regions.values()):
        raise AssertionError("[hier-small] serving_params_from_train_state "
                             "is not the consensus")
    # -- blocktopk sub-masters: one fused_compress launch per region per
    # reduce step, card and CPU ------------------------------------------
    runtime.reset_counters()
    bt_gpu, _, _ = small_hier(small, "cuda", blocktopk=True)
    drive_hier(bt_gpu, HIER_SMALL_OUTER)
    torch.cuda.synchronize()
    launches = tk_ops.COUNTER.count
    steps = {r: lp.reducer.step for r, lp in sorted(bt_gpu.regions.items())}
    runtime.reset_counters()
    bt_cpu, _, _ = small_hier(small, "cpu", blocktopk=True)
    drive_hier(bt_cpu, HIER_SMALL_OUTER)
    if tk_ops.COUNTER.count:
        raise AssertionError("the CPU blocktopk hierarchy launched the "
                             "kernel")
    bt_rel = same_hier(bt_gpu, bt_cpu, "[hier-small] blocktopk", probe)
    check_region_losses(bt_gpu, "[hier-small] blocktopk")
    if launches == 0 or launches != sum(steps.values()):
        raise AssertionError(f"fused_compress launched {launches} times over "
                             f"{steps} reduce steps")
    res = {"loss": losses, "card_vs_cpu": rel, "outer_events": events,
           "wan_bytes": [lg.wan_bytes for lg in gpu.history],
           "region_steps": [lg.region_steps for lg in gpu.history],
           "resume_at": HIER_RESUME_AT, "serving_version": version,
           "blocktopk_loss": [lg.loss for lg in bt_gpu.history],
           "blocktopk_card_vs_cpu": bt_rel, "launches": launches,
           "reduce_steps": steps}
    print(f"[hier-small] {ARCH}.reduced() {HIER_REGIONS} regions, "
          f"{HIER_SMALL_OUTER} outer steps (r1 parked before 2, rejoined "
          f"before 3) card vs CPU: OuterLog clocks, vectors, WAN bytes "
          f"{res['wan_bytes']}, region steps and events, every region's "
          f"iteration events, wire bytes and keeps equal, losses within "
          f"{rel['loss_rel']:.1e} rel, the consensus' probe loss within "
          f"{rel['probe_rel']:.1e}, params {rel['param_rel']:.2e} apart "
          f"(||card - cpu|| / ||cpu||, bound {HIER_PARAM_RTOL}); TrainState "
          f"written after "
          f"{HIER_RESUME_AT} outer steps and resumed: OuterLogs, region "
          f"logs, params, optimizer states, residuals, ghosts and gossip "
          f"residuals bit-equal; serving_params_from_train_state = "
          f"consensus_flat (version {version}); blocktopk sub-masters "
          f"(1/32, block_w 32) card = CPU (losses within "
          f"{bt_rel['loss_rel']:.1e}, probe {bt_rel['probe_rel']:.1e}, "
          f"params {bt_rel['param_rel']:.2e} apart), "
          f"fused_compress launches {launches} = reduce steps "
          f"{sum(steps.values())} {steps} | {card}")
    return res


def phase_randk(card: str) -> dict:
    """randk on the fused reducer over the LM's flat buffer: 4 workers'
    seeded gradients, frac 1/128, 3 reduce steps."""
    cfg = get_config(ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = tf.init_params(cfg, seed=0, device="cuda")
    comp = GradientCompressor("randk", frac=RANDK_FRAC)
    red = MasterReducer(params, adagrad(lr=0.02), comp)
    del params
    spec = flat_spec(red.params)
    n = red.flat_n
    k = comp.flat_k(n)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    step_ms, prev, slice_checked = [], None, 0
    for s in range(3):
        msgs = {f"w{i}": (spec.unflatten(torch.randn(
            n, generator=gen, device="cuda")), 1000 + i) for i in range(4)}
        names = sorted(msgs)
        corrected = {w: spec.flatten(msgs[w][0]) + red._residuals.get(
            w, torch.zeros(n, device="cuda")) for w in names}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        red.reduce_and_step(msgs)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        del msgs
        for row, w in enumerate(names):
            key = comp.flat_key(s, row)
            idx = randk_indices(key, n, k, "cuda").long()
            if torch.unique(idx).numel() != k:
                raise AssertionError(f"[randk] step {s} {w}: indices not "
                                     f"{k} distinct")
            c = corrected.pop(w)
            sent = torch.zeros(n, device="cuda").index_add_(0, idx, c[idx])
            if not torch.equal(red._residuals[w] + sent, c):
                raise AssertionError(f"[randk] step {s} {w}: scatter(vals) "
                                     f"+ res != g + r")
            if row == 0:
                sel = torch.sort(idx).values
                if prev is not None and torch.equal(sel, prev):
                    raise AssertionError(f"[randk] step {s}: the same mask "
                                         f"as step {s - 1}")
                prev = sel
                # the CPU's draw on a prefix slice: the same scores, and
                # the same picks at or above the card's k-th largest score
                scores = randk_scores(key, n, "cuda")
                cut = scores[idx[-1]].cpu()
                cpu = randk_scores(key, RANDK_SLICE, "cpu")
                picks = torch.sort(idx[idx < RANDK_SLICE]).values.cpu()
                if not torch.equal(scores[:RANDK_SLICE].cpu(), cpu) or \
                        not torch.equal(torch.nonzero(cpu >= cut)
                                        .reshape(-1), picks):
                    raise AssertionError(f"[randk] step {s}: card and CPU "
                                         f"draws differ on [0, "
                                         f"{RANDK_SLICE})")
                slice_checked += picks.numel()
                del scores
    peak = torch.cuda.max_memory_allocated()
    if red.last_wire_bytes != 4 * 8 * k or \
            not bool(torch.isfinite(red.flat_params).all()):
        raise AssertionError(f"[randk] wire bytes {red.last_wire_bytes} != "
                             f"{4 * 8 * k} or non-finite params")
    del red, corrected
    gc.collect()
    torch.cuda.empty_cache()
    res = {"n": n, "k": k, "step_ms": step_ms, "peak_mem_bytes": peak,
           "slice_picks_compared": slice_checked}
    print(f"[randk] {ARCH} flat buffer n={n}, 4 workers, frac 1/128 (k "
          f"{k}): 3 reduce steps {', '.join(f'{x:.1f}' for x in step_ms)} "
          f"ms (host, synced; one row's hash draw and selection at a "
          f"time); every row k distinct indices, scatter(vals) + res == g + "
          f"r bit for bit, masks new each step, card = CPU on the first "
          f"{RANDK_SLICE} scores ({slice_checked} picks); peak mem "
          f"{peak / 2**30:.2f} GiB | {card}")
    return res


def dense_masks(red, msgs, step: int) -> list:
    """The leaf-wise channel's masks for this reduce step, per worker in
    sorted order, per leaf: what ``roundtrip`` will select."""
    comp = red.compressor
    out = []
    for w in sorted(msgs):
        leaves = [x.float() for x in tree_leaves(msgs[w][0])]
        res = red._residuals.get(w)
        if res is not None:
            leaves = [x + r for x, r in zip(leaves, tree_leaves(res))]
        out.append([comp._mask_leaf(x, comp.flat_key(step, i))
                    for i, x in enumerate(leaves)])
    return out


def phase_dense_reduce(card: str) -> dict:
    """MasterReducer(fused=False) at the reduced LM: uncompressed against
    the fused path; topk / blocktopk / randk card against CPU."""
    from repro_torch.core.flatbuf import build_tree

    small = get_config(ARCH).reduced()
    base = tf.init_params(small, seed=0, device="cpu")
    paths = flat_spec(base).paths
    rng = np.random.RandomState(5)
    steps = [{f"w{i}": ([rng.randn(*x.shape).astype(np.float32)
                         for x in tree_leaves(base)], 100 + i)
              for i in range(4)} for _ in range(3)]

    def on(dev):
        return [{w: (build_tree(paths, [torch.tensor(a).to(dev) for a in g]),
                     n) for w, (g, n) in st.items()} for st in steps]

    # uncompressed: dense = fused within the JAX package's pin, 1e-5
    dense = MasterReducer(tf.init_params(small, seed=0, device="cuda"),
                          adagrad(lr=0.02), fused=False)
    fused = MasterReducer(tf.init_params(small, seed=0, device="cuda"),
                          adagrad(lr=0.02))
    for msgs in on("cuda"):
        dense.reduce_and_step(msgs)
        fused.reduce_and_step(msgs)
    err = float((dense.flat_params - fused.flat_params).abs().max())
    if err > 1e-5:
        raise AssertionError(f"[dense-reduce] dense vs fused {err:.2e}")
    out = {"dense_vs_fused": err}
    for method, frac in DENSE_CHANNELS:
        runs = {}
        for dev in ("cuda", "cpu"):
            red = MasterReducer(tf.init_params(small, seed=0, device=dev),
                                adagrad(lr=0.02),
                                GradientCompressor(method, frac=frac),
                                fused=False)
            masks, wire = [], []
            for s, msgs in enumerate(on(dev)):
                masks.append(dense_masks(red, msgs, s))
                red.reduce_and_step(msgs)
                wire.append(dict(red.last_per_worker_bytes))
            runs[dev] = (red, masks, wire)
        for s, (a, b) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
            for wa, wb in zip(a, b):
                if not all(torch.equal(ma.cpu(), mb)
                           for ma, mb in zip(wa, wb)):
                    raise AssertionError(f"[dense-reduce] {method} step {s}: "
                                         f"card and CPU masks differ")
        if runs["cuda"][2] != runs["cpu"][2]:
            raise AssertionError(f"[dense-reduce] {method} wire bytes "
                                 f"{runs['cuda'][2]} vs {runs['cpu'][2]}")
        d = float((runs["cuda"][0].flat_params.cpu()
                   - runs["cpu"][0].flat_params).abs().max())
        if d > 1e-6:
            raise AssertionError(f"[dense-reduce] {method} params {d:.2e} "
                                 f"apart")
        out[method] = {"params_max_abs": d, "wire": runs["cuda"][2][-1],
                       "kept_step0_w0": sum(int(m.sum())
                                            for m in runs["cuda"][1][0][0])}
    print(f"[dense-reduce] {ARCH}.reduced() ({dense.flat_n} parameters), "
          f"MasterReducer(fused=False), 4 workers, 3 AdaGrad steps: "
          f"uncompressed = fused within {err:.1e} (pin 1e-5); "
          + "; ".join(f"{m} {f:g}: masks and wire bytes "
                      f"({out[m]['wire']['w0']} B a worker) card = CPU, "
                      f"params within {out[m]['params_max_abs']:.1e}"
                      for m, f in DENSE_CHANNELS) + f" | {card}")
    return out


# ---------------------------------------------------------------------------
# slice 10: the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------
MOE_ARCH = "llama4-scout-17b-a16e"
# 48 layers of llama4-scout are ~216 GB in bf16: the widths stay, the
# depth is cut to 4 layers (~21.8 GB)
MOE_LAYERS = 4
MOE_SERVE = dict(max_batch=16, max_seq=256, page_size=16)
MOE_REQUESTS = 32
# bf16 near ties in [moe]. The flash and plain decode paths round at
# different points (the plain one casts the softmax weights to bf16
# before P V, as the reference does), so the two runs' logits and router
# probabilities part a little: over steps where both agree, the top-1
# logit by up to 0.064 and a router probability by up to 0.0073 (PERF.md,
# PR 20). Each request is compared up to its first flip, which must be a
# near tie in both runs: a token flip with both top-2 logit gaps below
# LOGIT_TIE_BF16; a routing flip (the first layer whose top-k experts
# differ; one flip changes the whole token) with both router top-k
# probability gaps below ROUTER_TIE_BF16.
LOGIT_TIE_BF16 = 0.1
ROUTER_TIE_BF16 = 1e-2
# float32, card against CPU: logits GAP_TIE, routers ROUTER_TIE_F32
ROUTER_TIE_F32 = 1e-5
SMALL_MOE_ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
SMALL_SERVE = dict(max_batch=4, max_seq=64, page_size=8)
SSM_ARCHS = ("mamba2-780m", "zamba2-7b")
SSM_TOL = 1e-4                 # [ssm-small] logits, card against CPU
# [ssm] / [hybrid] in float32 at full depth: the recurrent decode's logits
# part from the growing forward's by up to 4e-4 (mamba2) and 1.7e-3
# (zamba2) over 12 steps (PERF.md, PR 20); a differing token passes only
# where both top-2 gaps are below this
SSM_TIE_F32 = 1e-2


def sized_requests(cfg, n: int, max_seq: int, seed: int = 1):
    """``launch.serve``'s schedule sized to ``max_seq`` (every prompt +
    generation fits)."""
    g_hi, g_lo = max(2, max_seq // 2), max(1, max_seq // 4)
    p_hi = max(1, min(max(8, max_seq // 8), max_seq - g_hi))
    return generate_requests(
        n, rate_rps=60.0, vocab_size=cfg.vocab_size,
        prompt_rng=(min(4, p_hi), p_hi), gen_short=(1, min(12, g_lo)),
        gen_long=(g_lo, g_hi), seed=seed)


def engine(params, cfg, device: str, *, max_batch: int, max_seq: int,
           page_size: int = 0, kernel: str = "flash", speculative=None):
    with warnings.catch_warnings():
        # the MoE capacity warning: the near-tie rule covers what it
        # warns of, and the tight-capacity runs are there to bind
        warnings.simplefilter("ignore")
        return ServingEngine(params, cfg, serving=ServingConfig(
            max_batch=max_batch, max_seq=max_seq, decode_kernel=kernel,
            paging=PagingConfig(page_size=page_size) if page_size else None,
            speculative=speculative), device=device)


@contextlib.contextmanager
def decode_probes(cur: dict):
    """While ``cur["on"]``: each routed layer appends the (B, E) router
    probabilities of its last position to ``cur["router"]``; while
    ``cur["capture"]``, each flash-decode call appends copies of its
    arguments to ``cur["calls"]``. The wrappers call through: the launch
    counter sees exactly the kernel's launches."""
    fd_pkg = importlib.import_module("repro_torch.kernels.flash_decode")
    route, fd = moe_mod.route, fd_pkg.flash_decode

    def probed_route(router_w, x, cfg):
        out = route(router_w, x, cfg)
        if cur.get("on"):
            cur["router"].append(
                torch.softmax(x[:, -1].float() @ router_w, dim=-1))
        return out

    def captured_fd(q, kpool, vpool, page_map, pos, live):
        if cur.get("capture"):
            cur["calls"].append(dict(
                q=q.clone(), kpool=kpool.clone(), vpool=vpool.clone(),
                page_map=page_map.clone(), pos=pos.clone(),
                live=live.clone()))
        return fd(q, kpool, vpool, page_map, pos, live)
    moe_mod.route, fd_pkg.flash_decode = probed_route, captured_fd
    try:
        yield
    finally:
        moe_mod.route, fd_pkg.flash_decode = route, fd


def record_decode(eng, cur: dict, capture: dict = None) -> dict:
    """Wrap ``eng``'s decode dispatch: returns a dict (rid, index of the
    token the step produces) -> (top-2 logits, (L, E) router
    probabilities) of the batch that actually ran. ``capture`` takes the
    flash-decode arguments of every layer of the step with the most live
    KV tokens. Needs ``decode_probes(cur)`` around the run."""
    rec = {}
    decode = eng._programs.decode

    def decode_rec(*a):
        logits, cache = decode(*a)
        cur["logits"] = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        return logits, cache
    eng._programs = dataclasses.replace(eng._programs, decode=decode_rec)
    dispatch = eng._dispatch_decode

    def dispatch_rec(params, group, rids, gidx):
        rows = np.nonzero(group)[0]
        live_tok = sum(int(eng._pos[s]) + 1 for s in rows)
        cur.update(on=True, router=[], calls=[], capture=capture is not None
                   and live_tok > capture.get("live_tokens", -1))
        nxt = dispatch(params, group, rids, gidx)
        if cur["capture"]:
            capture.update(live_tokens=live_tok, calls=cur["calls"])
        cur.update(on=False, capture=False)
        lg = cur["logits"].cpu().numpy()
        rt = torch.stack(cur["router"], 1).cpu().numpy() if cur["router"] \
            else np.zeros((len(group), 0, 0), np.float32)
        for s in rows:
            rec[(int(rids[s]), int(gidx[s]))] = (lg[s], rt[s])
        return nxt
    eng._dispatch_decode = dispatch_rec
    return rec


def top_gap(v: np.ndarray, k: int = 1) -> np.ndarray:
    """The k-th largest minus the (k+1)-th largest along the last axis."""
    s = -np.sort(-v, axis=-1)
    return s[..., k - 1] - s[..., k]


def step_flip(have: list, a: int, b: int, k: int, logit_tie: float,
              router_tie: float, where: str):
    """Judge one decode step of one request. ``have``: the step's records
    (top-2 logits, (L, E) router probabilities) from one run or two.
    With two, a layer whose top-k experts differ is a routing flip: the
    first such layer must be a near tie in both runs (router top-k gap
    below ``router_tie``). A differing token (``a != b``) must be a near
    tie in every recorded run (top-2 logit gap below ``logit_tie``); with
    one record, whose routing the other run's is not known against, a
    router gap below ``router_tie`` at any layer also counts. Returns
    the near tie's description, None where nothing flipped; raises on a
    flip that is no near tie."""
    if len(have) == 2 and have[0][1].size:
        (_, pa), (_, pb) = have
        sa = np.sort(np.argsort(-pa, axis=-1, kind="stable")[:, :k], -1)
        sb = np.sort(np.argsort(-pb, axis=-1, kind="stable")[:, :k], -1)
        moved = np.nonzero((sa != sb).any(-1))[0]
        if moved.size:
            lay = int(moved[0])
            gaps = [float(top_gap(p[lay], k)) for p in (pa, pb)]
            if max(gaps) >= router_tie:
                raise AssertionError(f"{where}: routing flip at layer {lay} "
                                     f"with router gaps {gaps} (bound "
                                     f"{router_tie})")
            return f"routing flip at layer {lay}, router gaps {gaps}"
    if a == b:
        return None
    gaps = [float(lg[0] - lg[1]) for lg, _ in have]
    if gaps and max(gaps) < logit_tie:
        return f"token flip, top-2 logit gaps {gaps}"
    if len(have) == 1 and have[0][1].size \
            and float(top_gap(have[0][1], k).min()) < router_tie:
        return (f"token flip, router gap "
                f"{float(top_gap(have[0][1], k).min()):.2e}")
    raise AssertionError(f"{where}: token {a} vs {b}, top-2 logit gaps "
                         f"{gaps} (bound {logit_tie}): no near tie")


def recorded_compare(got: dict, want: dict, recs, tag: str, *,
                     logit_tie: float, router_tie: float, k: int = 1
                     ) -> dict:
    """``got`` against ``want`` (rid -> tokens), each request up to its
    first flip, which must be a near tie (``step_flip``) judged on the
    records of the batches that actually ran (``recs``: one dict per
    run, (rid, token index) -> (top-2 logits, router probabilities)).
    A token with no record (the prefill's) must be equal. Returns tokens
    compared, the near ties and, over the compared tokens, the largest
    drift between the two runs of the top-1 logit and of a router
    probability."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag} answered {sorted(got)}, expected "
                             f"{sorted(want)}")
    compared, ties, drift_l, drift_r = 0, [], 0.0, 0.0
    for rid in sorted(want):
        if len(got[rid]) != len(want[rid]):
            raise AssertionError(f"{tag} request {rid}: {len(got[rid])} "
                                 f"tokens, expected {len(want[rid])}")
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            have = [r[(rid, i)] for r in recs if (rid, i) in r]
            tie = step_flip(have, a, b, k, logit_tie, router_tie,
                            f"{tag} request {rid} token {i}")
            if tie:
                ties.append((rid, i, tie))
                break
            compared += 1
            if len(have) == 2:
                (la, pa), (lb, pb) = have
                drift_l = max(drift_l, abs(float(la[0] - lb[0])))
                if pa.size:
                    drift_r = max(drift_r, float(np.abs(pa - pb).max()))
    if compared == 0:
        raise AssertionError(f"{tag}: no token compared")
    return {"tokens_compared": compared, "near_ties": ties,
            "drift_top1_logit": drift_l, "drift_router_prob": drift_r}


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(card: str) -> dict:
    """llama4-scout at full width (4 layers) through the paged engine,
    flash against plain decode, bf16."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    reduced = {"n_layers": [get_config(MOE_ARCH).n_layers, MOE_LAYERS]}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    reqs = sized_requests(cfg, MOE_REQUESTS, MOE_SERVE["max_seq"])
    kw = dict(max_batch=MOE_SERVE["max_batch"],
              max_seq=MOE_SERVE["max_seq"], page_size=MOE_SERVE["page_size"])
    engine(params, cfg, "cuda", **kw).run_closed_loop(reqs[:2])   # warm-up
    # the main path: counters reset just before, read just after
    eng = engine(params, cfg, "cuda", **kw)
    step_s = []
    eng._step_decode = timed_call(eng._step_decode, step_s)
    runtime.reset_counters()
    st = eng.run_closed_loop(reqs)
    torch.cuda.synchronize()
    launches = fd_ops.COUNTER.count
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or launches != MOE_LAYERS * st.decode_dispatches:
        raise AssertionError(f"[moe] flash_decode launched {launches} times "
                             f"over {st.decode_dispatches} decode dispatches "
                             f"x {MOE_LAYERS} layers")
    by_rid = {r.rid: r for r in reqs}
    if st.n_requests != len(reqs):
        raise AssertionError(f"[moe] served {st.n_requests}/{len(reqs)}")
    for c in st.completions:
        if c.tokens.shape != (by_rid[c.rid].max_new,) \
                or c.tokens.min() < 0 or c.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"[moe] request {c.rid}: bad stream")
    # the same schedule again, recorded: flash (capturing the kernel's
    # arguments at the step with the most live KV) and plain
    cur, capture = {}, {}
    with decode_probes(cur):
        ef = engine(params, cfg, "cuda", **kw)
        rec_f = record_decode(ef, cur, capture)
        sf = ef.run_closed_loop(reqs)
        ep = engine(params, cfg, "cuda", kernel="plain", **kw)
        rec_p = record_decode(ep, cur)
        sp = ep.run_closed_loop(reqs)
    # the kernel on the captured live step, every layer, against its
    # plain version (not counted: the counters were read above)
    calls = capture["calls"]
    if len(calls) != MOE_LAYERS:
        raise AssertionError(f"[moe] captured {len(calls)} flash-decode "
                             f"calls for one step, expected {MOE_LAYERS}")
    errs = [check(f"[moe] live step layer {i} ({capture['live_tokens']} "
                  f"live KV tokens)/bf16", a, torch.bfloat16)
            for i, a in enumerate(calls)]
    case = {k: torch.stack([a[k] for a in calls])
            for k in ("q", "kpool", "vpool")}
    case.update({k: calls[0][k] for k in ("page_map", "pos", "live")})
    if streams(sf) != streams(st):
        raise AssertionError("[moe] two flash runs of one schedule differ")
    cmp = recorded_compare(streams(st), streams(sp), (rec_f, rec_p),
                           "[moe] flash vs plain", logit_tie=LOGIT_TIE_BF16,
                           router_tie=ROUTER_TIE_BF16,
                           k=cfg.moe.experts_per_token)
    timing = time_flash_decode(case, card)
    del case, calls, capture
    res = {
        "arch": MOE_ARCH, "reduced": reduced, "n_params": n_params,
        "dtype": cfg.param_dtype, "init_s": init_s,
        "requests": st.n_requests, "gen_tokens": st.gen_tokens,
        "tokens_per_s": st.tokens_per_s, "plain_tokens_per_s":
        sp.tokens_per_s, "decode_steps": st.decode_dispatches,
        "decode_step_ms": 1e3 * float(np.mean(step_s)),
        "decode_step_ms_median": 1e3 * float(np.median(step_s)),
        "launches": launches, "peak_mem_bytes": peak,
        "prefill_chunks": st.prefill_chunks,
        "max_abs_err": max(e[0] for e in errs),
        "max_row_rel_err": max(e[1] for e in errs), "timing": timing,
        "logit_tie": LOGIT_TIE_BF16, "router_tie": ROUTER_TIE_BF16, **cmp}
    print(f"[moe] {MOE_ARCH} full width (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.experts_per_token} + shared, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}), reduced: n_layers "
          f"{reduced['n_layers'][0]} -> {MOE_LAYERS}; {n_params / 1e9:.2f} G "
          f"params, init {init_s:.1f} s; paged ps={kw['page_size']} "
          f"{kw['max_batch']} x {kw['max_seq']}, {st.n_requests} requests, "
          f"{st.gen_tokens} tokens: flash {st.tokens_per_s:.1f} tok/s, "
          f"decode step {res['decode_step_ms']:.2f} ms mean "
          f"({res['decode_step_ms_median']:.2f} median) over {len(step_s)}; "
          f"plain {sp.tokens_per_s:.1f} tok/s; flash_decode launches "
          f"{launches} = {MOE_LAYERS} x {st.decode_dispatches} decode "
          f"dispatches; peak mem {peak / 2**30:.2f} GiB | {card}")
    print(f"[moe] streams flash = plain on {cmp['tokens_compared']} tokens, "
          f"{len(cmp['near_ties'])} requests stopped at a near-tie flip "
          f"(token: both top-2 logit gaps < {LOGIT_TIE_BF16:g}; routing: "
          f"both router gaps < {ROUTER_TIE_BF16:g}); drift "
          f"over compared tokens: top-1 logit {cmp['drift_top1_logit']:.2e},"
          f" router prob {cmp['drift_router_prob']:.2e}")
    del params, eng, ef, ep
    free_card()
    return res


def same_params(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a.parameters(), b.parameters()))


def phase_moe_small(card: str) -> dict:
    """The reduced llama4 (top-1 + shared) and arctic (top-2 + dense
    residual), f32, card against CPU."""
    out = {}
    for name in SMALL_MOE_ARCHS:
        cfg = get_config(name).reduced()
        ties = dict(logit_tie=GAP_TIE, router_tie=ROUTER_TIE_F32,
                    k=cfg.moe.experts_per_token)
        reqs = sized_requests(cfg, 16, SMALL_SERVE["max_seq"])
        pc = tf.init_params(cfg, seed=0, device="cpu")
        pg = tf.init_params(cfg, seed=0, device="cuda")
        if not same_params(pc, pg):
            raise AssertionError(f"[moe-small] {name}: init_params differs "
                                 f"between the card and the CPU")
        res, cur = {}, {}
        with decode_probes(cur):
            runs = {}
            for dev, p in (("cpu", pc), ("cuda", pg)):
                for paged in (False, True):
                    e = engine(p, cfg, dev, **dict(
                        SMALL_SERVE, page_size=SMALL_SERVE["page_size"]
                        if paged else 0))
                    rec = record_decode(e, cur)
                    runs[dev, paged] = (streams(e.run_closed_loop(reqs)),
                                        rec)
            for paged in (False, True):
                (g, rg), (c, rc) = runs["cuda", paged], runs["cpu", paged]
                res["paged" if paged else "dense"] = recorded_compare(
                    g, c, (rg, rc), f"[moe-small] {name} card vs CPU",
                    **ties)
            base, rbase = runs["cuda", True]
            # the sort dispatch
            scfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="sort"))
            e = engine(pg, scfg, "cuda", **SMALL_SERVE)
            rs = record_decode(e, cur)
            res["sort"] = recorded_compare(
                streams(e.run_closed_loop(reqs)), base, (rs, rbase),
                f"[moe-small] {name} sort vs einsum", **ties)
            # speculation: a dense 1-layer draft and a MoE 1-layer draft
            for kind in ("dense", "moe"):
                dcfg = dataclasses.replace(cfg, name=f"{name}-draft",
                                           n_layers=1)
                if kind == "dense":
                    dcfg = dataclasses.replace(dcfg, arch_type="dense",
                                               moe=None)
                spec = SpeculativeConfig(
                    draft_params=tf.init_params(dcfg, seed=2, device="cuda"),
                    draft_cfg=dcfg, k=SPEC_K, window=SPEC_WINDOW)
                e = engine(pg, cfg, "cuda", speculative=spec, **SMALL_SERVE)
                sst = e.run_closed_loop(reqs)
                if sst.drafted == 0:
                    raise AssertionError(f"[moe-small] {name}: no draft")
                res[f"spec_{kind}_draft"] = dict(recorded_compare(
                    streams(sst), base, (rbase,),
                    f"[moe-small] {name} {kind} draft vs greedy", **ties),
                    drafted=sst.drafted, accepted=sst.accepted)
            # a tight capacity: prefill chunks drop tokens
            tcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=1.0))
            dropped = []
            dispatch = moe_mod.dispatch_combine

            def counting(x, gates, idx, c, cap, dtype=None):
                disp, comb = dispatch(x, gates, idx, c, cap, dtype)
                dropped.append(idx.numel() - int(disp.sum()))
                return disp, comb
            moe_mod.dispatch_combine = counting
            try:
                tight = {}
                for dev, p in (("cpu", pc), ("cuda", pg)):
                    dropped.clear()
                    e = engine(p, tcfg, dev, **SMALL_SERVE)
                    rec = record_decode(e, cur)
                    tight[dev] = (streams(e.run_closed_loop(reqs)), rec,
                                  sum(dropped))
            finally:
                moe_mod.dispatch_combine = dispatch
            if not tight["cuda"][2] or tight["cuda"][2] != tight["cpu"][2]:
                raise AssertionError(f"[moe-small] {name} capacity 1.0: "
                                     f"dropped {tight['cuda'][2]} on the "
                                     f"card, {tight['cpu'][2]} on the CPU")
            res["tight"] = dict(recorded_compare(
                tight["cuda"][0], tight["cpu"][0],
                (tight["cuda"][1], tight["cpu"][1]),
                f"[moe-small] {name} capacity 1.0 card vs CPU", **ties),
                dropped=tight["cuda"][2])
        out[name] = res
        print(f"[moe-small] {name}.reduced() f32, card = CPU: engine "
              f"streams dense {res['dense']['tokens_compared']} / paged "
              f"{res['paged']['tokens_compared']} tokens; sort = einsum on "
              f"{res['sort']['tokens_compared']}; dense draft "
              f"({res['spec_dense_draft']['accepted']}/"
              f"{res['spec_dense_draft']['drafted']} accepted) and MoE "
              f"draft ({res['spec_moe_draft']['accepted']}/"
              f"{res['spec_moe_draft']['drafted']}) = greedy; capacity 1.0: "
              f"{res['tight']['dropped']} choices dropped on both, streams "
              f"equal on {res['tight']['tokens_compared']}; near ties "
              f"{sum(len(v['near_ties']) for v in res.values())} | {card}")
    return out


def oneshot_logits(fn, rec: list):
    """``tf.prefill`` / ``tf.decode_step`` recording each call's last
    logits column (B, V) on the CPU and its seconds (synced)."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*a, **kw)
        torch.cuda.synchronize()
        rec.append((time.perf_counter() - t0, logits[:, -1].float().cpu()))
        return logits, cache
    return call


def run_oneshot(params, cfg):
    """``launch.serve``'s single-shot path (``_serve_oneshot``: 4 x 24
    prompts from ``--seed 0``, with a VLM's patch or the audio family's
    frame embeddings, 12 generated) with the prefill and every lockstep
    decode step recorded. Returns (tokens (4, 12) CPU, [(seconds, logits
    (4, V))] per step, the launcher's output)."""
    rec = []
    prefill, decode_step = serve_mod.tf.prefill, serve_mod.tf.decode_step
    serve_mod.tf.prefill = oneshot_logits(prefill, rec)
    serve_mod.tf.decode_step = oneshot_logits(decode_step, rec)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            out = serve_mod._serve_oneshot(params, cfg,
                                           argparse.Namespace(seed=0))
    finally:
        serve_mod.tf.prefill, serve_mod.tf.decode_step = prefill, decode_step
    return out, rec, log.getvalue()


def growing_forward(params, cfg, prompts: np.ndarray, out: torch.Tensor,
                    **kw) -> torch.Tensor:
    """The cacheless greedy reference of ``serve_batch``'s tokens: for
    each generated position t, a ``forward`` over the prompt and the
    first t tokens (with the same ``prefix=`` / ``frames=``; an audio
    model's encoder runs again each time), its last column's logits:
    (B, G, V) float32, CPU."""
    dev = params["embed"].device
    seq = torch.cat([torch.tensor(prompts), out], dim=1).to(dev)
    kw = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}
    P, G = prompts.shape[1], out.shape[1]
    with torch.inference_mode():
        return torch.stack([tf.forward(params, cfg, seq[:, :P + t],
                                       remat=False, **kw)[0][:, -1]
                            .float().cpu() for t in range(G)], dim=1)


def phase_ssm(card: str, name: str) -> dict:
    """mamba2-780m / zamba2-7b (and since slice 11 paligemma-3b /
    whisper-large-v3) at full width and depth through the launcher's
    single-shot path: in the config's bf16 (timed), then in float32,
    where the tokens are held against a cacheless forward over the
    growing sequence (the recurrent decode and its conv ring against the
    chunked scan; the KV caches, the VLM's prefix offset and the audio
    decoder's cross K/V against whole-sequence attention). In bf16 the
    two paths' rounding parts their logits by O(std) within a few steps
    at this depth (PERF.md §6), so there the drift is printed, not
    gated."""
    base = get_config(name)
    res = {"arch": name}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, param_dtype=dtype, activ_dtype=dtype)
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if dtype == "bfloat16":
            run_oneshot(params, cfg)                        # warm-up
        out, rec, log = run_oneshot(params, cfg)
        peak = torch.cuda.max_memory_allocated()
        B, G = out.shape
        prompts, kw = serve_mod.oneshot_inputs(cfg, 0)
        if (B, G) != (serve_mod.ONESHOT_BATCH, serve_mod.ONESHOT_GEN) \
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size \
                or not all(bool(torch.isfinite(r[1]).all()) for r in rec):
            raise AssertionError(f"[{base.arch_type}] {name} {dtype}: "
                                 f"tokens {tuple(out.shape)} or logits bad")
        fl = growing_forward(params, cfg, prompts, out, **kw)
        sl = torch.stack([r[1] for r in rec], dim=1)            # (B, G, V)
        drift = (fl - sl).abs().amax(dim=(0, 2)).tolist()       # per step
        r = {"n_params": sum(q.numel() for q in params.parameters()),
             "init_s": init_s, "prefill_ms": 1e3 * rec[0][0],
             "decode_ms_median": 1e3 * float(np.median([x[0]
                                                        for x in rec[1:]])),
             "decode_steps": len(rec) - 1, "peak_mem_bytes": peak,
             "drift_per_step": drift,
             "launcher": log.strip().splitlines()}
        if dtype == "float32":
            top_f = torch.topk(fl, 2, dim=-1).values.numpy()
            top_s = torch.topk(sl, 2, dim=-1).values.numpy()
            recs = [{(b, t): (top[b, t], np.zeros((0, 0))) for b in range(B)
                     for t in range(G)} for top in (top_s, top_f)]
            r.update(recorded_compare(
                {b: out[b].tolist() for b in range(B)},
                {b: fl[b].argmax(-1).tolist() for b in range(B)}, recs,
                f"[{base.arch_type}] {name} f32 serve_batch vs forward",
                logit_tie=SSM_TIE_F32, router_tie=0.0))
        res[dtype] = r
        del params, fl, sl
    bf, f32r = res["bfloat16"], res["float32"]
    depth = f"{base.n_encoder_layers} + {base.n_layers}" if base.enc_dec \
        else f"{base.n_layers}"
    extra = {"vlm": f", {base.n_prefix_tokens} patch tokens",
             "audio": f", {base.encoder_seq} frames"}.get(base.arch_type, "")
    print(f"[{base.arch_type}] {name} full width, full depth ({depth} "
          f"layers, d {base.d_model}{extra}, {bf['n_params']} params) "
          f"through the launcher's single-shot path ({B} x "
          f"{serve_mod.ONESHOT_PROMPT}, {G} generated): bf16 init "
          f"{bf['init_s']:.1f} s, prefill {bf['prefill_ms']:.1f} ms, lockstep "
          f"step {bf['decode_ms_median']:.2f} ms median over "
          f"{bf['decode_steps']}, peak mem {bf['peak_mem_bytes'] / 2**30:.2f} "
          f"GiB, logits vs the growing forward {bf['drift_per_step'][0]:.1e} "
          f"at the prefill, up to {max(bf['drift_per_step']):.2f} decoding; "
          f"f32: tokens = the growing forward on {f32r['tokens_compared']} of "
          f"{B * G}, {len(f32r['near_ties'])} near ties (gaps < "
          f"{SSM_TIE_F32:g}), logits within {max(f32r['drift_per_step']):.1e}"
          f", step {f32r['decode_ms_median']:.2f} ms, peak mem "
          f"{f32r['peak_mem_bytes'] / 2**30:.2f} GiB | {card}")
    free_card()
    return res


def phase_ssm_small(card: str) -> dict:
    """The reduced mamba2 and zamba2, f32: the single-shot path card
    against CPU."""
    out = {}
    for name in SSM_ARCHS:
        cfg = get_config(name).reduced()
        runs = {}
        for dev in ("cpu", "cuda"):
            runs[dev] = (tf.init_params(cfg, seed=0, device=dev),)
            runs[dev] += run_oneshot(runs[dev][0], cfg)[:2]
        if not same_params(runs["cpu"][0], runs["cuda"][0]):
            raise AssertionError(f"[ssm-small] {name}: init_params differs "
                                 f"between the card and the CPU")
        (_, tg, lg), (_, tc, lc) = runs["cuda"], runs["cpu"]
        err = max(float((a[1] - b[1]).abs().max()) for a, b in zip(lg, lc))
        if not torch.equal(tg, tc) or not err <= SSM_TOL:
            raise AssertionError(f"[ssm-small] {name}: tokens equal "
                                 f"{torch.equal(tg, tc)}, logits max |card "
                                 f"- CPU| {err} (bound {SSM_TOL})")
        out[name] = {"max_abs_err": err, "tokens": tg.numel()}
        print(f"[ssm-small] {name}.reduced() f32, the single-shot path: "
              f"tokens card = CPU ({tg.numel()}), logits max |card - CPU| "
              f"{err:.2e} over {len(lg)} steps (bound {SSM_TOL:g}) | {card}")
    return out

# ---------------------------------------------------------------------------
# slice 11: the VLM and audio families
# ---------------------------------------------------------------------------
VLM_AUDIO_ARCHS = ("paligemma-3b", "whisper-large-v3")
# [c7-small]: the reduced VLM's ragged steps from a ragged prefill of
# these text lengths (row 3 dead), over a slot cache of RAGGED_T tokens
# and a pool of RAGGED_PAGE-token pages, RAGGED_STEPS steps
RAGGED_LENGTHS = (24, 20, 17, 24)
RAGGED_T, RAGGED_PAGE, RAGGED_STEPS = 64, 16, 4


def vlm_ragged_arms(params, cfg) -> dict:
    """The reduced VLM's ragged decode steps on the card, flash arm
    against plain arm on the same tokens (the plain arm's argmax): over
    the dense slot cache (``decode_step_ragged``, the kernel reading each
    row as pages under an identity map) and over a page pool
    (``decode_step_ragged_paged_flash`` against
    ``decode_step_ragged_paged``; a dead row's write map out of the
    pool, as the engine maps it). Returns the flash steps' launches
    (counters reset just before, read just after), the largest |flash -
    plain| over live rows' logits and over the caches, and whether the
    first layer's caches (written from equal inputs) are equal."""
    dev = params["embed"].device
    prompts, kw = serve_mod.oneshot_inputs(cfg, 0)
    B = prompts.shape[0]
    lengths = torch.tensor(RAGGED_LENGTHS, device=dev)
    live = torch.tensor([True, True, True, False], device=dev)
    with torch.inference_mode():
        logits, cache = tf.prefill(
            params, cfg, torch.tensor(prompts, device=dev),
            prefix=torch.tensor(kw["prefix"], device=dev),
            cache_len=RAGGED_T, lengths=lengths)
        kv = {n: cache["layers"][n] for n in ("k", "v")}
        nb = RAGGED_T // RAGGED_PAGE
        rmap = torch.arange(B * nb, dtype=torch.int32,
                            device=dev).reshape(B, nb)
        wmap = torch.where(live[:, None], rmap, B * nb).to(torch.int32)

        def dense():
            return {"layers": {n: t.clone() for n, t in kv.items()}}

        def pool():
            return {"layers": {n: t.reshape(t.shape[0], B * nb, RAGGED_PAGE,
                                            *t.shape[3:]).clone()
                               for n, t in kv.items()}}
        arms = {"dense": (dense(), dense()), "paged": (pool(), pool())}
        tok = serve_mod.greedy_sample(logits)
        err = 0.0
        runtime.reset_counters()
        for t in range(RAGGED_STEPS):
            pos = lengths + cfg.n_prefix_tokens + t
            lp, _ = tf.decode_step_ragged(params, cfg, tok, pos,
                                          arms["dense"][0], live)
            lf, _ = tf.decode_step_ragged(params, cfg, tok, pos,
                                          arms["dense"][1], live, flash=True)
            pp, _ = tf.decode_step_ragged_paged(
                params, cfg, tok, pos, arms["paged"][0], live, rmap, wmap)
            pf, _ = tf.decode_step_ragged_paged_flash(
                params, cfg, tok, pos, arms["paged"][1], live, rmap, wmap)
            for a, b in ((lf, lp), (pf, pp), (pp, lp)):
                err = max(err, float((a[live] - b[live]).abs().max()))
            tok = serve_mod.greedy_sample(lp)
        launches = fd_ops.COUNTER.count
    # the first layer writes the same k/v in both arms; later layers'
    # inputs carry the kernel's rounding
    first_equal = all(torch.equal(a["layers"][n][0], b["layers"][n][0])
                      for a, b in arms.values() for n in ("k", "v"))
    cache_err = max(float((a["layers"][n] - b["layers"][n]).abs().max())
                    for a, b in arms.values() for n in ("k", "v"))
    return {"launches": launches, "max_abs_err": err,
            "first_layer_cache_equal": first_equal, "cache_err": cache_err}


def phase_c7_small(card: str) -> dict:
    """The reduced paligemma and whisper, f32: card against CPU, then the
    VLM's ragged flash arm against its plain arm on the card."""
    out = {}
    for name in VLM_AUDIO_ARCHS:
        cfg = get_config(name).reduced()
        prompts, kw = serve_mod.oneshot_inputs(cfg, 0)
        runs = {}
        for dev in ("cpu", "cuda"):
            params = tf.init_params(cfg, seed=0, device=dev)
            with torch.inference_mode():
                fwd, _ = tf.forward(
                    params, cfg, torch.tensor(prompts, device=dev),
                    remat=False, **{k: torch.tensor(v, device=dev)
                                    for k, v in kw.items()})
            runs[dev] = (params, fwd.cpu()) + run_oneshot(params, cfg)[:2]
        if not same_params(runs["cpu"][0], runs["cuda"][0]):
            raise AssertionError(f"[c7-small] {name}: init_params differs "
                                 f"between the card and the CPU")
        (_, fg, tg, lg), (_, fc, tc, lc) = runs["cuda"], runs["cpu"]
        ferr = float((fg - fc).abs().max())
        err = max(float((a[1] - b[1]).abs().max()) for a, b in zip(lg, lc))
        if not torch.equal(tg, tc) or not max(err, ferr) <= SSM_TOL:
            raise AssertionError(
                f"[c7-small] {name}: tokens equal {torch.equal(tg, tc)}, "
                f"forward logits max |card - CPU| {ferr}, single-shot "
                f"logits {err} (bound {SSM_TOL})")
        out[name] = {"forward_max_abs_err": ferr, "max_abs_err": err,
                     "tokens": tg.numel()}
        print(f"[c7-small] {name}.reduced() f32: forward logits max |card "
              f"- CPU| {ferr:.2e}; single-shot tokens card = CPU "
              f"({tg.numel()}), logits {err:.2e} over {len(lg)} steps "
              f"(bound {SSM_TOL:g}) | {card}")
        if cfg.arch_type == "vlm":
            arms = vlm_ragged_arms(runs["cuda"][0], cfg)
            want = cfg.n_layers * RAGGED_STEPS * 2
            if arms["launches"] != want \
                    or not arms["first_layer_cache_equal"] \
                    or not max(arms["max_abs_err"], arms["cache_err"]) \
                    <= TOL[torch.float32]:
                raise AssertionError(f"[c7-small] {name} ragged flash arm: "
                                     f"{arms} (want {want} launches, "
                                     f"logits within {TOL[torch.float32]})")
            out["ragged"] = arms
            print(f"[c7-small] {name} ragged decode, {RAGGED_STEPS} steps "
                  f"from text lengths {RAGGED_LENGTHS} after "
                  f"{cfg.n_prefix_tokens} patches (row 3 dead): flash arm "
                  f"(slot cache, {RAGGED_PAGE}-token page pool) = plain arm "
                  f"within {arms['max_abs_err']:.2e}, caches "
                  f"{arms['cache_err']:.2e} (bound {TOL[torch.float32]:g}; "
                  f"the first layer's bit for bit); flash_decode "
                  f"launched {arms['launches']} = {cfg.n_layers} layers x "
                  f"{RAGGED_STEPS} steps x 2 arms | {card}")
    return out


# ---------------------------------------------------------------------------
# slice 12: the elastic mesh engine trains the LM (launch.train's mesh path)
# ---------------------------------------------------------------------------
# examples/train_e2e.py's 100m preset, churned; AdaGrad at 0.003 (the
# default 0.05 oscillates at full width and is run ungated)
MESH_STEPS, MESH_BATCH, MESH_SEQ, MESH_WORKERS = 300, 8, 256, 4
MESH_CHURN = "100:leave:1,200:join:1"
MESH_LIVE = [4] * 100 + [3] * 100 + [4] * 100
MESH_TOL = 1e-4                 # card against CPU at reduced width
MESH_FAMILIES = ("qwen3-4b", "llama4-scout-17b-a16e", "mamba2-780m",
                 "zamba2-7b", "paligemma-3b", "whisper-large-v3")


@contextlib.contextmanager
def captured_mesh_runs(runs: list):
    """``launch.train.run_mesh`` wrapped so that ``main`` hands its
    ``MeshRun`` (engine, losses, timings) to ``runs`` as well."""
    orig = train_mod.run_mesh

    def run_mesh(*a, **kw):
        runs.append(orig(*a, **kw))
        return runs[-1]

    train_mod.run_mesh = run_mesh
    try:
        yield
    finally:
        train_mod.run_mesh = orig


def spread(xs) -> str:
    xs = sorted(xs)
    return f"median {xs[len(xs) // 2]:.2f} (range {xs[0]:.2f}-{xs[-1]:.2f})"


def reduced_batch(cfg, B: int, S: int, seed: int) -> dict:
    """tokens / labels / mask from one RandomState, plus a VLM's prefix
    or the audio family's frames (numpy)."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": np.ones((B, S), np.float32)}
    out["mask"][-1, S // 2:] = 0.0
    extra = {"vlm": ("prefix", cfg.n_prefix_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    if extra:
        name, n = extra
        out[name] = (rs.standard_normal((B, n, cfg.d_model)) * 0.02
                     ).astype(np.float32)
    return out


def leaf_errs(a, b) -> tuple:
    """(largest |a - b| over the leaves, largest per-leaf ||a - b|| /
    ||b||) between two param trees."""
    abs_err = rel = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.detach().double().cpu(), y.detach().double().cpu()
        abs_err = max(abs_err, float((x - y).abs().max()))
        rel = max(rel, float((x - y).norm() / y.norm().clamp_min(1e-30)))
    return abs_err, rel


def update_errs(a, b, p0) -> tuple:
    """Two runs' updates from the same start ``p0``: (largest per-leaf
    ||(a - p0) - (b - p0)|| / ||b - p0||, the update's size
    ||b - p0|| / ||p0|| over all leaves). Gating the update, not the
    params, keeps the shared start from hiding a fault in it."""
    rel = num = den = 0.0
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(p0)):
        x, y, z = (t.detach().double().cpu() for t in (x, y, z))
        du = float((y - z).norm())
        rel = max(rel, float(((x - z) - (y - z)).norm()) / max(du, 1e-30))
        num += du ** 2
        den += float(z.norm()) ** 2
    return rel, (num / den) ** 0.5


def mesh_small(device: str) -> dict:
    """The reduced qwen3 through ``ElasticMeshSGD`` (B 8, S 16, 4
    workers, sgd 0.1): 4 steps, leave(2), a step, join(2), a step."""
    cfg = get_config("qwen3-4b").reduced()
    opt = sgd(lr=0.1)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=False),
        state=make_train_state(tf.init_params(cfg, seed=0, device=device),
                               opt), n_workers=4, global_batch=8)
    batch = reduced_batch(cfg, 8, 16, seed=1)
    del batch["mask"]
    masks = []
    for i in range(6):
        if i == 4:
            eng.leave(2)
        if i == 5:
            eng.join(2)
        masks.append(eng.work_mask(16).cpu())
        eng.step(batch)
    return {"history": eng.history, "masks": masks,
            "params": eng.state["params"]}


def family_steps(name: str, device: str) -> tuple:
    """Two sgd steps of ``build_train_step`` (aux weight 0.01) on the
    reduced ``name``: (metrics as floats, params)."""
    cfg = get_config(name).reduced()
    opt = sgd(lr=0.1)
    step = build_train_step(cfg, opt, remat=False)
    st = make_train_state(tf.init_params(cfg, seed=0, device=device), opt)
    ms = []
    for i in range(2):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in reduced_batch(cfg, 2, 8, seed=20 + i).items()}
        st, m = step(st, b)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, st["params"]


def phase_mesh_train(card: str) -> dict:
    """``launch.train`` without ``--simulate`` at full width: the gated
    300-step churned run, its closure reloaded and served, the default lr
    for 20 steps (printed), remat against none, then card against CPU at
    reduced width."""
    # the closure is ~0.54 GB of base64: too large for chiprun_out/
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    path = str(build / "mesh_train_closure.json")
    runs = []
    free_card()
    runtime.reset_counters()
    t0 = time.perf_counter()
    with captured_mesh_runs(runs):
        rc = train_mod.main([
            "--arch", ARCH, "--steps", str(MESH_STEPS), "--batch",
            str(MESH_BATCH), "--seq", str(MESH_SEQ), "--n-workers",
            str(MESH_WORKERS), "--lr", "0.003", "--churn", MESH_CHURN,
            "--log-every", "50", "--closure-out", path])
    main_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in runtime.COUNTERS.items()}
    run = runs[-1]
    hist = run.engine.history
    losses = np.array([h["loss"] for h in hist])
    live = [h["n_live"] for h in hist]
    tokens = [h["tokens"] for h in hist]
    want_tokens = [MESH_BATCH * MESH_SEQ * n // MESH_WORKERS
                   for n in MESH_LIVE]
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    if rc != 0 or len(hist) != MESH_STEPS:
        raise AssertionError(f"[mesh-train] main returned {rc} after "
                             f"{len(hist)} steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"[mesh-train] non-finite loss at steps "
                             f"{np.flatnonzero(~np.isfinite(losses))[:10]}")
    if live != MESH_LIVE or tokens != want_tokens:
        bad = [i for i in range(MESH_STEPS)
               if (live[i], tokens[i]) != (MESH_LIVE[i], want_tokens[i])]
        raise AssertionError(f"[mesh-train] live / tokens off at steps "
                             f"{bad[:10]}: {[(live[i], tokens[i]) for i in bad[:10]]}")
    if not last < first:
        raise AssertionError(f"[mesh-train] loss did not fall: first 20 "
                             f"mean {first}, last 20 {last}")
    if any(launches.values()):
        raise AssertionError(f"[mesh-train] the training path launched "
                             f"kernels: {launches}")
    # the closure, reloaded, serves what the in-memory params serve
    clo = ResearchClosure.load(path)
    Path(path).unlink()
    params = torchify(clo.params, "cuda")
    held = run.engine.state["params"]
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(held))):
        raise AssertionError("[mesh-train] the reloaded closure's params "
                             "differ from the trained ones")
    prompts = np.random.RandomState(5).randint(
        0, clo.config.vocab_size, (8, 32)).astype(np.int32)
    served = serve_mod.serve_batch(params, clo.config, prompts, 16)
    want = serve_mod.serve_batch(held, get_config(ARCH), prompts, 16)
    if not torch.equal(served, want):
        raise AssertionError("[mesh-train] the reloaded closure serves "
                             "other tokens than the in-memory params")
    print(f"[mesh-train] {ARCH} full width, {MESH_STEPS} steps of "
          f"{MESH_BATCH} x {MESH_SEQ}, {MESH_WORKERS} workers churned "
          f"{MESH_CHURN!r}, AdaGrad lr 0.003: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first 20 mean {first:.4f}, last 20 "
          f"{last:.4f}), tokens {want_tokens[0]} / {min(want_tokens)} at "
          f"4 / 3 live, kernel launches "
          f"{launches}; closure reloaded serves 8 x 32 -> 16 tokens equal "
          f"to the trained params | {card}")
    tok_s = 1e3 * sum(tokens) / sum(run.host_ms)
    steady = 1e3 * tokens[0] / sorted(run.host_ms)[len(run.host_ms) // 2]
    print(f"[mesh-train] ms per step: {spread(run.step_ms)} CUDA events, "
          f"{spread(run.host_ms)} host (ending in the metrics' host copy; "
          f"the first step warms up); {tok_s:.0f} tokens/s over the run, "
          f"{steady:.0f} at the median step of 4 workers; peak memory "
          f"{run.peak_mem_bytes / 2**30:.2f} GiB; main {main_s:.1f} s "
          f"| {card}")
    res = {"losses": losses.tolist(), "step_ms": run.step_ms,
           "host_ms": run.host_ms, "peak_mem_bytes": run.peak_mem_bytes,
           "tokens_per_s": tok_s, "tokens_per_s_median_step": steady,
           "first20": first, "last20": last, "launches": launches,
           "main_s": main_s}
    del run, runs, params, held, clo
    free_card()
    # the reference's default (AdaGrad 0.05) for 20 steps: printed only
    runs = []
    with captured_mesh_runs(runs):
        train_mod.main(["--arch", ARCH, "--steps", "20", "--batch",
                        str(MESH_BATCH), "--seq", str(MESH_SEQ),
                        "--log-every", "20"])
    res["default_lr_losses"] = runs[-1].losses
    print(f"[mesh-train] default lr 0.05, 20 steps (not gated): "
          + " ".join(f"{x:.3f}" for x in runs[-1].losses) + f" | {card}")
    del runs
    free_card()
    # remat against none at full width, 10 steps each
    for remat in (False, True):
        r = train_mod.run_mesh(get_config(ARCH), steps=10, batch=MESH_BATCH,
                               seq=MESH_SEQ, lr=0.003, remat=remat,
                               log_every=100)
        res[f"remat_{remat}"] = {"step_ms": r.step_ms, "host_ms": r.host_ms,
                                 "peak_mem_bytes": r.peak_mem_bytes,
                                 "losses": r.losses}
        print(f"[mesh-train] remat={remat}: ms per step "
              f"{spread(r.step_ms)} CUDA events, {spread(r.host_ms)} host; "
              f"peak memory {r.peak_mem_bytes / 2**30:.2f} GiB | {card}")
        del r
        free_card()
    a, b = (res[f"remat_{x}"]["losses"] for x in (False, True))
    remat_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if not remat_rel <= MESH_TOL:
        raise AssertionError(f"[mesh-train] remat changed the losses: "
                             f"{remat_rel} relative")
    res["remat_loss_rel"] = remat_rel
    # card against CPU at reduced width, sgd
    g, c = mesh_small("cuda"), mesh_small("cpu")
    for i, (mg, mc) in enumerate(zip(g["masks"], c["masks"])):
        if not torch.equal(mg, mc):
            raise AssertionError(f"[mesh-train] engine mask {i}: card != CPU")
    if [(h["tokens"], h["n_live"]) for h in g["history"]] != \
            [(h["tokens"], h["n_live"]) for h in c["history"]]:
        raise AssertionError("[mesh-train] engine tokens / live: card != CPU")
    loss_rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                   for x, y in zip(g["history"], c["history"]))
    p_abs, p_rel = leaf_errs(g["params"], c["params"])
    if not (loss_rel <= MESH_TOL and p_rel <= MESH_TOL):
        raise AssertionError(f"[mesh-train] engine card vs CPU: loss "
                             f"{loss_rel}, params {p_rel} relative (bound "
                             f"{MESH_TOL})")
    res["engine_small"] = {"loss_rel": loss_rel, "param_rel": p_rel,
                           "param_abs": p_abs}
    print(f"[mesh-train] qwen3-4b.reduced() engine (4 steps, leave, join), "
          f"sgd: masks, tokens, live card = CPU; loss {loss_rel:.2e}, params "
          f"{p_rel:.2e} relative (bound {MESH_TOL:g}) | {card}")
    fam = {}
    for name in MESH_FAMILIES:
        (mg, pg), (mc, pc) = family_steps(name, "cuda"), \
            family_steps(name, "cpu")
        l_rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                    for x, y in zip(mg, mc) for k in ("loss", "total_loss"))
        a_abs = max(abs(x["aux_loss"] - y["aux_loss"]) for x, y in zip(mg, mc))
        tok_eq = [x["tokens"] for x in mg] == [y["tokens"] for y in mc]
        p_abs, p_rel = leaf_errs(pg, pc)
        if not (tok_eq and l_rel <= MESH_TOL and a_abs <= MESH_TOL
                and p_abs <= MESH_TOL):
            raise AssertionError(
                f"[mesh-train] {name} train step card vs CPU: tokens equal "
                f"{tok_eq}, loss {l_rel} rel, aux {a_abs}, params {p_abs} "
                f"(bound {MESH_TOL})")
        fam[name] = {"loss_rel": l_rel, "aux_abs": a_abs, "param_abs": p_abs}
    res["families"] = fam
    print(f"[mesh-train] build_train_step card = CPU, 2 sgd steps per "
          f"family (.reduced(), f32): " + ", ".join(
              f"{k} loss {v['loss_rel']:.1e} params {v['param_abs']:.1e}"
              for k, v in fam.items()) + f" (bound {MESH_TOL:g}) | {card}")
    return res


# ---------------------------------------------------------------------------
# slice 13: the multi-device surface, 4 gloo ranks on the one card
# ---------------------------------------------------------------------------
DIST_RANKS = 4
DIST_N = 100_682_496            # mlitb-lm-100m's flat parameter buffer
DIST_BLOCK = 128
# rank 1: two NaNs in block 5; rank 2: block 7 all signed zeros and a
# magnitude tie in block 9; rank 3: a tie of opposite signs in block 11
DIST_SPECIALS = ([(1, 5 * 128 + 3, float("nan")),
                  (1, 5 * 128 + 9, float("nan"))]
                 + [(2, 7 * 128 + i, -0.0 if i % 2 else 0.0)
                    for i in range(128)]
                 + [(2, 9 * 128 + 4, 9.5), (2, 9 * 128 + 70, 9.5),
                    (3, 11 * 128 + 1, 9.5), (3, 11 * 128 + 2, -9.5)])
DIST_TOL = 1e-6                 # reduces against one-process references
MESH_DIST = ((2, 2), ("data", "model"))
MESH_DIST_SGD, MESH_DIST_ADAGRAD = 15, 10
MESH_DIST_CHURN = {5: [("leave", 1)], 10: [("join", 1)]}
MESH_DIST_LIVE = [4] * 5 + [3] * 5 + [4] * 5
MESH_DIST_LR = 0.01             # sgd: the params gate
# one sgd step whose update dwarfs the params, so that f32's resolution
# of the params does not hide the update: the update gate
MESH_DIST_STEP_LR = 1e4
MESH_DIST_TOL = 1e-5
NCCL_STEPS, NCCL_TOL = 10, 1e-6
# slice 14: MoE under a batch split, the experts split over `model`;
# llama4-scout at full width cut to 1 of 48 layers (bf16), 3 sgd steps
MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_STEPS = "llama4-scout-17b-a16e", 1, 3
MESH_MOE_LR = 0.01
MESH_MOE_LOSS_TOL, MESH_MOE_AUX_TOL = 2e-2, 1e-2    # bf16 (PR 20's rule)
# ... and at .reduced() widths in f32 under leave / join, each MoE impl
MESH_MOE_SMALL = dict(batch=8, seq=32, steps=6, lr=0.1,
                      churn={3: [("leave", 2)], 5: [("join", 2)]})
MESH_MOE_SMALL_TOL = 1e-5
MOE_IMPLS = ("einsum", "sort")


def mesh_moe_cfg(impl: str = None, reduced: bool = False):
    """``[mesh-moe]``'s config: llama4-scout cut to 1 layer, or its
    ``.reduced()``; ``impl`` an MoE impl."""
    cfg = get_config(MESH_MOE_ARCH)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg, n_layers=MESH_MOE_LAYERS)
    if impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


def single_engine_run(cfg, *, steps: int, lr: float, churn: dict,
                      batch: int, seq: int, device: str,
                      keep_params: bool = True):
    """The port's single-device engine as the ranks run it: ``cfg`` from
    seed 0, ``data_stream`` seed 0, sgd at ``lr``, 4 workers under
    ``churn``. Returns (history, the final params on the host, or None
    unless ``keep_params``)."""
    opt = sgd(lr=lr)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=False),
        state=make_train_state(tf.init_params(cfg, seed=0, device=device),
                               opt), n_workers=MESH_WORKERS,
        global_batch=batch)
    stream = train_mod.data_stream(cfg.vocab_size, batch, seq, 0,
                                   device=device)
    for i in range(steps):
        for kind, w in churn.get(i, []):
            getattr(eng, kind)(w)
        eng.step(next(stream))
    hist = eng.history
    params = tree_map(lambda x: x.detach().cpu(), eng.state["params"]) \
        if keep_params else None
    del eng
    free_card()
    return hist, params


def moe_history_gate(got, want, loss_tol: float, aux_tol: float,
                     what: str) -> tuple:
    """Tokens and live counts exact, losses within ``loss_tol``
    relative and aux within ``aux_tol``: (loss, aux) differences."""
    rel = history_gate(got, want, loss_tol, what)
    aux = max(abs(a["aux_loss"] - b["aux_loss"]) for a, b in zip(got, want))
    if not aux <= aux_tol:
        raise AssertionError(f"{what}: aux {aux} (bound {aux_tol})")
    return rel, aux


def single_mesh_run(steps: int, keep_at: int, lr: float = MESH_DIST_LR):
    """The port's single-device engine on the card, as the ranks run it:
    ``mlitb-lm-100m`` from seed 0, ``data_stream`` seed 0, sgd at ``lr``,
    the churn schedule. Returns (history, the initial params, params after
    ``keep_at`` steps, final params), the first two on the host."""
    cfg = get_config(ARCH)
    opt = sgd(lr=lr)
    params = tf.init_params(cfg, seed=0, device="cuda")
    p0 = tree_map(lambda x: x.detach().cpu(), params)
    eng = ElasticMeshSGD(
        train_step=build_train_step(cfg, opt, remat=False),
        state=make_train_state(params, opt), n_workers=MESH_WORKERS,
        global_batch=MESH_BATCH)
    del params
    stream = train_mod.data_stream(cfg.vocab_size, MESH_BATCH, MESH_SEQ, 0,
                                   device="cuda")
    kept = None
    for i in range(steps):
        for kind, w in MESH_DIST_CHURN.get(i, []):
            getattr(eng, kind)(w)
        eng.step(next(stream))
        if i + 1 == keep_at:
            kept = tree_map(lambda x: x.detach().cpu(),
                            eng.state["params"])
    return eng.history, p0, kept, eng.state["params"]


def history_gate(got, want, tol: float, what: str) -> float:
    """Tokens and live counts exact, losses within ``tol`` relative;
    returns the largest relative loss difference."""
    if [(h["tokens"], h["n_live"]) for h in got] != \
            [(h["tokens"], h["n_live"]) for h in want]:
        raise AssertionError(f"{what}: tokens / live differ: "
                             f"{[(h['tokens'], h['n_live']) for h in got]}")
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want)
              for k in ("loss", "total_loss"))
    if not rel <= tol:
        raise AssertionError(f"{what}: losses {rel} relative (bound {tol})")
    return rel


def single_moe_runs(card: str) -> dict:
    """``[mesh-moe]``'s single-device engines, run before the world (the
    full-width one would not fit beside it): llama4-scout cut to 1 layer
    in bf16 on the card, and the ``.reduced()`` f32 runs under leave /
    join with each MoE impl on the card and on the CPU."""
    t0 = time.perf_counter()
    cfg = mesh_moe_cfg()
    shape = InputShape("mesh-moe", MESH_SEQ, MESH_BATCH, "train")
    dr = run_dryrun(cfg, shape, mesh=Mesh(*MESH_DIST), optimizer_name="sgd",
                    remat=False)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    hist, _ = single_engine_run(cfg, steps=MESH_MOE_STEPS, lr=MESH_MOE_LR,
                                churn={}, batch=MESH_BATCH, seq=MESH_SEQ,
                                device="cuda", keep_params=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    sm = MESH_MOE_SMALL
    small = {(impl, dev): single_engine_run(
        mesh_moe_cfg(impl, reduced=True), steps=sm["steps"], lr=sm["lr"],
        churn=sm["churn"], batch=sm["batch"], seq=sm["seq"], device=dev)
        for impl in MOE_IMPLS for dev in ("cuda", "cpu")}
    print(f"[mesh-moe] reckoned before the world: {MESH_MOE_ARCH} at full "
          f"width, {MESH_MOE_LAYERS} of {get_config(MESH_MOE_ARCH).n_layers}"
          f" layers, bf16 ({cfg.n_params()} parameters), sgd, on (data 2, "
          f"model 2): per rank {dr['memory']['state_bytes']} bytes stored, "
          f"wire {dr['collectives']} a step (run_dryrun); the single-device "
          f"engine's peak {peak:.2f} GiB, so it runs before the world | "
          f"{card}")
    return {"cfg": cfg, "dryrun": dr, "history": hist, "peak_gib": peak,
            "small": small, "seconds": time.perf_counter() - t0}


def mesh_moe_gates(card: str, runs: list, single: dict, work: Path
                   ) -> dict:
    """``[mesh-moe]``'s gates on the world's runs (every rank's) against
    the single-device engines of ``single_moe_runs``; rank 0 saved the
    reduced runs' gathered params under ``work``."""
    if not dist_world.same_everywhere(runs):
        raise AssertionError("[mesh-moe] ranks report different metrics")
    launched = [r["launches"] for m in runs for r in m["runs"]]
    if any(any(v.values()) for v in launched):
        raise AssertionError(f"[mesh-moe] kernels launched: {launched}")
    full = [m["runs"][0] for m in runs]
    hist = full[0]["history"]
    dr = single["dryrun"]
    for r in full:
        if r["stored_bytes"] != dr["memory"]["state_bytes"] or any(
                w != dr["collectives"] for w in r["wire_bytes"]):
            raise AssertionError(
                f"[mesh-moe] stored {r['stored_bytes']} / wire "
                f"{r['wire_bytes'][0]} against the dry-run's "
                f"{dr['memory']['state_bytes']} / {dr['collectives']}")
    loss_rel, aux_abs = moe_history_gate(
        hist, single["history"], MESH_MOE_LOSS_TOL, MESH_MOE_AUX_TOL,
        "[mesh-moe] full width, bf16")
    if not all(math.isfinite(h["loss"]) and h["aux_loss"] > 0
               for h in hist):
        raise AssertionError(f"[mesh-moe] metrics {hist}")
    small = {}
    for j, impl in enumerate(MOE_IMPLS):
        got = runs[0]["runs"][1 + j]
        path = work / f"mesh_moe_{impl}.pt"
        params = torch.load(path)
        path.unlink()
        errs = {}
        for dev in ("cuda", "cpu"):
            want_h, want_p = single["small"][(impl, dev)]
            errs[dev] = moe_history_gate(
                got["history"], want_h, MESH_MOE_SMALL_TOL,
                MESH_MOE_SMALL_TOL, f"[mesh-moe] reduced {impl} vs {dev}")
            _, p_rel = leaf_errs(params, want_p)
            if not p_rel <= MESH_MOE_SMALL_TOL:
                raise AssertionError(f"[mesh-moe] reduced {impl}: params "
                                     f"{p_rel} of the {dev} engine's")
            errs[dev] += (p_rel,)
        small[impl] = errs
    steps = [(h, c, g, a) for r in full for h, c, g, a in zip(
        r["host_ms"][1:], r["comm_ms"][1:], r["gather_ms"][1:],
        r["act_ms"][1:])]
    peak = [r["peak_mem_bytes"] / 2**30 for r in full]
    cfg = single["cfg"]
    print(f"[mesh-moe] {MESH_MOE_ARCH} full width, {MESH_MOE_LAYERS} layer, "
          f"bf16, through ElasticMeshSGD on {DIST_RANKS} gloo ranks, mesh "
          f"(data 2, model 2), batch split 2, experts / heads / FF / vocab "
          f"split over model, {MESH_BATCH} x {MESH_SEQ}, {MESH_MOE_STEPS} "
          f"sgd steps at lr {MESH_MOE_LR}: every rank the same metrics, "
          f"losses {loss_rel:.2e} relative (bound {MESH_MOE_LOSS_TOL:g}), "
          f"aux {aux_abs:.2e} (bound {MESH_MOE_AUX_TOL:g}) of the "
          f"single-device engine's (aux {hist[-1]['aux_loss']:.4f}); "
          f"stored {full[0]['stored_bytes']} and wire "
          f"{full[0]['wire_bytes'][0]} bytes per rank = run_dryrun's; no "
          f"kernel launched | {card}")
    print(f"[mesh-moe] ms per step (host clock, a sync before each "
          f"collective, steps after the first, all ranks): "
          f"{spread([x[0] for x in steps])}; the collectives' share "
          f"{spread([x[1] / x[0] for x in steps])}, gathers "
          f"{spread([x[2] for x in steps])} ms, activation all-reduces "
          f"{spread([x[3] for x in steps])} ms; peak memory per rank "
          f"{min(peak):.2f}-{max(peak):.2f} GiB (single-device "
          f"{single['peak_gib']:.2f}) | {card}")
    print(f"[mesh-moe] {MESH_MOE_ARCH}.reduced() f32 on the same mesh, "
          f"{MESH_MOE_SMALL['steps']} sgd steps, worker 2 away for step 3-4: "
          + "; ".join(
              f"{impl}: losses / aux / params vs the card's single-device "
              f"engine {e['cuda'][0]:.1e} / {e['cuda'][1]:.1e} / "
              f"{e['cuda'][2]:.1e}, vs the CPU's {e['cpu'][0]:.1e} / "
              f"{e['cpu'][1]:.1e} / {e['cpu'][2]:.1e}"
              for impl, e in small.items())
          + f" (bound {MESH_MOE_SMALL_TOL:g}) | {card}")
    return {"history": hist, "loss_rel": loss_rel, "aux_abs": aux_abs,
            "host_ms": [x[0] for x in steps],
            "comm_share": [x[1] / x[0] for x in steps],
            "gather_ms": [x[2] for x in steps],
            "act_ms": [x[3] for x in steps], "peak_gib": peak,
            "wire_bytes": full[0]["wire_bytes"][0],
            "stored_bytes": full[0]["stored_bytes"], "small": small,
            "n_params": cfg.n_params()}


def phase_dist(card: str) -> dict:
    """``[dist-collectives]``, ``[mesh-dist]`` and ``[mesh-moe]``: one
    world of 4 gloo ranks on the card (``distributed.world``; kernel 3
    was built before the spawn, so the ranks load it), the single-device
    gates in this process ([mesh-moe]'s before the world)."""
    tk_ops.block_topk_library()          # built here, loaded by the ranks
    work = ROOT / "build" / "dist"
    shutil.rmtree(work, ignore_errors=True)      # a stale rendezvous file
    work.mkdir(parents=True)
    single_moe = single_moe_runs(card)
    gathered = str(work / "mesh_dist_params.pt")
    gathered_step = str(work / "mesh_dist_step.pt")
    coll_job = {"n": DIST_N, "seed": 11, "block": DIST_BLOCK,
                "counts": [3, 1, 0, 4], "specials": DIST_SPECIALS}
    mesh_job = {
        "arch": ARCH, "mesh": MESH_DIST, "batch": MESH_BATCH,
        "seq": MESH_SEQ, "n_workers": MESH_WORKERS, "batches": 0, "seed": 0,
        "runs": [
            # the gate: sgd under churn, each collective timed after a
            # sync (its share of the step)
            {"optimizer": ("sgd", {"lr": MESH_DIST_LR}),
             "steps": MESH_DIST_SGD, "churn": MESH_DIST_CHURN,
             "timed": True, "gather": gathered},
            # the timing run: AdaGrad lr 0.003, nothing synced
            {"optimizer": ("adagrad", {"lr": 0.003}),
             "steps": MESH_DIST_ADAGRAD},
            # the update gate: one sgd step at a large lr
            {"optimizer": ("sgd", {"lr": MESH_DIST_STEP_LR}), "steps": 1,
             "gather": gathered_step}]}
    sm = MESH_MOE_SMALL
    moe_job = {
        "arch": MESH_MOE_ARCH, "mesh": MESH_DIST, "n_workers": MESH_WORKERS,
        "batches": 0, "seed": 0,
        "runs": [{"n_layers": MESH_MOE_LAYERS, "batch": MESH_BATCH,
                  "seq": MESH_SEQ, "steps": MESH_MOE_STEPS, "timed": True,
                  "optimizer": ("sgd", {"lr": MESH_MOE_LR})}] + [
            {"reduced": True, "moe_impl": impl, "batch": sm["batch"],
             "seq": sm["seq"], "steps": sm["steps"], "churn": sm["churn"],
             "optimizer": ("sgd", {"lr": sm["lr"]}),
             "gather": str(work / f"mesh_moe_{impl}.pt")}
            for impl in MOE_IMPLS]}
    free_card()
    t0 = time.perf_counter()
    res = dist_world.spawn_world(
        dist_world.chain_program, DIST_RANKS,
        {"chain": [(dist_world.collectives_program, coll_job),
                   (dist_world.mesh_sgd_program, mesh_job),
                   (dist_world.mesh_sgd_program, moe_job)]},
        str(work), backend="gloo", device="cuda", threads=2)
    world_s = time.perf_counter() - t0
    coll = [r[0] for r in res]
    mesh = [r[1] for r in res]
    moe = mesh_moe_gates(card, [r[2] for r in res], single_moe, work)
    # -- [dist-collectives] ---------------------------------------------------
    for c in coll:
        bad = [k for k in ("sent_equals_plain", "kernel_equals_plain",
                           "feedback_identity") if not c[k]]
        bad += [k for k in ("flat_rel", "hier_rel", "compressed_rel")
                if not c[k] <= DIST_TOL]
        if bad:
            raise AssertionError(f"[dist-collectives] rank {c['rank']}: "
                                 f"{bad}: {c}")
        if c["launches"]["block_topk"] != 1 or any(
                n for k, n in c["launches"].items() if k != "block_topk"):
            raise AssertionError(f"[dist-collectives] rank {c['rank']} "
                                 f"launches {c['launches']}: kernel 3 once")
        want = {"all-reduce": 2 * (4 + 4 * DIST_N)}
        if c["wire_bytes"] != want:
            raise AssertionError(f"[dist-collectives] rank {c['rank']} wire "
                                 f"bytes {c['wire_bytes']}, want {want}")
    worst = {k: max(c[k] for c in coll)
             for k in ("flat_rel", "hier_rel", "compressed_rel")}
    ms = [c["compressed_ms"] for c in coll]
    kms = [c["kernel_ms"] for c in coll]
    pms = [c["picks_ms"] for c in coll]
    print(f"[dist-collectives] {DIST_RANKS} gloo ranks on one card, mesh "
          f"(pod 2, data 2): weighted_psum_reduce {worst['flat_rel']:.1e}, "
          f"hierarchical (data, then pod) {worst['hier_rel']:.1e} of the "
          f"one-process weighted mean; compressed_reduce over "
          f"{DIST_N} entries at block {DIST_BLOCK}: sent = kernel 3's plain "
          f"route bit for bit on every rank (NaN, signed-zero and tie "
          f"blocks), sent + residual = corrected, reduced "
          f"{worst['compressed_rel']:.1e} of the one-process sum (bound "
          f"{DIST_TOL:g}); block_topk launched once per rank; "
          f"{spread(ms)} ms a call, of which the sparsify's kernel 3 "
          f"{spread(kms)} ms and its post-pass {spread(pms)} ms (alone, "
          f"best of 3, the ranks sharing the card); "
          f"{2 * (4 + 4 * DIST_N)} bytes on the wire per rank (gloo through "
          f"host memory, no NCCL or NVLink figure) | {card}")
    # -- [mesh-dist] ------------------------------------------------------------
    cfg = get_config(ARCH)
    if not dist_world.same_everywhere(mesh):
        raise AssertionError("[mesh-dist] ranks report different metrics")
    sgd_runs = [m["runs"][0] for m in mesh]
    ada_runs = [m["runs"][1] for m in mesh]
    step_hist = mesh[0]["runs"][2]["history"]
    hist = sgd_runs[0]["history"]
    if [h["n_live"] for h in hist] != MESH_DIST_LIVE:
        raise AssertionError(f"[mesh-dist] live {[h['n_live'] for h in hist]}")
    launched = [r["launches"] for m in mesh for r in m["runs"]]
    if any(any(v.values()) for v in launched):
        raise AssertionError(f"[mesh-dist] kernels launched: {launched}")
    shape = InputShape("mesh-dist", MESH_SEQ, MESH_BATCH, "train")
    dmesh = Mesh(*MESH_DIST)
    for runs, opt in ((sgd_runs, "sgd"), (ada_runs, "adagrad")):
        dr = run_dryrun(ARCH, shape, mesh=dmesh, optimizer_name=opt,
                        remat=False)
        for r in runs:
            if r["stored_bytes"] != dr["memory"]["state_bytes"] or any(
                    w != dr["collectives"] for w in r["wire_bytes"]):
                raise AssertionError(
                    f"[mesh-dist] {opt}: stored {r['stored_bytes']} / wire "
                    f"{r['wire_bytes'][0]} against the dry-run's "
                    f"{dr['memory']['state_bytes']} / {dr['collectives']}")
    free_card()
    t1 = time.perf_counter()
    want_hist, p0, p10, p_end = single_mesh_run(MESH_DIST_SGD, NCCL_STEPS)
    loss_rel = history_gate(hist, want_hist, MESH_DIST_TOL, "[mesh-dist]")
    got = torch.load(gathered)
    Path(gathered).unlink()
    _, p_rel = leaf_errs(got, p_end)
    if not p_rel <= MESH_DIST_TOL:
        raise AssertionError(f"[mesh-dist] gathered params {p_rel} relative "
                             f"(bound {MESH_DIST_TOL})")
    # what the params gate cannot see: 15 small updates, each stored
    # through the f32 params' rounding (printed, not gated)
    u15_rel, u15_size = update_errs(got, p_end, p0)
    del got, p_end
    step_want, _, _, p_step1 = single_mesh_run(1, 1, lr=MESH_DIST_STEP_LR)
    single_s = time.perf_counter() - t1
    step_loss = history_gate(step_hist, step_want, MESH_DIST_TOL,
                             "[mesh-dist] update gate")
    got = torch.load(gathered_step)
    Path(gathered_step).unlink()
    u_rel, u_size = update_errs(got, p_step1, p0)
    if not u_rel <= MESH_DIST_TOL:
        raise AssertionError(f"[mesh-dist] one step's update {u_rel} "
                             f"relative (bound {MESH_DIST_TOL})")
    del got, p_step1
    sgd_ms = [x for r in sgd_runs for x in r["host_ms"][1:]]
    comm = [c / h for r in sgd_runs for c, h in
            zip(r["comm_ms"][1:], r["host_ms"][1:])]
    gat_ms = [x for r in sgd_runs for x in r["gather_ms"][1:]]
    act_ms = [x for r in sgd_runs for x in r["act_ms"][1:]]
    ada_ms = [x for r in ada_runs for x in r["host_ms"][1:]]
    peak = [r["peak_mem_bytes"] / 2**30 for r in sgd_runs + ada_runs]
    print(f"[mesh-dist] {ARCH} full width ({cfg.n_params()} parameters, "
          f"f32, TF32 off) through ElasticMeshSGD(jit_kwargs=in/out "
          f"shardings) on {DIST_RANKS} gloo ranks, mesh (data 2, model 2), "
          f"{MESH_BATCH} x {MESH_SEQ}, {MESH_WORKERS} workers, worker 1 away "
          f"for steps 5-9, sgd lr {MESH_DIST_LR}: every rank the same "
          f"metrics; tokens and live = the single-device engine's, losses "
          f"{loss_rel:.2e}, gathered params {p_rel:.2e} relative per leaf "
          f"(bound {MESH_DIST_TOL:g}; their update from the start, "
          f"{u15_size:.2e} of the params, differs by {u15_rel:.2e} of "
          f"itself, not gated: f32's rounding of the params); one sgd step "
          f"at lr {MESH_DIST_STEP_LR:g} (the update {u_size:.2e} of the "
          f"params): update {u_rel:.2e} of the single-device one per leaf, "
          f"loss {step_loss:.2e} (bound {MESH_DIST_TOL:g}); stored bytes "
          f"{sgd_runs[0]['stored_bytes']} and wire bytes per step "
          f"{sgd_runs[0]['wire_bytes'][0]} per rank = run_dryrun's; no "
          f"kernel launched | {card}")
    print(f"[mesh-dist] ms per step (host clock ending in the metrics' host "
          f"copy, steps after the first, all ranks): AdaGrad lr 0.003 "
          f"{spread(ada_ms)}; sgd with a sync before each collective "
          f"{spread(sgd_ms)}, the collectives' share {spread(comm)}, of "
          f"which the gathers {spread(gat_ms)} ms and the activation "
          f"all-reduces (compute split over model) {spread(act_ms)} ms; "
          f"peak memory per rank {min(peak):.2f}-{max(peak):.2f} GiB; world "
          f"{world_s:.1f} s (with [mesh-moe]'s runs), single-device gate "
          f"{single_s:.1f} s, [mesh-moe]'s single-device engines "
          f"{single_moe['seconds']:.1f} s (gloo through host memory on one "
          f"card: no NCCL or NVLink figure) | {card}")
    out = {"collectives": coll, "mesh_dist": mesh, "world_s": world_s,
           "mesh_moe": moe, "mesh_moe_single_s": single_moe["seconds"],
           "loss_rel": loss_rel, "param_rel": p_rel, "update_rel": u_rel,
           "update_size": u_size, "update15_rel": u15_rel,
           "block_topk_launches": sum(c["launches"]["block_topk"]
                                      for c in coll)}
    # -- [mesh-nccl] --------------------------------------------------------------
    n = torch.cuda.device_count()
    model = 2 if n % 2 == 0 and n >= 4 else 1
    nccl_job = {"arch": ARCH, "mesh": ((n // model, model),
                                       ("data", "model")),
                "batch": MESH_BATCH, "seq": MESH_SEQ,
                "n_workers": MESH_WORKERS, "batches": 0, "seed": 0,
                "runs": [{"optimizer": ("sgd", {"lr": MESH_DIST_LR}),
                          "steps": NCCL_STEPS, "churn": MESH_DIST_CHURN,
                          "gather": gathered}]}
    free_card()
    t2 = time.perf_counter()
    nres = dist_world.spawn_world(dist_world.mesh_sgd_program, n, nccl_job,
                                  str(work / "nccl"), backend="nccl",
                                  device="cuda-per-rank", threads=2)
    nccl_s = time.perf_counter() - t2
    nhist = nres[0]["runs"][0]["history"]
    n_rel = history_gate(nhist, want_hist[:NCCL_STEPS], NCCL_TOL,
                         "[mesh-nccl]")
    got = torch.load(gathered)
    Path(gathered).unlink()
    n_abs, np_rel = leaf_errs(got, p10)
    bitwise = n_abs == 0.0 and all(
        a == b for a, b in zip(nhist, want_hist[:NCCL_STEPS]))
    if not np_rel <= NCCL_TOL:
        raise AssertionError(f"[mesh-nccl] params {np_rel} relative (bound "
                             f"{NCCL_TOL})")
    nms = [x for x in nres[0]["runs"][0]["host_ms"][1:]]
    print(f"[mesh-nccl] a NCCL world of {n} rank(s), one card each, mesh "
          f"{nccl_job['mesh'][0]}: {NCCL_STEPS} sgd steps = the "
          f"single-device engine, losses {n_rel:.2e}, params {np_rel:.2e} "
          f"relative (bound {NCCL_TOL:g}), bitwise {bitwise}; ms per step "
          f"{spread(nms)}; world {nccl_s:.1f} s | {card}")
    out["nccl"] = {"ranks": n, "loss_rel": n_rel, "param_rel": np_rel,
                   "bitwise": bitwise, "host_ms": nms, "world_s": nccl_s}
    del got, p0, p10
    free_card()
    return out


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
    t8 = time.perf_counter()
    spec = phase_serve_spec(card, srv, srv.pop("streams"))
    spec["seconds"] = time.perf_counter() - t8
    t8 = time.perf_counter()
    oneshot = phase_oneshot(card)
    oneshot["seconds"] = time.perf_counter() - t8
    train = phase_train(card, fused["demo"]["ms"])
    lm = phase_reduce_lm(card)
    train_lm = phase_train_lm(card)
    ts = phase_train_serve(card)
    ts_small = phase_train_serve_small(card)
    slice9 = {}
    for name, fn in (("hier", phase_hier), ("hier-small", phase_hier_small),
                     ("randk", phase_randk),
                     ("dense-reduce", phase_dense_reduce)):
        t9 = time.perf_counter()
        slice9[name] = fn(card)
        slice9[name]["seconds"] = time.perf_counter() - t9
    slice10 = {}
    for name, fn in (("moe", phase_moe), ("moe-small", phase_moe_small),
                     ("ssm", lambda c: phase_ssm(c, "mamba2-780m")),
                     ("hybrid", lambda c: phase_ssm(c, "zamba2-7b")),
                     ("ssm-small", phase_ssm_small)):
        t10 = time.perf_counter()
        slice10[name] = fn(card)
        slice10[name]["seconds"] = time.perf_counter() - t10
    slice11 = {}
    for name, fn in (("vlm", lambda c: phase_ssm(c, "paligemma-3b")),
                     ("audio", lambda c: phase_ssm(c, "whisper-large-v3")),
                     ("c7-small", phase_c7_small)):
        t11 = time.perf_counter()
        slice11[name] = fn(card)
        slice11[name]["seconds"] = time.perf_counter() - t11
    t12 = time.perf_counter()
    mesh = phase_mesh_train(card)
    mesh["seconds"] = time.perf_counter() - t12
    t13 = time.perf_counter()
    dist = phase_dist(card)
    dist["seconds"] = time.perf_counter() - t13
    moe_t = slice10["moe"]["timing"]
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
         "launches": ts["launches"],
         "launches_single_version": ts["launches_single_version"],
         "launches_mixed_version": ts["launches_mixed_version"],
         "launches_serve": srv["launches"],
         "launches_moe": slice10["moe"]["launches"],
         "launches_vlm_ragged": slice11["c7-small"]["ragged"]["launches"],
         "max_abs_err_vlm_ragged": slice11["c7-small"]["ragged"][
             "max_abs_err"],
         "moe_bf16": {k: moe_t[k] for k in ("ms", "ms_eager", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "live_tokens")},
         "max_abs_err_moe_bf16": slice10["moe"]["max_abs_err"],
         "max_row_rel_err_moe_bf16": slice10["moe"]["max_row_rel_err"],
         "max_abs_err": kern["max_abs_err"],
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
         "launches_adaptive_keep": train_lm["keep_launches"],
         "launches_hierarchy": slice9["hier-small"]["launches"],
         "max_abs_err": max(fused["max_abs_err"], lm["max_abs_err"]),
         "ms": demo["ms"], "plain_ms": demo["plain_ms"],
         "bound_ms": demo["bound_ms"], "bound_by": demo["bound_by"],
         "library_ms": demo["library_ms"]},
        {"name": "block_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/topk_compress/block_topk.cu",
         "replaces": "src/repro/kernels/topk_compress/topk_compress.py:22",
         "launches": dist["block_topk_launches"],
         "launches_per_rank_per_call": 1,
         "launches_api": launches["block_topk"],
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
         "fused_compress": fused, "serve": srv, "serve_spec": spec,
         "oneshot": oneshot, "train": train,
         "reduce_lm": lm, "train_lm": train_lm, "train_serve": ts,
         "train_serve_small": ts_small, "slice9": slice9,
         "slice10": slice10, "slice11": slice11, "mesh_train": mesh,
         "dist": dist,
         "api_launches": launches,
         "flash_attention": fa,
         "ssd_scan": ssd, "block_topk": bt,
         "total_s": time.perf_counter() - t_start},
        indent=1, default=str))
    slice8 = (spec["seconds"], oneshot["seconds"],
              ts_small["speculative"]["seconds"])
    print(f"[done] {time.perf_counter() - t_start:.1f} s; slice 8's phases "
          f"{sum(slice8):.1f} s (serve-spec {slice8[0]:.1f}, oneshot "
          f"{slice8[1]:.1f}, speculative train-serve-small {slice8[2]:.1f}); "
          f"slice 9's {sum(v['seconds'] for v in slice9.values()):.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in slice9.items())
          + f"); slice 10's "
          f"{sum(v['seconds'] for v in slice10.values()):.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in slice10.items())
          + f"); slice 11's "
          f"{sum(v['seconds'] for v in slice11.values()):.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in slice11.items())
          + f"); slice 12's mesh-train {mesh['seconds']:.1f} s; slices 13 "
          f"and 14's dist (with [mesh-moe]) {dist['seconds']:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
