"""Serving programs — one factory for every serving step function.

The PyTorch counterpart of ``repro.train.step``'s ``ServePrograms`` /
``build_serve_programs`` / ``build_draft_program``. PyTorch runs
eagerly, so there is nothing to jit or bucket: a program is a plain
function, and the engine calls it.
``build_train_step`` belongs to the multi-device surface (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

DECODE_KERNELS = ("flash", "plain")


@dataclass(frozen=True)
class ServePrograms:
    """The serving engine's step functions for one ``(cfg, paged,
    decode_kernel)`` choice (``B``=batch, ``C``=chunk, ``P``=pages per
    row):

      prefill_chunk  dense: (params, tokens (B,C), off, clen, cache)
                     paged: (params, tokens, off, clen, pool, rmap, wmap)
      verify         prefill_chunk's arguments -> (logits (B,C,V), cache)
      decode         dense: (params, token (B,1), pos (B,), cache, live)
                     paged: (params, token, pos, pool, live, rmap, wmap)

    Each returns ``(logits, cache)``; the cache is updated in place. The
    single-shot path binds no choice, so ``serve_batch`` calls
    ``transformer.prefill`` / ``decode_step`` itself."""
    cfg: ArchConfig
    paged: bool
    decode_kernel: str
    prefill_chunk: Callable
    verify: Callable
    decode: Callable


def build_serve_programs(cfg: ArchConfig, *, paged: bool,
                         decode_kernel: str = "flash") -> ServePrograms:
    """``paged`` selects the KV layout (dense slot cache vs paged pool +
    page maps); ``decode_kernel`` the decode attention: ``"flash"`` (the
    hand-written flash-decode kernel; on CPU tensors its plain PyTorch
    version) or ``"plain"`` (masked softmax over the dense or gathered
    cache — the JAX package's ``"xla"`` path)."""
    if decode_kernel not in DECODE_KERNELS:
        raise ValueError(f"decode_kernel={decode_kernel!r}: expected "
                         f"'flash' or 'plain'")
    if paged:
        def prefill_chunk(params, tokens, off, clen, pool, rmap, wmap):
            return tf.prefill_chunk_paged(params, cfg, tokens, off, clen,
                                          pool, rmap, wmap)

        def verify(params, tokens, off, clen, pool, rmap, wmap):
            return tf.prefill_chunk_paged(params, cfg, tokens, off, clen,
                                          pool, rmap, wmap, all_logits=True)

        decode_fn = tf.decode_step_ragged_paged_flash \
            if decode_kernel == "flash" else tf.decode_step_ragged_paged

        def decode(params, token, pos, pool, live, rmap, wmap):
            return decode_fn(params, cfg, token, pos, pool, live, rmap, wmap)
        return ServePrograms(cfg=cfg, paged=True, decode_kernel=decode_kernel,
                             prefill_chunk=prefill_chunk, verify=verify,
                             decode=decode)

    def prefill_chunk(params, tokens, off, clen, cache):
        return tf.prefill_chunk(params, cfg, tokens, off, clen, cache)

    def verify(params, tokens, off, clen, cache):
        return tf.prefill_chunk(params, cfg, tokens, off, clen, cache,
                                all_logits=True)

    def decode(params, token, pos, cache, live):
        return tf.decode_step_ragged(params, cfg, token, pos, cache, live,
                                     flash=decode_kernel == "flash")
    return ServePrograms(cfg=cfg, paged=False, decode_kernel=decode_kernel,
                         prefill_chunk=prefill_chunk, verify=verify,
                         decode=decode)


def build_draft_program(cfg: ArchConfig, *, k: int, window: int) -> Callable:
    """The speculative-decoding DRAFT program: a cacheless greedy k-token
    proposer over a ``(B, window)`` token buffer.

    ``(params, window_toks (B,W) int32, hlen (B,) int32) -> (B,k) int32``
    — row b's history is ``window_toks[b, :hlen_b]`` (left-aligned; the
    caller truncates it to the last ``window - k`` tokens so every write
    fits). k greedy forwards, each proposal written at column
    ``hlen + i``; both column indices are clamped into ``[0, W-1]`` as
    the JAX program's ``jnp.clip`` does. Causal masking hides the padded
    tail, so proposals depend only on the visible history. Runs under
    ``torch.inference_mode`` with ``remat=False``: no autograd graph."""
    def draft(params, window_toks, hlen):
        B, W = window_toks.shape
        rows = torch.arange(B, device=window_toks.device)
        hl = hlen.long()
        outs = []
        with torch.inference_mode():
            toks = window_toks.clone()
            for i in range(k):
                logits, _ = tf.forward(params, cfg, toks, remat=False)
                col = (hl - 1 + i).clamp(0, W - 1)
                nxt = torch.argmax(logits[rows, col], dim=-1).to(torch.int32)
                outs.append(nxt)
                toks[rows, (hl + i).clamp(0, W - 1)] = nxt.to(toks.dtype)
        return torch.stack(outs, dim=1)
    return draft
