"""Serving programs — one factory for every serving step function.

The PyTorch counterpart of ``repro.train.step``'s ``ServePrograms`` /
``build_serve_programs``. PyTorch runs eagerly, so there is nothing to
jit or bucket: a program is a plain function, and the engine calls it.
``build_train_step`` belongs to the multi-device surface (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

DECODE_KERNELS = ("flash", "plain")


@dataclass(frozen=True)
class ServePrograms:
    """The serving step functions for one ``(cfg, paged, decode_kernel)``
    choice (``B``=batch, ``C``=chunk, ``P``=pages per row):

      prefill_chunk  dense: (params, tokens (B,C), off, clen, cache)
                     paged: (params, tokens, off, clen, pool, rmap, wmap)
      decode         dense: (params, token (B,1), pos (B,), cache, live)
                     paged: (params, token, pos, pool, live, rmap, wmap)

    Each returns ``(logits, cache)``; the cache is updated in place."""
    cfg: ArchConfig
    paged: bool
    decode_kernel: str
    prefill_chunk: Callable
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

        decode_fn = tf.decode_step_ragged_paged_flash \
            if decode_kernel == "flash" else tf.decode_step_ragged_paged

        def decode(params, token, pos, pool, live, rmap, wmap):
            return decode_fn(params, cfg, token, pos, pool, live, rmap, wmap)
        return ServePrograms(cfg=cfg, paged=True, decode_kernel=decode_kernel,
                             prefill_chunk=prefill_chunk, decode=decode)

    def prefill_chunk(params, tokens, off, clen, cache):
        return tf.prefill_chunk(params, cfg, tokens, off, clen, cache)

    def decode(params, token, pos, cache, live):
        return tf.decode_step_ragged(params, cfg, token, pos, cache, live,
                                     flash=decode_kernel == "flash")
    return ServePrograms(cfg=cfg, paged=False, decode_kernel=decode_kernel,
                         prefill_chunk=prefill_chunk, decode=decode)
