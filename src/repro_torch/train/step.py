"""Step builders: the train step and the serving programs for any
``ArchConfig`` (the PyTorch counterpart of ``repro.train.step``).

``build_train_step`` is the paper's algorithm as one step: every virtual
worker (a row slice of the batch) contributes the gradient SUM over its
masked-in tokens, and the division by the GLOBAL masked token count is
the master's weighted average (MLitB step c); the optimizer update
(AdaGrad by default) is the master's step. The ``mask`` is the
elasticity hook: ``core/mesh_engine.py`` widens or zeroes per-worker row
ranges.

PyTorch runs eagerly, so there is nothing to jit or bucket: a step or a
program is a plain function, and the caller calls it. ``unroll`` (a JAX
scan-versus-loop choice) has no meaning here and is ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.flatbuf import build_tree, tree_paths
from repro_torch.models import transformer as tf
from repro_torch.models.layers import softmax_xent
from repro_torch.optim.base import Optimizer

PyTree = Any

DECODE_KERNELS = ("flash", "plain")


def make_train_state(params: PyTree, optimizer: Optimizer) -> PyTree:
    return {"params": params, "opt": optimizer.init(params)}


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                     remat: bool = True, aux_weight: float = 0.01,
                     unroll: bool = False
                     ) -> Callable[[PyTree, Dict[str, torch.Tensor]],
                                   Tuple[PyTree, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)`` on the device the
    state lies on. ``batch``: ``tokens`` / ``labels`` (B, S) int and
    ``mask`` (B, S) float, plus a VLM's ``prefix`` or the audio family's
    ``frames``. The loss is ``sum_nll / max(count, 1) + aux_weight *
    aux``; gradients come from ``torch.autograd.grad`` over the params'
    leaves (a leaf the forward does not reach gets zeros, as under
    ``jax.grad``). ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint`` inside ``transformer.forward``).
    ``metrics``: ``loss`` (sum_nll / count), ``tokens`` (the CLAMPED
    count, so an all-masked batch reports 1.0), ``aux_loss``,
    ``total_loss``, as 0-d tensors on that device. The returned function
    carries its parts as attributes (``cfg``, ``optimizer`` and
    ``loss_and_grads``) for ``distributed/sharded_step.py``. Its spans
    (``repro_torch.tracing``, with CUDA events on the card):
    ``train.forward`` (forward and loss), ``train.backward``
    (``autograd.grad`` with remat's recompute, and the zero-filled
    leaves it did not reach), ``train.optimizer``."""
    del unroll                       # a JAX choice; nothing to unroll here
    extra = {"vlm": "prefix", "audio": "frames"}.get(cfg.arch_type)

    def loss_and_grads(params, batch, reduce_sums=None):
        """(gradient tree, metrics) of one step's loss on ``batch``.
        ``reduce_sums`` (the sharded step's) maps the local ``(sum_nll,
        count)`` to the global ones before the division, so a rank's
        gradient is its share of the global loss's."""
        dev = batch["tokens"].device
        with tracing.span("train.forward", device=dev):
            paths, leaves = zip(*[(p, x.detach().requires_grad_(True))
                                  for p, x in tree_paths(params)])
            kw = {extra: batch[extra]} if extra else {}
            with torch.enable_grad():
                logits, aux = tf.forward(build_tree(paths, leaves), cfg,
                                         batch["tokens"], remat=remat, **kw)
                sum_nll, count = softmax_xent(logits, batch["labels"],
                                              batch["mask"])
                total_nll = sum_nll
                if reduce_sums is not None:
                    total_nll, count = reduce_sums(sum_nll.detach(), count)
                # weighted reduce: gradient of (global sum / global count)
                # == (sum_w grad_sum_w) / (sum_w n_w) — the master's average
                count = torch.clamp(count, min=1.0)
                loss = sum_nll / count + aux_weight * aux
        with tracing.span("train.backward", device=dev):
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]
        mean = (total_nll / count).detach()
        metrics = {"loss": mean, "tokens": count.detach(),
                   "aux_loss": aux.detach(),
                   "total_loss": (mean + aux_weight * aux).detach()}
        return build_tree(paths, grads), metrics

    def train_step(state, batch):
        grads, metrics = loss_and_grads(state["params"], batch)
        with tracing.span("train.optimizer", device=batch["tokens"].device):
            new_params, new_opt = optimizer.update(state["params"], grads,
                                                   state["opt"])
        return {"params": new_params, "opt": new_opt}, metrics

    # the parts the sharded step (distributed/sharded_step.py) reuses
    train_step.cfg = cfg
    train_step.optimizer = optimizer
    train_step.loss_and_grads = loss_and_grads
    return train_step


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
