"""Weighted gradient reduction — MLitB §3.3(c) / §3.6 "Training Mode";
port of ``repro.core.reducer``.

"The total gradient and the number of gradients is sent to the master,
which then in the reduce step computes a weighted average of gradients from
all workers and takes a gradient step using AdaGrad."

Workers send *gradient sums* g_w with their sample counts n_w; the reduce
is g_bar = (sum_w g_w) / (sum_w n_w). Two execution paths:

- **fused (default).** Every worker tree is raveled into one fp32 buffer
  (``core.flatbuf``), stacked into a (W_cap, n) matrix, and one reduce
  step runs: the compression channel over ALL workers (blocktopk: one
  kernel launch doing error-feedback add, block-top-k, packed emission
  and residual update — ``kernels/topk_compress``; topk: a stable sort
  per row; randk: one row's hash draw and selection at a time, so the
  transient stays at one row's size), a scatter-add segment-sum, and the
  optimizer step.
- **dense (``fused=False``).** The per-worker loop over the parameter
  tree with the leaf-wise compressor ``roundtrip``, in sorted worker
  order, then ``weighted_reduce`` (a sum in message order, in f32) and
  the optimizer on the tree. Uncompressed it equals the fused path to
  float rounding; with a compressor the two select differently
  (flat-buffer-global vs per-leaf).

The fused worker axis is CAPACITY-PADDED for churn: ``W_cap`` is the next power
of two >= the largest worker count seen (monotone), the fleet occupies the
first W rows, and vacant rows carry zero gradients/residuals, ``n_w = 0``
and ``k_w = 0`` — exact no-ops. Deadline-late workers (``defer=``) ride the
same mask: zero weight, zero wire bytes, their whole corrected gradient
kept in their residual. Ragged per-worker keeps (``keep=``) select
``kmax`` candidates per block and mask each worker down to its own keep;
unsent candidates go back to the residual.

The JAX package jits one step function per ``(W_cap, kmax)``; the port
runs eagerly, and keeps the same cache of step closures and its
``trace_count`` (closures built) so the trace-bound contract carries over.

Differences from the JAX code, each for a reason:
  - JAX's ``.at[].add(mode="drop")`` drops indices >= n (tail-pad pairs);
    ``index_add_`` would raise, so ``index_add_drop`` redirects them as
    -0.0 adds.
  - The segment-sum adds ONE WORKER AT A TIME, w = 0 .. W_cap-1: within a
    worker the block-top-k indices are distinct (apart from 0.0-valued
    pad pairs), so each ``index_add_`` is deterministic even with the
    card's atomics, and the per-position order matches the JAX CPU
    scatter's, which makes CPU parity bit-equal.
  - JAX arrays are immutable. Here the parameter buffer is REPLACED every
    step (the optimizer is functional) and never written in place, so a
    ``params`` tree handed out earlier (views of the old buffer) keeps its
    values.
  - randk draws from the counter hash of ``core/compression.py``, not
    ``jax.random``; worker row w of step s draws under
    ``compressor.flat_key(s, w)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.compression import (GradientCompressor,
                                          index_add_drop, randk_indices,
                                          stable_topk_indices)
from repro_torch.core.flatbuf import (build_tree, flat_spec, tree_leaves,
                                      tree_map, tree_paths)
from repro_torch.kernels.topk_compress import fused_block_topk_batched
from repro_torch.optim.base import Optimizer

PyTree = Any

# step-fn cache key for the live-masked uncompressed variant (compressed
# variants key on their kmax >= 1; None keys the plain uncompressed fn)
MASKED_UNCOMPRESSED = -1


def weighted_reduce(messages: Sequence[Tuple[PyTree, float]]) -> PyTree:
    """messages: [(grad_sum_tree, n_samples)] -> mean-gradient tree (f32,
    summed in message order)."""
    if not messages:
        raise ValueError("reduce step with no worker messages")
    total_n = sum(float(n) for _, n in messages)
    if total_n <= 0:
        raise ValueError("reduce step with zero samples")
    acc = tree_map(lambda x: x.float(), messages[0][0])
    for g, _ in messages[1:]:
        acc = tree_map(lambda a, b: a + b.float(), acc, g)
    # a tensor divisor: the card divides a tensor by a host scalar as a
    # multiply by its reciprocal, which rounds differently
    return tree_map(lambda a: a / torch.tensor(total_n, dtype=torch.float32,
                                               device=a.device), acc)


def _segment_sum(n: int, idx: torch.Tensor, sent: torch.Tensor,
                 rows: List[int]) -> torch.Tensor:
    """sum_w scatter(idx[w], sent[w]) into an (n,) buffer, one worker row
    at a time in ascending order (deterministic; JAX's CPU order). Rows
    not in ``rows`` send only zeros and are skipped."""
    out = torch.zeros(n, dtype=torch.float32, device=sent.device)
    for w in rows:
        index_add_drop(out, idx[w].reshape(-1), sent[w].reshape(-1))
    return out


class MasterReducer:
    """Owns optimizer state (the paper's master-held model) and applies the
    weighted reduce + optimizer step. Per-worker compressors implement the
    fixed-bandwidth-budget channel of §5.1. Lives on the parameters'
    device; worker gradient trees must be on the same device."""

    def __init__(self, params: PyTree, optimizer: Optimizer,
                 compressor: Optional[GradientCompressor] = None,
                 fused: bool = True):
        self.optimizer = optimizer
        self.compressor = compressor
        self.fused = fused
        self._residuals: Dict[str, Any] = {}
        self.step = 0
        self.last_wire_bytes = 0
        self.last_per_worker_bytes: Dict[str, int] = {}
        if fused:
            self._spec = flat_spec(params)
            self._flat = self._spec.flatten(params)
            self.opt_state = optimizer.init(self._flat)
            self._params_cache: Optional[PyTree] = None
            # step-closure cache, rebuilt lazily after a resume — never
            # checkpointed (trace_count restarting at 0 is the JAX
            # contract)
            # reprolint: exempt[RL005]
            self._step_fns: Dict[Tuple[int, Optional[int]], Callable] = {}
            self._w_cap = 0          # monotone worker-axis capacity
            self.trace_count = 0     # step-closure builds
        else:
            self._params = params
            self.opt_state = optimizer.init(params)

    # ------------------------------------------------------------------
    @property
    def params(self) -> PyTree:
        """The current parameters as a nested dict (fused: views of the
        flat buffer, which is never written in place)."""
        if not self.fused:
            return self._params
        if self._params_cache is None:
            self._params_cache = self._spec.unflatten(self._flat)
        return self._params_cache

    @property
    def flat_params(self) -> torch.Tensor:
        """The master's (n,) fp32 parameter buffer (the dense path
        ravels its tree anew)."""
        if not self.fused:
            return flat_spec(self._params).flatten(self._params)
        return self._flat

    @property
    def flat_n(self) -> int:
        """Length of the flat gradient buffer a worker message addresses."""
        if not self.fused:
            return flat_spec(self._params).n
        return self._spec.n

    @property
    def device(self) -> torch.device:
        if not self.fused:
            return tree_leaves(self._params)[0].device
        return self._flat.device

    def drop_worker(self, worker: str) -> None:
        self._residuals.pop(worker, None)

    def apply_outer_delta(self, delta) -> None:
        """Shift the flat parameter buffer by ``delta`` WITHOUT an
        optimizer step (the hierarchy's outer gossip correction): the
        inner AdaGrad trajectory keeps its accumulator; only the point it
        continues from moves toward the cross-region consensus."""
        if not self.fused:
            raise ValueError("apply_outer_delta needs the fused flat "
                             "buffer (fused=True)")
        self._flat = self._flat + torch.as_tensor(
            delta, dtype=torch.float32, device=self._flat.device)
        self._params_cache = None

    # ------------------------------------------------------------------
    # churn support: capacity bucketing + deadline deferral
    # ------------------------------------------------------------------
    def _capacity(self, W: int) -> int:
        """Power-of-two worker-axis capacity, monotone non-decreasing so
        fleet shrinkage never builds a new step closure."""
        cap = 1 << max(0, (W - 1).bit_length())
        self._w_cap = max(self._w_cap, cap)
        return self._w_cap

    def defer_to_residual(self, worker: str, grad: PyTree) -> None:
        """Fold a late/deadline-missed worker's ENTIRE gradient into its
        error-feedback residual without an optimizer step. The mass ships
        the next time the worker participates."""
        res = self._residuals.get(worker)
        if self.fused:
            flat = self._spec.flatten(grad)
            self._residuals[worker] = flat if res is None else res + flat
        elif res is None:
            self._residuals[worker] = tree_map(lambda g: g.float(), grad)
        else:
            self._residuals[worker] = tree_map(lambda r, g: r + g.float(),
                                               res, grad)

    # ------------------------------------------------------------------
    # dense reference path
    # ------------------------------------------------------------------
    def _channel(self, worker: str, grad: PyTree) -> PyTree:
        """The worker->master channel (compress + error feedback)."""
        if self.compressor is None:
            return grad
        res = self._residuals.get(worker)
        sent, new_res = self.compressor.roundtrip(grad, res, step=self.step)
        self._residuals[worker] = new_res
        return sent

    def _reduce_and_step_dense(
            self, messages: Dict[str, Tuple[PyTree, float]]) -> PyTree:
        chan = [(w, self._channel(w, g), n) for w, (g, n) in
                sorted(messages.items())]
        g_bar = weighted_reduce([(g, n) for _, g, n in chan])
        self._params, self.opt_state = self.optimizer.update(
            self._params, g_bar, self.opt_state)
        self.last_per_worker_bytes = {
            w: (self.compressor.wire_bytes(g) if self.compressor else
                4 * sum(x.numel() for x in tree_leaves(g)))
            for w, g, _ in chan}
        self.last_wire_bytes = sum(self.last_per_worker_bytes.values())
        self.step += 1
        return self._params

    # ------------------------------------------------------------------
    # the step closures
    # ------------------------------------------------------------------
    def _build_step_fn(self, W_cap: int, kmax: Optional[int]) -> Callable:
        """One step closure per (worker-axis capacity, padded keep count):
        fn(flat, opt_state, grads (W_cap, n), res (W_cap, n), ns (W_cap,),
        k_arr (W_cap,), live_rows, step) -> (new_flat, new_state, new_res).
        ``live_rows`` are the rows with k_arr > 0 (host ints); ``step`` is
        the reduce step randk's draw is keyed on."""
        self.trace_count += 1
        opt = self.optimizer
        comp = self.compressor
        n = self._spec.n

        if comp is None:
            if kmax is None:
                # plain uncompressed reduce: no deferral state in play
                def fn(flat, opt_state, grads, res, ns, k_arr, live_rows,
                       step):
                    g_bar = torch.sum(grads, dim=0) / torch.sum(ns)
                    return (*opt.update(flat, g_bar, opt_state), None)

                return fn

            # masked variant: deferred workers and pending residuals ride
            # the live-mask
            def fn(flat, opt_state, grads, res, ns, k_arr, live_rows, step):
                g = grads + res
                live = (ns > 0).float()[:, None]
                g_bar = torch.sum(g * live, dim=0) / torch.sum(ns)
                new_res = g * (1.0 - live)
                return (*opt.update(flat, g_bar, opt_state), new_res)

            return fn

        col = torch.arange(kmax, dtype=torch.int32, device=self.device)

        if comp.method == "blocktopk":
            block_w = comp.block_w

            def fn(flat, opt_state, grads, res, ns, k_arr, live_rows, step):
                # (W_cap, R, kmax) candidates per worker, descending |.|
                # per block; res_full assumes ALL kmax candidates sent
                vals, idx, res_full = fused_block_topk_batched(
                    grads, res, k=kmax, block_w=block_w)
                mask = col[None, None, :] < k_arr[:, None, None]
                sent = torch.where(mask, vals, torch.zeros_like(vals))
                # candidates a worker did NOT send go back to its residual
                # (rows of one worker address disjoint slices of the
                # (W_cap * n,) view, so one index_add_ is deterministic)
                dropped = (vals - sent).reshape(W_cap, -1)
                flat_idx = idx.reshape(W_cap, -1).long()
                ok = flat_idx < n
                rows_off = torch.arange(W_cap, device=idx.device)[:, None] * n
                res_full.view(-1).index_add_(
                    0, (torch.where(ok, flat_idx, 0) + rows_off).reshape(-1),
                    torch.where(ok, dropped, -0.0).reshape(-1))
                g_bar = _segment_sum(n, idx, sent, live_rows) / torch.sum(ns)
                return (*opt.update(flat, g_bar, opt_state), res_full)

            return fn

        if comp.method == "randk":

            def fn(flat, opt_state, grads, res, ns, k_arr, live_rows, step):
                # c doubles as the new residual: a row that sends nothing
                # keeps its whole corrected gradient
                c = grads + res
                g_bar = torch.zeros(n, dtype=torch.float32, device=c.device)
                # one row's draw at a time (an (n,) int64 hash, not a
                # (W_cap, n) one); each row has its own stream, and the
                # segment-sum adds rows in ascending order
                for w in live_rows:
                    idx = randk_indices(comp.flat_key(step, w), n, kmax,
                                        c.device).long()
                    vals = c[w, idx]
                    sent = torch.where(col < k_arr[w], vals,
                                       torch.zeros_like(vals))
                    # zero exactly the sent entries (distinct indices)
                    c[w].index_add_(0, idx, -sent)
                    g_bar.index_add_(0, idx, sent)
                g_bar = g_bar / torch.sum(ns)
                return (*opt.update(flat, g_bar, opt_state), c)

            return fn

        if comp.method != "topk":
            raise ValueError(comp.method)

        def fn(flat, opt_state, grads, res, ns, k_arr, live_rows, step):
            c = grads + res
            idx = stable_topk_indices(c.abs(), kmax)
            vals = torch.gather(c, 1, idx.long())
            mask = col[None, :] < k_arr[:, None]
            sent = torch.where(mask, vals, torch.zeros_like(vals))
            # zero exactly the sent entries out of c; unsent candidates
            # stay in the residual (per-row indices are distinct)
            new_res = c.scatter_add(1, idx.long(), -sent)
            g_bar = _segment_sum(n, idx, sent, live_rows) / torch.sum(ns)
            return (*opt.update(flat, g_bar, opt_state), new_res)

        return fn

    def _stack(self, trees: List[PyTree], W_cap: int) -> torch.Tensor:
        """(W_cap, n) fp32 rows: ``flatten(trees[i])`` then zero rows."""
        out = torch.empty((W_cap, self._spec.n), dtype=torch.float32,
                          device=self.device)
        for i, t in enumerate(trees):
            torch.cat([x.reshape(-1).float() for x in tree_leaves(t)],
                      out=out[i])
        out[len(trees):].zero_()
        return out

    @property
    def supports_defer(self) -> bool:
        """Whether late messages can be kept in error-feedback residuals
        (fused flat buffers, or the dense path's compressor residual
        trees). The dense UNCOMPRESSED path has no residual channel: late
        mass there is dropped."""
        return self.fused or self.compressor is not None

    def reduce_and_step(
            self, messages: Dict[str, Tuple[PyTree, float]],
            keep: Optional[Dict[str, int]] = None,
            defer: Optional[Any] = None) -> PyTree:
        """messages: {worker: (grad_sum, n)}. Returns the new params
        (the broadcast payload of step (e)).

        ``keep`` maps worker -> per-message keep total (entries) for
        per-worker compression; missing workers fall back to the
        compressor's uniform frac; values are quantized onto
        ``GradientCompressor.k_lattice``. ``defer`` names workers whose
        reply missed the iteration deadline: zero contribution, zero wire
        bytes, whole corrected gradient kept in their residual; at least
        one message must remain on-time. Both need the fused path."""
        if self.fused:
            return self._reduce_and_step_fused(messages, keep, defer)
        if keep:
            raise ValueError("per-worker keep requires fused=True")
        if defer:
            raise ValueError("defer requires fused=True (use "
                             "defer_to_residual on the dense path)")
        return self._reduce_and_step_dense(messages)

    def _reduce_and_step_fused(
            self, messages: Dict[str, Tuple[PyTree, float]],
            keep: Optional[Dict[str, int]],
            defer: Optional[Any]) -> PyTree:
        if not messages:
            raise ValueError("reduce step with no worker messages")
        defer = frozenset(defer or ())
        names = sorted(messages)
        on_time = [w for w in names if w not in defer]
        total_n = sum(float(messages[w][1]) for w in on_time)
        if not on_time or total_n <= 0:
            raise ValueError("reduce step with no on-time samples "
                             "(use defer_to_residual for all-late rounds)")
        n = self._spec.n
        W = len(names)
        W_cap = self._capacity(W)
        pad = W_cap - W
        dev = self.device

        def residual_rows() -> torch.Tensor:
            res = torch.zeros((W_cap, n), dtype=torch.float32, device=dev)
            for i, w in enumerate(names):
                if w in self._residuals:
                    res[i].copy_(self._residuals[w])
            return res

        compressed = self.compressor is not None
        masked = bool(defer) or any(w in self._residuals for w in names)
        with tracing.span("reduce.stack"):
            grads = self._stack([messages[w][0] for w in names], W_cap)
            res = residual_rows() if masked or compressed else None
        # ns = 0 is the live-mask: vacant capacity rows AND deferred
        # (deadline-late) workers carry zero weight in the average
        ns_np = np.zeros(W_cap, np.float32)
        for i, w in enumerate(names):
            if w not in defer:
                ns_np[i] = float(messages[w][1])
        ns = torch.from_numpy(ns_np).to(dev)

        if not compressed:
            if keep:
                raise ValueError("per-worker keep requires a compressor")
            key = (W_cap, MASKED_UNCOMPRESSED if masked else None)
            args = (None, None, None)
        else:
            comp = self.compressor
            # per-worker keep totals, snapped to the compressor's lattice
            # (keep=None -> the uniform frac-derived default); deferred
            # workers are masked to k = 0
            k_tot = {w: comp.flat_k(n, (keep or {}).get(w))
                     for w in on_time}
            kmax_tot = max(k_tot.values())
            if comp.method == "blocktopk":
                rows = -(-n // comp.block_w)
                kmax = kmax_tot // rows            # per-block keep
                k_of = {w: k_tot[w] // rows for w in on_time}
            else:
                kmax = kmax_tot
                k_of = dict(k_tot)
            k_list = [k_of.get(w, 0) for w in names] + [0] * pad
            k_arr = torch.tensor(k_list, dtype=torch.int32).to(dev)
            key = (W_cap, kmax)
            args = (k_arr, [i for i, k in enumerate(k_list) if k > 0],
                    self.step)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = self._step_fns[key] = self._build_step_fn(*key)
        with tracing.span("reduce.step", device=dev):
            self._flat, self.opt_state, new_res = fn(
                self._flat, self.opt_state, grads, res, ns, *args)
        if not compressed:
            if masked:
                # on-time rows leave an all-zero residual: keep the dict
                # sparse (only deferred mass is worth holding)
                for i, w in enumerate(names):
                    if w in defer:
                        self._residuals[w] = new_res[i]
                    else:
                        self._residuals.pop(w, None)
            self.last_per_worker_bytes = {w: 4 * n for w in on_time}
            self.last_wire_bytes = len(on_time) * 4 * n
        else:
            for i, w in enumerate(names):
                self._residuals[w] = new_res[i]
            self.last_per_worker_bytes = {w: 8 * k_tot[w] for w in on_time}
            self.last_wire_bytes = sum(self.last_per_worker_bytes.values())
        self._params_cache = None
        self.step += 1
        return self.params

    # ------------------------------------------------------------------
    # full-state snapshot
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Everything mutable: params, optimizer state, per-worker
        error-feedback residuals, the step counter (randk's key input),
        the capacity bucket, and the wire accounting, as numpy in the JAX
        package's layout (fused: one flat buffer; dense: ``param_leaves``
        and residual leaf lists in ``tree_leaves`` order)."""
        def leaves(tree):
            return [x.detach().cpu().numpy() for x in tree_leaves(tree)]

        st: Dict[str, Any] = {
            "fused": self.fused,
            "step": self.step,
            "opt_leaves": leaves(self.opt_state),
            "last_wire_bytes": self.last_wire_bytes,
            "last_per_worker_bytes": dict(self.last_per_worker_bytes),
        }
        if self.fused:
            st["flat"] = self._flat.detach().cpu().numpy()
            st["w_cap"] = self._w_cap
            st["residuals"] = {w: r.detach().cpu().numpy()
                               for w, r in self._residuals.items()}
        else:
            st["param_leaves"] = leaves(self._params)
            st["residuals"] = {w: leaves(r)
                               for w, r in self._residuals.items()}
        return st

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        if bool(st["fused"]) != self.fused:
            raise ValueError("snapshot fused mode does not match reducer")
        dev = self.device

        def into(tree, leaf_list):
            return build_tree(tuple(p for p, _ in tree_paths(tree)), [
                torch.as_tensor(np.asarray(a)).to(dev) for a in leaf_list])

        self.step = int(st["step"])
        self.opt_state = into(self.opt_state, st["opt_leaves"])
        self.last_wire_bytes = int(st["last_wire_bytes"])
        self.last_per_worker_bytes = {
            w: int(b) for w, b in st["last_per_worker_bytes"].items()}
        if self.fused:
            self._flat = torch.as_tensor(np.asarray(st["flat"], np.float32)
                                         ).to(dev)
            self._w_cap = int(st["w_cap"])
            self._residuals = {
                w: torch.as_tensor(np.asarray(r, np.float32)).to(dev)
                for w, r in st["residuals"].items()}
            self._params_cache = None
        else:
            self._params = into(self._params, st["param_leaves"])
            self._residuals = {w: into(self._params, r)
                               for w, r in st["residuals"].items()}
