"""Continuous-batching inference engine (PyTorch port of
``repro.serving.engine``).

The engine owns ONE preallocated KV buffer on the device and interleaves
prefill and decode over it, so requests of any prompt and generation
length join and leave mid-flight. Two layouts:

  - the DENSE slot cache ``(n_layers, max_batch, max_seq, K, hd)``;
  - the PAGED pool ``(n_layers, n_pages, page_size, K, hd)`` (``paging``
    set), with per-slot page lists on the host and cross-request PREFIX
    REUSE: a radix trie keyed on prompt-token pages lets requests that
    share a prompt prefix prefill it once and fork copy-on-write (shared
    pages are frozen — mapped out of bounds in every write map — so a
    fork never copies and never writes its parent's pages).

Each step: admit queued requests into free slots (FIFO; in paged mode
the head of the line waits for pages), feed every slot with prompt
pending one chunk of at most ``prompt_cap`` tokens (padded to a
power-of-two ``(batch_cap, chunk_cap)`` bucket), then run ONE decode
dispatch over all slots with per-slot positions and a live mask. With
``decode_kernel="flash"`` decode attention runs the hand-written
flash-decode kernel on the card (its plain version on CPU tensors).

Slot invariant: cache row ``s`` is valid exactly on ``[0, pos_s]`` and
decode at position ``p`` overwrites index ``p`` before attending to it,
so freed rows never need scrubbing.

Not ported yet (ROADMAP C): sampling other than greedy (C1),
backpressure (C2), hot swap and the version ring (C3 — the engine serves
one param version), speculative decoding (C4), simulated timing (C5).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree, dtype_of
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.paging import PagePool, PrefixTrie
from repro_torch.train.step import build_serve_programs

# the engine serves one param version; the prefix trie keys pages by it
# (hot swap and the version ring: ROADMAP C3)
_VERSION = 0


def pow2_bucket(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, lo), clamped to ``hi`` (which the
    caller guarantees is itself >= n)."""
    b = max(1, int(lo))
    while b < n:
        b <<= 1
    return b if hi is None else min(b, int(hi))


@dataclass(frozen=True)
class ServeRequest:
    """One prediction request: an open-loop arrival from a client."""
    rid: int
    prompt: np.ndarray              # (P,) int32 prompt tokens
    max_new: int                    # tokens to generate
    arrival: float = 0.0            # open-loop arrival time (s)
    client_latency: float = 0.0     # one-way client network latency (s)


@dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray              # (max_new,) int32 generated tokens
    finish: float = 0.0             # clock at completion (stamped by run_*)
    latency: float = 0.0


@dataclass
class StepReport:
    """What one engine step executed."""
    admitted: int
    prefill_shapes: List[Tuple[int, int]]       # (batch_cap, chunk_cap)*
    decode_dispatches: int
    completed: List[Completion] = field(default_factory=list)


@dataclass
class ServeStats:
    n_requests: int
    gen_tokens: int
    makespan: float
    tokens_per_s: float
    p50_latency: float
    p95_latency: float
    engine_steps: int
    decode_rows_live: int           # live rows across all decode dispatches
    decode_rows_total: int          # max_batch * decode dispatches (padded)
    completions: List[Completion] = field(default_factory=list)
    prefill_chunks: int = 0
    decode_dispatches: int = 0
    concurrency_peak: int = 0       # most slots occupied at once
    pages_peak: int = 0             # paged: peak pages resident (slots+trie)
    prefix_hits: int = 0            # paged: admissions that reused pages
    reused_tokens: int = 0          # paged: prompt tokens NOT re-prefilled
    decode_kv_tokens: int = 0       # dense flash: live KV tokens streamed


@dataclass
class _SlotState:
    req: ServeRequest
    gen: List[int]
    filled: int = 0                 # prompt tokens prefilled so far
    pages: List[int] = field(default_factory=list)  # paged: ordered page ids
    n_shared: int = 0               # paged: leading pages read from the trie
    inserted: int = 0               # paged: prompt pages published so far


class ServingEngine:
    """Admission queue + continuous batching over a shared KV cache on
    ``device`` (default ``"cuda"``; raises without CUDA unless the caller
    asks for ``"cpu"``). ``params`` must already lie on that device."""

    def __init__(self, params: ParamTree, cfg: ArchConfig, *,
                 serving: ServingConfig, device: DeviceLike = "cuda"):
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"ServingEngine serves the dense family; "
                f"arch_type={cfg.arch_type!r} is ROADMAP C7")
        if cfg.sliding_window and serving.max_seq > cfg.sliding_window:
            raise ValueError(
                f"max_seq={serving.max_seq} exceeds sliding_window="
                f"{cfg.sliding_window}: the slot cache is linear (no ring)")
        self.device = resolve_device(device)
        pdev = params["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params lie on {pdev}, the engine on "
                             f"{self.device}")
        self.params = params
        self.max_batch = int(serving.max_batch)
        self.max_seq = int(serving.max_seq)
        self.prompt_bucket_min = int(serving.prompt_bucket_min)
        self.prompt_cap = serving.resolved_prompt_cap
        self.decode_kernel = serving.decode_kernel
        self.paged = serving.paging is not None
        if self.paged:
            self.page_size = int(serving.paging.page_size)
            self.pages_per_slot = self.max_seq // self.page_size
            self.n_pages = int(serving.paging.n_pages) \
                if serving.paging.n_pages is not None \
                else self.max_batch * self.pages_per_slot
            self._pool: Optional[PagePool] = PagePool(self.n_pages,
                                                      self.page_size)
            self._trie: Optional[PrefixTrie] = PrefixTrie(self.page_size)
            self.prefix_reuse = bool(serving.paging.prefix_reuse)
            shape = (cfg.n_layers, self.n_pages, self.page_size,
                     cfg.n_kv_heads, cfg.head_dim)
        else:
            self.page_size = None
            self.pages_per_slot = 0
            self.n_pages = 0
            self._pool = None
            self._trie = None
            self.prefix_reuse = False
            shape = (cfg.n_layers, self.max_batch, self.max_seq,
                     cfg.n_kv_heads, cfg.head_dim)
        self._programs = build_serve_programs(
            cfg, paged=self.paged, decode_kernel=self.decode_kernel)
        adt = dtype_of(cfg.activ_dtype)
        self.cache = {"layers": {
            n: torch.zeros(shape, dtype=adt, device=self.device)
            for n in ("k", "v")}}
        self._slots: List[Optional[_SlotState]] = [None] * self.max_batch
        self._pos = np.zeros(self.max_batch, np.int32)
        self._tok = np.zeros(self.max_batch, np.int32)
        self._live = np.zeros(self.max_batch, bool)
        self._queue: Deque[ServeRequest] = deque()
        self._rids_active: set = set()  # queued or in-flight rids
        self._buckets: Dict[Tuple[int, int], int] = {}
        self._reset_counters()

    def _reset_counters(self) -> None:
        self.engine_steps = 0
        self.prefill_chunks = 0
        self.decode_dispatches = 0
        self.decode_rows_live = 0
        self.decode_rows_total = 0
        self.concurrency_peak = 0
        self.pages_peak = 0
        self.prefix_hits = 0
        self.reused_tokens = 0
        self.decode_kv_tokens = 0

    # ------------------------------------------------------------------
    @property
    def buckets_seen(self) -> List[Tuple[int, int]]:
        """``(batch_cap, chunk_cap)`` prefill buckets dispatched so far."""
        return sorted(self._buckets)

    @property
    def pages_free(self) -> int:
        """Paged mode: pages not held by any slot or the prefix trie."""
        return self._pool.n_free if self.paged else 0

    @property
    def trie_pages(self) -> int:
        """Paged mode: pages held (only) as reusable prefix KV."""
        return self._trie.n_pages_held if self.paged else 0

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        # positions ever WRITTEN: prompt [0, plen) by chunks, then decode
        # at plen .. plen+max_new-2 (the last sampled token is returned,
        # never cached) -> plen + max_new - 1 slots of KV
        return -(-(prompt_len + max_new - 1) // self.page_size)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        """Enqueue ``req`` (FIFO). Raises ``ValueError`` for a request
        that can never be served or whose rid is already in scope."""
        p = int(np.asarray(req.prompt).size)
        if p < 1 or req.max_new < 1:
            raise ValueError(f"request {req.rid}: empty prompt or max_new")
        if p + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt({p}) + max_new({req.max_new}) "
                f"exceeds max_seq={self.max_seq}")
        if self.paged and self._pages_needed(p, req.max_new) > self.n_pages:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self._pages_needed(p, req.max_new)} pages, pool has "
                f"{self.n_pages} — can never be admitted")
        if req.rid in self._rids_active:
            raise ValueError(
                f"request {req.rid}: duplicate rid already queued or in "
                f"flight")
        self._queue.append(req)
        self._rids_active.add(req.rid)

    # ------------------------------------------------------------------
    @staticmethod
    def _sample(logits: torch.Tensor) -> np.ndarray:
        """Greedy next token per row of ``(B, V)`` logits. ``argmax``
        keeps the FIRST index among tied maxima, as ``jnp.argmax`` does."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _dispatch_chunk(self, tokens: np.ndarray, off: np.ndarray,
                        cl: np.ndarray, slots: np.ndarray,
                        group: List[int]) -> np.ndarray:
        """One bucketed prefill-chunk dispatch; returns each row's next
        token (meaningful on rows whose prompt completes)."""
        args = (self.params, self._dev(tokens), self._dev(off),
                self._dev(cl))
        if self.paged:
            rmap, wmap = self._chunk_page_maps(group, len(slots))
            logits, _ = self._programs.prefill_chunk(
                *args, self.cache, self._dev(rmap), self._dev(wmap))
            return self._sample(logits[:, -1, :])
        # gather the group's slot rows; padding rows carry slot ==
        # max_batch — clamped for the gather (junk, outputs dropped) and
        # left out of the scatter back (JAX drops that write)
        idx = self._dev(np.minimum(slots, self.max_batch - 1).astype(np.int64))
        rows = {"layers": {n: self.cache["layers"][n][:, idx]
                           for n in ("k", "v")}}
        logits, rows = self._programs.prefill_chunk(*args, rows)
        keep = np.nonzero(slots < self.max_batch)[0]
        dst, src = self._dev(slots[keep].astype(np.int64)), self._dev(keep)
        for n in ("k", "v"):
            buf = self.cache["layers"][n]
            buf[:, dst] = rows["layers"][n][:, src].to(buf.dtype)
        return self._sample(logits[:, -1, :])

    def _dispatch_decode(self, group: np.ndarray) -> np.ndarray:
        """ONE fixed-shape ragged decode dispatch over all slots."""
        args = (self.params, self._dev(self._tok[:, None]),
                self._dev(self._pos), self.cache, self._dev(group))
        if self.paged:
            rmap, wmap = self._decode_page_maps(group)
            logits, _ = self._programs.decode(*args, self._dev(rmap),
                                              self._dev(wmap))
        else:
            logits, _ = self._programs.decode(*args)
        return self._sample(logits[:, -1, :])

    # ------------------------------------------------------------------
    def _finish(self, s: int) -> Completion:
        st = self._slots[s]
        self._slots[s] = None
        self._live[s] = False
        self._pos[s] = 0
        self._tok[s] = 0
        self._rids_active.discard(st.req.rid)
        if self.paged:
            for p in st.pages:          # drop the slot's reference; pages
                self._pool.decref(p)    # the trie published stay resident
        return Completion(rid=st.req.rid, prompt_len=len(st.req.prompt),
                          tokens=np.asarray(st.gen, np.int32))

    # -- paged-mode host bookkeeping -----------------------------------
    def _plan_pages(self, req: ServeRequest
                    ) -> Optional[Tuple[List[int], int]]:
        """Admission-time page plan: the longest reusable prefix run from
        the trie plus freshly allocated pages for everything the request
        will write, evicting idle trie pages if the free list runs short.
        Returns ``(pages, n_shared)`` or None when the pool cannot satisfy
        the request yet. All or nothing."""
        plen = len(req.prompt)
        shared: List[int] = []
        if self.prefix_reuse:
            # never reuse the page holding the prompt's LAST token: at
            # least one real token must go through prefill so the final
            # chunk's logits produce the first sampled token
            shared = self._trie.lookup(_VERSION, req.prompt,
                                       (plen - 1) // self.page_size)
        for p in shared:                # pin before any eviction could
            self._pool.incref(p)        # reap a ref==1 trie page
        own_need = self._pages_needed(plen, req.max_new) - len(shared)
        own = self._pool.alloc(own_need)
        if own is None:
            self._trie.evict_idle(self._pool, own_need - self._pool.n_free)
            own = self._pool.alloc(own_need)
        if own is None:
            for p in shared:
                self._pool.decref(p)
            return None
        if shared:
            self.prefix_hits += 1
            self.reused_tokens += len(shared) * self.page_size
        return shared + own, len(shared)

    def _chunk_page_maps(self, group: List[int], bcap: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(read map, write map) for one prefill-chunk dispatch: row i
        maps slot ``group[i]``'s pages in order; every other entry is OOB
        (== n_pages). The write map also OOBs FROZEN pages."""
        rmap = np.full((bcap, self.pages_per_slot), self.n_pages, np.int32)
        wmap = np.full((bcap, self.pages_per_slot), self.n_pages, np.int32)
        for i, s in enumerate(group):
            for j, p in enumerate(self._slots[s].pages):
                rmap[i, j] = p
                if not self._pool.frozen[p]:
                    wmap[i, j] = p
        return rmap, wmap

    def _decode_page_maps(self, group: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(read map, write map) over ALL slots for one decode dispatch;
        only rows in ``group`` may write."""
        rmap = np.full((self.max_batch, self.pages_per_slot), self.n_pages,
                       np.int32)
        wmap = np.full((self.max_batch, self.pages_per_slot), self.n_pages,
                       np.int32)
        for s in range(self.max_batch):
            st = self._slots[s]
            if st is None:
                continue
            for j, p in enumerate(st.pages):
                rmap[s, j] = p
                if group[s] and not self._pool.frozen[p]:
                    wmap[s, j] = p
        return rmap, wmap

    def _publish_prompt_pages(self, st: _SlotState) -> None:
        """Offer the slot's COMPLETED prompt pages to the prefix trie. A
        published page is increfed by the trie and FROZEN: it leaves every
        future write map, so later forks read it copy-on-write. If an
        identical prompt published first, our copy stays private."""
        plen = len(st.req.prompt)
        n_done = min(st.filled // self.page_size, plen // self.page_size)
        while st.inserted < n_done:
            j = st.inserted
            page = st.pages[j]
            if self._trie.insert(_VERSION, st.req.prompt, j, page):
                self._pool.incref(page)
                self._pool.frozen[page] = True
            st.inserted += 1

    def _run_chunks(self, completed: List[Completion]
                    ) -> List[Tuple[int, int]]:
        """Feed one <=prompt_cap chunk to every slot with prompt tokens
        pending, in one bucketed dispatch. A slot whose prompt completes
        takes its first token and goes live (decodable this same step)."""
        group = [s for s in range(self.max_batch)
                 if self._slots[s] is not None
                 and self._slots[s].filled < len(self._slots[s].req.prompt)]
        if not group:
            return []
        clens = [min(len(self._slots[s].req.prompt) - self._slots[s].filled,
                     self.prompt_cap) for s in group]
        bcap = pow2_bucket(len(group))
        ccap = pow2_bucket(max(clens), lo=self.prompt_bucket_min,
                           hi=self.prompt_cap)
        tokens = np.zeros((bcap, ccap), np.int32)
        off = np.zeros(bcap, np.int32)
        cl = np.zeros(bcap, np.int32)
        slots = np.full(bcap, self.max_batch, np.int32)
        for i, s in enumerate(group):
            st = self._slots[s]
            tokens[i, :clens[i]] = st.req.prompt[st.filled:st.filled + clens[i]]
            off[i] = st.filled
            cl[i] = clens[i]
            slots[i] = s
        nxt = self._dispatch_chunk(tokens, off, cl, slots, group)
        self._buckets[(bcap, ccap)] = self._buckets.get((bcap, ccap), 0) + 1
        self.prefill_chunks += 1
        for i, s in enumerate(group):
            st = self._slots[s]
            st.filled += clens[i]
            self._pos[s] = st.filled
            if self.paged and self.prefix_reuse:
                self._publish_prompt_pages(st)
            if st.filled == len(st.req.prompt):
                st.gen = [int(nxt[i])]
                self._tok[s] = int(nxt[i])
                self._live[s] = True
                if st.req.max_new <= 1:
                    completed.append(self._finish(s))
        return [(bcap, ccap)]

    def step(self) -> StepReport:
        """One engine iteration: admit waiting requests into free slots,
        run one prefill chunk for every slot with prompt pending, then
        one decode dispatch across all slots."""
        completed: List[Completion] = []
        free = [s for s in range(self.max_batch) if self._slots[s] is None]
        admitted = 0
        while self._queue and free:
            req = self._queue[0]
            if self.paged:
                plan = self._plan_pages(req)
                if plan is None:
                    break               # strict FIFO: the head of the
                                        # line waits for pages to free
                pages, n_shared = plan
                reused = n_shared * self.page_size
            else:
                pages, n_shared, reused = [], 0, 0
            self._queue.popleft()
            s = free.pop(0)
            self._slots[s] = _SlotState(req=req, gen=[], filled=reused, pages=pages,
                                        n_shared=n_shared,
                                        inserted=n_shared)
            self._pos[s] = reused
            self._live[s] = False
            admitted += 1
        self.concurrency_peak = max(
            self.concurrency_peak,
            sum(1 for st in self._slots if st is not None))
        if self.paged:
            self.pages_peak = max(self.pages_peak, self._pool.n_used)

        prefill_shapes = self._run_chunks(completed)
        dispatches = 0
        if self._live.any():
            self._step_decode(completed)
            dispatches = 1
        self.engine_steps += 1
        return StepReport(admitted, prefill_shapes, dispatches, completed)

    def _step_decode(self, completed: List[Completion]) -> None:
        """ONE fixed-shape ragged decode dispatch over every slot, each
        live row advancing exactly one token."""
        group = self._live.copy()
        live_rows = np.nonzero(group)[0]
        if not self.paged and self.decode_kernel == "flash":
            # the kernel's pos-bounded scan reads only the live KV tokens
            self.decode_kv_tokens += sum(int(self._pos[s]) + 1
                                         for s in live_rows)
        nxt = self._dispatch_decode(group)
        self.decode_dispatches += 1
        self.decode_rows_live += len(live_rows)
        self.decode_rows_total += self.max_batch
        for s in live_rows:
            st = self._slots[s]
            st.gen.append(int(nxt[s]))
            self._pos[s] += 1
            self._tok[s] = int(nxt[s])
            if len(st.gen) >= st.req.max_new:
                completed.append(self._finish(s))

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _stats(self, completions: List[Completion],
               makespan: float) -> ServeStats:
        lats = [c.latency for c in completions]
        gen = sum(int(c.tokens.size) for c in completions)
        return ServeStats(
            n_requests=len(completions), gen_tokens=gen, makespan=makespan,
            tokens_per_s=gen / makespan if makespan > 0 else float("inf"),
            p50_latency=float(np.percentile(lats, 50)) if lats else 0.0,
            p95_latency=float(np.percentile(lats, 95)) if lats else 0.0,
            engine_steps=self.engine_steps,
            decode_rows_live=self.decode_rows_live,
            decode_rows_total=self.decode_rows_total,
            completions=completions, prefill_chunks=self.prefill_chunks,
            decode_dispatches=self.decode_dispatches,
            concurrency_peak=self.concurrency_peak,
            pages_peak=self.pages_peak, prefix_hits=self.prefix_hits,
            reused_tokens=self.reused_tokens,
            decode_kv_tokens=self.decode_kv_tokens)

    def run_closed_loop(self,  # reprolint: exempt[RL002]
                        requests: Sequence[ServeRequest]) -> ServeStats:
        """All requests available at t=0, served to completion; real
        wall-clock timing (every step ends in a device-to-host copy of
        the sampled tokens, so the clock sees the device's work)."""
        if self.has_work:
            raise RuntimeError("engine already has work in flight; one "
                               "run_closed_loop call at a time")
        self._reset_counters()
        self._rids_active = set()   # rids are scoped per run
        for r in sorted(requests, key=lambda r: r.rid):
            self.submit(r)
        t0 = time.perf_counter()
        out: List[Completion] = []
        while self.has_work:
            rep = self.step()
            now = time.perf_counter() - t0
            for c in rep.completed:
                c.finish = now
                c.latency = now
                out.append(c)
        return self._stats(out, makespan=time.perf_counter() - t0)
