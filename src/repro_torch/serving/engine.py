"""Continuous-batching inference engine (PyTorch port of
``repro.serving.engine``).

The engine owns ONE preallocated KV buffer on the device and interleaves
prefill and decode over it, so requests of any prompt and generation
length join and leave mid-flight. Two layouts:

  - the DENSE slot cache ``(n_layers, max_batch, max_seq, K, hd)``;
  - the PAGED pool ``(n_layers, n_pages, page_size, K, hd)`` (``paging``
    set), with per-slot page lists on the host and cross-request PREFIX
    REUSE: a radix trie keyed on (param version, prompt-token pages) lets
    requests that share a prompt prefix prefill it once and fork
    copy-on-write (shared pages are frozen — mapped out of bounds in
    every write map — so a fork never copies and never writes its
    parent's pages).

Each step: shed queued requests past their admission deadline, admit
queued requests into free slots (FIFO; in paged mode the head of the line
waits for pages), feed every slot with prompt pending one chunk of at
most ``prompt_cap`` tokens (padded to a power-of-two ``(batch_cap,
chunk_cap)`` bucket, one dispatch per pinned version), then ONE decode
dispatch per live version over all slots with per-slot positions and the
version group as the live mask. With ``decode_kernel="flash"`` decode
attention runs the hand-written flash-decode kernel on the card (its
plain version on CPU tensors).

**Hot swap** (the live train->serve loop): ``swap_params(params,
version)`` installs a new latest version while requests are in flight.
Every slot pins the version it was admitted under and finishes there; a
ring holds the pinned versions plus the latest, and a version retires
(with its prefix-trie generation) as its last pinned slot completes. KV
pages belong to the version that wrote them.

**Backpressure**: ``max_queue`` bounds the admission queue; overload
sheds explicitly under ``shed_policy`` (``"reject"`` refuses the
newcomer, ``"drop_oldest"`` displaces the stalest wait), and admission
deadlines shed queued requests whose client has given up. Every shed is
recorded in ``shed_log``; an admitted request always finishes.

**Sampling**: greedy by default, else temperature / top-k with draws
that depend only on (seed, request id, token index, logits)
(``serving/sampling.py``).

**Speculative decoding** (``speculative`` set, greedy only): each round
a draft LM proposes up to k tokens for every live row in ONE dispatch,
then the served model checks them with ONE prefill-chunk-shaped VERIFY
dispatch per live version, which replaces the decode dispatch. The
longest prefix of drafts equal to the target's own argmax chain is kept,
plus the target's token at the first mismatch, so the emitted stream is
the target's greedy stream token for token; the draft decides only how
many tokens one dispatch advances. A speculative engine launches no
flash-decode kernel.

**Timing**: ``SimulatedServeSession`` drives the engine on a
discrete-event clock charged by a ``ServeCostModel`` over the padded
shapes each step executed, with timestamped arrivals and param swaps —
how ``launch/train_serve.py`` threads one clock through training and
serving; ``run_simulated`` wraps it, ``run_closed_loop`` measures the
wall clock.

Slot invariant: cache row ``s`` is valid exactly on ``[0, pos_s]`` and
decode at position ``p`` overwrites index ``p`` before attending to it,
so freed rows never need scrubbing.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flatbuf import tree_paths
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree, dtype_of
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.paging import PagePool, PrefixTrie
from repro_torch.serving.sampling import sample_tokens
from repro_torch.train.step import build_draft_program, build_serve_programs


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
    deadline: Optional[float] = None  # max queue wait (s) before this
                                      # request sheds; None defers to the
                                      # engine's admission_deadline


@dataclass(frozen=True)
class Shed:
    """One load-shedding decision: the record that a request was REFUSED
    rather than served."""
    rid: int
    reason: str                     # "queue_full" | "displaced" | "deadline"
    t: float = 0.0                  # clock at the shedding decision


@dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray              # (max_new,) int32 generated tokens
    finish: float = 0.0             # clock at completion (stamped by run_*)
    latency: float = 0.0            # finish - arrival + 2*client_latency
    version: int = 0                # param version pinned at admission


@dataclass
class StepReport:
    """What one engine step executed — the unit the cost model charges."""
    admitted: int
    prefill_shapes: List[Tuple[int, int]]       # (batch_cap, chunk_cap)*
    decode_dispatches: int                      # one per live version
    completed: List[Completion] = field(default_factory=list)
    shed: List[Shed] = field(default_factory=list)  # deadline sheds this step
    decode_pages: List[int] = field(default_factory=list)
    # ^ paged mode only: KV pages READ per decode dispatch (sum over the
    #   dispatch's live rows of pos//page_size + 1)
    decode_kv: List[int] = field(default_factory=list)
    # ^ dense flash-decode only: KV tokens READ per decode dispatch (sum
    #   over live rows of pos + 1)
    verify_shapes: List[Tuple[int, int]] = field(default_factory=list)
    # ^ speculative mode: (batch, chunk_cap) of each verify dispatch —
    #   charged at prefill rates by the cost model
    draft_dispatches: int = 0           # speculative draft calls


@dataclass
class ServeStats:
    n_requests: int
    gen_tokens: int
    makespan: float
    tokens_per_s: float
    p50_latency: float
    p95_latency: float
    engine_steps: int
    prefill_tokens: int             # padded prefill tokens charged
    decode_rows_live: int           # live rows across all decode dispatches
    decode_rows_total: int          # max_batch * decode dispatches (padded)
    completions: List[Completion] = field(default_factory=list)
    prefill_chunks: int = 0
    decode_dispatches: int = 0
    swap_count: int = 0             # param swaps applied during the run
    versions_served: Dict[int, int] = field(default_factory=dict)
    n_shed: int = 0                 # requests shed (never silently lost)
    queue_peak: int = 0             # deepest the admission queue got
    shed: List[Shed] = field(default_factory=list)
    concurrency_peak: int = 0       # most slots occupied at once
    pages_peak: int = 0             # paged: peak pages resident (slots+trie)
    prefix_hits: int = 0            # paged: admissions that reused pages
    reused_tokens: int = 0          # paged: prompt tokens NOT re-prefilled
    decode_kv_tokens: int = 0       # dense flash: live KV tokens streamed
    spec_rounds: int = 0            # speculative: (row, verify) rounds run
    drafted: int = 0                # speculative: draft tokens proposed
    accepted: int = 0               # speculative: draft tokens accepted


@dataclass
class _SlotState:
    req: ServeRequest
    gen: List[int]
    ver: int                        # pinned param version
    filled: int = 0                 # prompt tokens prefilled so far
    pages: List[int] = field(default_factory=list)  # paged: ordered page ids
    n_shared: int = 0               # paged: leading pages read from the trie
    inserted: int = 0               # paged: prompt pages published so far


def _leaf_sig(params: ParamTree) -> List[Tuple[Any, ...]]:
    return [(path, tuple(x.shape), x.dtype, x.device)
            for path, x in tree_paths(params)]


class ServingEngine:
    """Admission queue + continuous batching over a shared KV cache on
    ``device`` (default ``"cuda"``; raises without CUDA unless the caller
    asks for ``"cpu"``), with in-flight param hot swap, backpressure and
    temperature / top-k sampling. ``params`` must already lie on that
    device."""

    def __init__(self, params: ParamTree, cfg: ArchConfig, *,
                 serving: ServingConfig, device: DeviceLike = "cuda"):
        if cfg.arch_type not in ("dense", "moe"):
            raise ValueError(
                f"ServingEngine supports attention-cached LM archs "
                f"(dense/moe), not {cfg.arch_type!r}")
        if cfg.sliding_window and serving.max_seq > cfg.sliding_window:
            raise ValueError(
                f"max_seq={serving.max_seq} exceeds sliding_window="
                f"{cfg.sliding_window}: the slot cache is linear (no ring)")
        if cfg.arch_type == "moe" and \
                cfg.moe.capacity_factor * cfg.moe.experts_per_token \
                < cfg.moe.n_experts:
            # per-row expert capacity ceil(S*k/E*cf) comes from the PADDED
            # prefill length and the junk tail is routed too; only
            # cf >= E/k guarantees no row can overflow, so below that a
            # ragged batch may part from an unpadded run when routing is
            # skewed (transformer.prefill's docstring)
            warnings.warn(
                f"{cfg.name}: MoE capacity_factor="
                f"{cfg.moe.capacity_factor} can bind under padded ragged "
                f"prefill (needs >= n_experts/experts_per_token = "
                f"{cfg.moe.n_experts / cfg.moe.experts_per_token:.2f} for "
                f"exactness); outputs are approximate when an expert "
                f"overflows", stacklevel=2)
        self.device = resolve_device(device)
        pdev = params["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params lie on {pdev}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self._spec = serving.speculative
        if self._spec is not None:
            dcfg = self._spec.draft_cfg
            if dcfg.arch_type not in ("dense", "moe"):
                raise ValueError(
                    f"speculative draft must be an attention LM "
                    f"(dense/moe), not {dcfg.arch_type!r}")
            if dcfg.vocab_size < cfg.vocab_size:
                raise ValueError(
                    f"speculative draft vocab_size={dcfg.vocab_size} "
                    f"cannot consume served tokens (vocab_size="
                    f"{cfg.vocab_size})")
            ddev = self._spec.draft_params["embed"].device
            if ddev.type != self.device.type:
                raise ValueError(f"draft params lie on {ddev}, the engine "
                                 f"on {self.device}")
            self._draft = build_draft_program(dcfg, k=self._spec.k,
                                              window=self._spec.window)
        self.max_batch = int(serving.max_batch)
        self.max_seq = int(serving.max_seq)
        self.prompt_bucket_min = int(serving.prompt_bucket_min)
        self.prompt_cap = serving.resolved_prompt_cap
        self.decode_kernel = serving.decode_kernel
        self._temperature = float(serving.sampling.temperature)
        self._top_k = int(serving.sampling.top_k)
        self._sample_seed = int(serving.sampling.sample_seed)
        # the version ring: pinned live versions + the latest. A version
        # retires the moment its last pinned slot completes
        # (``_gc_versions`` runs from both ``swap_params`` and
        # ``_finish``), so the ring never exceeds max_batch + 1 trees
        self.version = int(serving.start_version)
        self._versions: Dict[int, ParamTree] = {self.version: params}
        self._sig = _leaf_sig(params)
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
        # backpressure: bound the admission queue and shed the overflow
        # EXPLICITLY (bounds validated by BackpressureConfig)
        self.max_queue = serving.backpressure.max_queue
        self.shed_policy = serving.backpressure.shed_policy
        self.admission_deadline = serving.backpressure.admission_deadline
        self._buckets: Dict[Tuple[int, int], int] = {}
        self._verify_buckets: Dict[Tuple[int, int], int] = {}
        self._begin_run()

    def _begin_run(self) -> None:
        """Reset the per-run counters and the rid scope (a replay reuses
        the same ids legitimately); one run at a time. The bucket record
        is engine-lifetime."""
        if self.has_work:
            raise RuntimeError("engine already has work in flight; one "
                               "run_* call at a time")
        self._rids_active = set()
        self.engine_steps = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.decode_dispatches = 0
        self.decode_rows_live = 0
        self.decode_rows_total = 0
        self.swap_count = 0
        self.shed_log: List[Shed] = []
        self.queue_peak = 0
        self.concurrency_peak = 0
        self.pages_peak = 0
        self.prefix_hits = 0
        self.reused_tokens = 0
        self.decode_kv_tokens = 0
        self.spec_rounds = 0
        self.drafted = 0
        self.accepted = 0

    # ------------------------------------------------------------------
    @property
    def params(self) -> ParamTree:
        """The LATEST param tree — what new admissions are served under."""
        return self._versions[self.version]

    @property
    def live_versions(self) -> List[int]:
        """Versions currently held in the ring (pinned and/or latest)."""
        return sorted(self._versions)

    @property
    def buckets_seen(self) -> List[Tuple[int, int]]:
        """``(batch_cap, chunk_cap)`` prefill buckets dispatched so far."""
        return sorted(self._buckets)

    @property
    def verify_buckets_seen(self) -> List[Tuple[int, int]]:
        """Speculative mode: ``(batch, chunk_cap)`` verify buckets
        dispatched so far — one, ``(max_batch, pow2_bucket(k + 1))``."""
        return sorted(self._verify_buckets)

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

    def flush_prefix_cache(self) -> int:
        """Drop every trie-held page (all versions); returns pages
        released. Slot-held pages are untouched."""
        return self._trie.drop_all(self._pool) if self.paged else 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest, now: Optional[float] = None) -> bool:
        """Enqueue ``req``. Returns True when admitted to the queue, False
        when shed by backpressure (recorded in ``shed_log``). ``now``
        stamps any shed this call causes and defaults to ``req.arrival``.
        Raises ``ValueError`` for a request that can never be served or
        whose rid is already queued or in flight."""
        t = float(now) if now is not None else float(req.arrival)
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
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.shed_policy == "reject":
                self.shed_log.append(Shed(req.rid, "queue_full", t))
                return False
            victim = self._queue.popleft()       # drop_oldest: the victim
            self._rids_active.discard(victim.rid)  # is the stalest wait
            self.shed_log.append(Shed(victim.rid, "displaced", t))
        self._queue.append(req)
        self._rids_active.add(req.rid)
        self.queue_peak = max(self.queue_peak, len(self._queue))
        return True

    # ------------------------------------------------------------------
    def swap_params(self, params: ParamTree, version: Optional[int] = None
                    ) -> int:
        """Install ``params`` as the latest served version while requests
        are in flight: admitted slots keep decoding under the version they
        pinned; every admission from now on uses the new tree. The tree
        must match the served one leaf for leaf (paths, shapes, dtypes,
        device). No device copy is made: the engine holds the caller's
        tensors, which must not be written in place afterwards. Returns
        the installed version number."""
        sig = _leaf_sig(params)
        if [s[0] for s in sig] != [s[0] for s in self._sig]:
            raise ValueError(
                "swap_params: tree structure differs from the served model")
        for new, old in zip(sig, self._sig):
            if new != old:
                raise ValueError(
                    f"swap_params: leaf {'/'.join(new[0])} is "
                    f"{new[1]}/{new[2]} on {new[3]}, the served model's "
                    f"{old[1]}/{old[2]} on {old[3]}")
        if version is None:
            version = self.version + 1
        if version <= self.version:
            raise ValueError(f"swap_params: version {version} must exceed "
                             f"the current latest {self.version}")
        self._versions[int(version)] = params
        self.version = int(version)
        self.swap_count += 1
        self._gc_versions()
        return self.version

    def _gc_versions(self) -> None:
        """Retire ring versions with no pinned slot. In paged mode a
        retired version also drops its prefix-trie generation: KV pages
        are valid only under the version that wrote them, and no future
        admission can pin a retired version."""
        pinned = {st.ver for st in self._slots if st is not None}
        pinned.add(self.version)
        for v in [v for v in self._versions if v not in pinned]:
            del self._versions[v]
            if self.paged:
                self._trie.drop_version(v, self._pool)

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, rids: np.ndarray,
                gidx: np.ndarray) -> np.ndarray:
        """Next token per row of ``(B, V)`` logits (``serving/sampling``)."""
        nxt = sample_tokens(logits, rids, gidx,
                            temperature=self._temperature, top_k=self._top_k,
                            seed=self._sample_seed)
        return nxt.cpu().numpy()

    def _dispatch_chunk(self, params: ParamTree, tokens: np.ndarray,
                        off: np.ndarray, cl: np.ndarray, slots: np.ndarray,
                        rids: np.ndarray, group: List[int]) -> np.ndarray:
        """One bucketed prefill-chunk dispatch; returns each row's next
        token (meaningful on rows whose prompt completes)."""
        args = (params, self._dev(tokens), self._dev(off), self._dev(cl))
        gidx = np.zeros_like(rids)
        if self.paged:
            rmap, wmap = self._chunk_page_maps(group, len(slots))
            logits, _ = self._programs.prefill_chunk(
                *args, self.cache, self._dev(rmap), self._dev(wmap))
            return self._sample(logits[:, -1, :], rids, gidx)
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
        return self._sample(logits[:, -1, :], rids, gidx)

    def _dispatch_decode(self, params: ParamTree, group: np.ndarray,
                         rids: np.ndarray, gidx: np.ndarray) -> np.ndarray:
        """ONE fixed-shape ragged decode dispatch over all slots; only the
        rows in ``group`` (one version's live rows) write and advance."""
        args = (params, self._dev(self._tok[:, None]),
                self._dev(self._pos), self.cache, self._dev(group))
        if self.paged:
            rmap, wmap = self._decode_page_maps(group)
            logits, _ = self._programs.decode(*args, self._dev(rmap),
                                              self._dev(wmap))
        else:
            logits, _ = self._programs.decode(*args)
        return self._sample(logits[:, -1, :], rids, gidx)

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
        self._gc_versions()
        return Completion(rid=st.req.rid, prompt_len=len(st.req.prompt),
                          tokens=np.asarray(st.gen, np.int32),
                          version=st.ver)

    # -- paged-mode host bookkeeping -----------------------------------
    def _plan_pages(self, req: ServeRequest
                    ) -> Optional[Tuple[List[int], int]]:
        """Admission-time page plan: the longest reusable prefix run from
        the trie under the CURRENT version (what this admission pins) plus
        freshly allocated pages for everything the request will write,
        evicting idle trie pages if the free list runs short. Returns
        ``(pages, n_shared)`` or None when the pool cannot satisfy the
        request yet. All or nothing."""
        plen = len(req.prompt)
        shared: List[int] = []
        if self.prefix_reuse:
            # never reuse the page holding the prompt's LAST token: at
            # least one real token must go through prefill so the final
            # chunk's logits produce the first sampled token
            shared = self._trie.lookup(self.version, req.prompt,
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
        only rows in ``group`` (this dispatch's version) may write."""
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
        """Offer the slot's COMPLETED prompt pages to the prefix trie,
        under the slot's pinned version (the tree the KV was computed
        with). A published page is increfed by the trie and FROZEN: it
        leaves every future write map, so later forks read it
        copy-on-write. If an identical prompt published first, our copy
        stays private."""
        plen = len(st.req.prompt)
        n_done = min(st.filled // self.page_size, plen // self.page_size)
        while st.inserted < n_done:
            j = st.inserted
            page = st.pages[j]
            if self._trie.insert(st.ver, st.req.prompt, j, page):
                self._pool.incref(page)
                self._pool.frozen[page] = True
            st.inserted += 1

    def _run_chunks(self, completed: List[Completion]
                    ) -> List[Tuple[int, int]]:
        """Feed one <=prompt_cap chunk to every slot with prompt tokens
        pending, one bucketed dispatch per pinned version present. A slot
        whose prompt completes takes its first token and goes live
        (decodable this same step)."""
        shapes: List[Tuple[int, int]] = []
        todo = [s for s in range(self.max_batch)
                if self._slots[s] is not None
                and self._slots[s].filled < len(self._slots[s].req.prompt)]
        for ver in sorted({self._slots[s].ver for s in todo}):
            group = [s for s in todo if self._slots[s].ver == ver]
            clens = [min(len(self._slots[s].req.prompt)
                         - self._slots[s].filled, self.prompt_cap)
                     for s in group]
            bcap = pow2_bucket(len(group))
            ccap = pow2_bucket(max(clens), lo=self.prompt_bucket_min,
                               hi=self.prompt_cap)
            tokens = np.zeros((bcap, ccap), np.int32)
            off = np.zeros(bcap, np.int32)
            cl = np.zeros(bcap, np.int32)
            slots = np.full(bcap, self.max_batch, np.int32)
            rids = np.zeros(bcap, np.int32)
            for i, s in enumerate(group):
                st = self._slots[s]
                tokens[i, :clens[i]] = \
                    st.req.prompt[st.filled:st.filled + clens[i]]
                off[i] = st.filled
                cl[i] = clens[i]
                slots[i] = s
                rids[i] = st.req.rid % (2 ** 31)
            nxt = self._dispatch_chunk(self._versions[ver], tokens, off, cl,
                                       slots, rids, group)
            self._buckets[(bcap, ccap)] = \
                self._buckets.get((bcap, ccap), 0) + 1
            self.prefill_tokens += bcap * ccap
            self.prefill_chunks += 1
            shapes.append((bcap, ccap))
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
        return shapes

    def step(self, now: Optional[float] = None) -> StepReport:
        """One engine iteration: admit waiting requests into free slots,
        run one prefill chunk for every slot with prompt pending
        (bucketed, grouped by pinned version), then one decode dispatch
        per live version across all slots. Returns what ran.

        When the caller supplies ``now``, queued requests whose wait has
        exceeded their admission deadline (``req.deadline``, else the
        engine's ``admission_deadline``) are shed BEFORE admission.
        In-flight requests never shed."""
        completed: List[Completion] = []
        shed: List[Shed] = []
        if now is not None and self._queue:
            kept: Deque[ServeRequest] = deque()
            for req in self._queue:
                dl = req.deadline if req.deadline is not None \
                    else self.admission_deadline
                if dl is not None and now - req.arrival > dl:
                    self._rids_active.discard(req.rid)
                    s = Shed(req.rid, "deadline", float(now))
                    self.shed_log.append(s)
                    shed.append(s)
                else:
                    kept.append(req)
            self._queue = kept
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
            self._slots[s] = _SlotState(req=req, gen=[], ver=self.version,
                                        filled=reused, pages=pages,
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
        decode_pages: List[int] = []
        decode_kv: List[int] = []
        verify_shapes: List[Tuple[int, int]] = []
        draft_dispatches = 0
        if self._live.any():
            if self._spec is not None:
                dispatches, draft_dispatches = self._step_speculative(
                    completed, verify_shapes)
            else:
                dispatches = self._step_decode(completed, decode_pages,
                                               decode_kv)
        self.engine_steps += 1
        return StepReport(admitted, prefill_shapes, dispatches, completed,
                          shed, decode_pages, decode_kv, verify_shapes,
                          draft_dispatches)

    def _step_decode(self, completed: List[Completion],
                     decode_pages: List[int], decode_kv: List[int]) -> int:
        """ONE fixed-shape ragged decode dispatch per live version, each
        of the version's live rows advancing exactly one token. Returns
        the number of dispatches."""
        rids = np.zeros(self.max_batch, np.int32)
        gidx = np.zeros(self.max_batch, np.int32)
        for s in range(self.max_batch):
            if self._live[s]:
                rids[s] = self._slots[s].req.rid % (2 ** 31)
                gidx[s] = len(self._slots[s].gen)
        vers = sorted({self._slots[s].ver
                       for s in range(self.max_batch) if self._live[s]})
        for ver in vers:
            group = np.array([self._live[s] and self._slots[s].ver == ver
                              for s in range(self.max_batch)], bool)
            rows = np.nonzero(group)[0]
            if self.paged:
                decode_pages.append(sum(int(self._pos[s]) // self.page_size
                                        + 1 for s in rows))
            elif self.decode_kernel == "flash":
                # the kernel's pos-bounded scan reads only the live KV
                kv = sum(int(self._pos[s]) + 1 for s in rows)
                decode_kv.append(kv)
                self.decode_kv_tokens += kv
            nxt = self._dispatch_decode(self._versions[ver], group, rids,
                                        gidx)
            self.decode_dispatches += 1
            self.decode_rows_live += len(rows)
            self.decode_rows_total += self.max_batch
            for s in rows:
                st = self._slots[s]
                st.gen.append(int(nxt[s]))
                self._pos[s] += 1
                self._tok[s] = int(nxt[s])
                if len(st.gen) >= st.req.max_new:
                    completed.append(self._finish(s))
        return len(vers)

    def _step_speculative(self, completed: List[Completion],
                          verify_shapes: List[Tuple[int, int]]
                          ) -> Tuple[int, int]:
        """One speculative round: draft up to k tokens per live row in
        ONE dispatch, then verify each live version's rows in ONE
        prefill-chunk-shaped dispatch over [current token, drafts...] at
        the row's frontier (row == slot; rows outside the version carry
        ``clen == 0`` and neither write nor count). Greedy accept rule:
        the longest prefix of drafts equal to the target's argmax chain,
        plus the target's token at the first mismatch (or the bonus token
        when all match). Rejected drafts leave KV past the new frontier,
        which the next chunk overwrites before any query attends it.
        Returns ``(verify dispatches, draft dispatches)``."""
        spec = self._spec
        B, W, k = self.max_batch, spec.window, spec.k
        win = np.zeros((B, W), np.int32)
        hlen = np.zeros(B, np.int32)
        kb = np.zeros(B, np.int32)
        for s in range(B):
            if not self._live[s]:
                continue
            st = self._slots[s]
            hist = list(st.req.prompt) + st.gen
            take = min(len(hist), W - k)
            win[s, :take] = hist[-take:]
            hlen[s] = take
            # never draft past the request's budget: emitting <= kb+1
            # tokens keeps gen within max_new and every KV write within
            # the row's pages / max_seq
            kb[s] = min(k, st.req.max_new - len(st.gen) - 1)
        draft_dispatches = 0
        if (kb > 0).any():
            with torch.profiler.record_function("spec.draft"):
                drafts = self._draft(spec.draft_params, self._dev(win),
                                     self._dev(hlen)).cpu().numpy()
            draft_dispatches = 1
            self.drafted += int(kb.sum())
        else:
            drafts = np.zeros((B, k), np.int32)
        vcap = pow2_bucket(k + 1)       # pinned: ONE verify bucket ever
        # a draft with a larger vocabulary may propose ids the served
        # embedding lacks: JAX's gather clamps them, and so does this.
        # Such a token never equals the target's argmax, so it is
        # rejected and the columns it feeds are discarded
        vmax = self.cfg.vocab_size - 1
        dispatches = 0
        vers = sorted({self._slots[s].ver
                       for s in range(B) if self._live[s]})
        for ver in vers:
            group = np.array([self._live[s] and self._slots[s].ver == ver
                              for s in range(B)], bool)
            tokens = np.zeros((B, vcap), np.int32)
            off = np.zeros(B, np.int32)
            cl = np.zeros(B, np.int32)
            for s in np.nonzero(group)[0]:
                nkb = int(kb[s])
                tokens[s, 0] = self._tok[s]
                tokens[s, 1:1 + nkb] = np.minimum(drafts[s, :nkb], vmax)
                off[s] = self._pos[s]
                cl[s] = 1 + nkb
            args = (self._versions[ver], self._dev(tokens), self._dev(off),
                    self._dev(cl), self.cache)
            with torch.profiler.record_function("spec.verify"):
                if self.paged:
                    rmap, wmap = self._decode_page_maps(group)
                    logits, _ = self._programs.verify(*args, self._dev(rmap),
                                                      self._dev(wmap))
                else:
                    logits, _ = self._programs.verify(*args)
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # (B, vcap)
            self._verify_buckets[(B, vcap)] = \
                self._verify_buckets.get((B, vcap), 0) + 1
            dispatches += 1
            self.decode_dispatches += 1
            self.decode_rows_live += int(group.sum())
            self.decode_rows_total += B
            verify_shapes.append((B, vcap))
            for s in np.nonzero(group)[0]:
                st = self._slots[s]
                nkb = int(kb[s])
                acc = 0
                while acc < nkb and int(drafts[s, acc]) == int(nxt[s, acc]):
                    acc += 1
                emitted = [int(t) for t in drafts[s, :acc]] \
                    + [int(nxt[s, acc])]
                st.gen.extend(emitted)
                self._pos[s] += len(emitted)
                self._tok[s] = emitted[-1]
                self.spec_rounds += 1
                self.accepted += acc
                if len(st.gen) >= st.req.max_new:
                    completed.append(self._finish(s))
        return dispatches, draft_dispatches

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _stats(self, completions: List[Completion],
               makespan: float) -> ServeStats:
        lats = [c.latency for c in completions]
        gen = sum(int(c.tokens.size) for c in completions)
        versions: Dict[int, int] = {}
        for c in completions:
            versions[c.version] = versions.get(c.version, 0) + 1
        return ServeStats(
            n_requests=len(completions), gen_tokens=gen, makespan=makespan,
            tokens_per_s=gen / makespan if makespan > 0 else float("inf"),
            p50_latency=float(np.percentile(lats, 50)) if lats else 0.0,
            p95_latency=float(np.percentile(lats, 95)) if lats else 0.0,
            engine_steps=self.engine_steps,
            prefill_tokens=self.prefill_tokens,
            decode_rows_live=self.decode_rows_live,
            decode_rows_total=self.decode_rows_total,
            completions=completions, prefill_chunks=self.prefill_chunks,
            decode_dispatches=self.decode_dispatches,
            swap_count=self.swap_count, versions_served=versions,
            n_shed=len(self.shed_log), queue_peak=self.queue_peak,
            shed=list(self.shed_log),
            concurrency_peak=self.concurrency_peak,
            pages_peak=self.pages_peak, prefix_hits=self.prefix_hits,
            reused_tokens=self.reused_tokens,
            decode_kv_tokens=self.decode_kv_tokens,
            spec_rounds=self.spec_rounds, drafted=self.drafted,
            accepted=self.accepted)

    def run_simulated(self, requests: Sequence[ServeRequest], cost: Any,
                      swaps: Sequence[Tuple[float, ParamTree, int]] = ()
                      ) -> ServeStats:
        """Open-loop run on a discrete-event clock: requests arrive at
        ``req.arrival``, each engine step advances the clock by the cost
        model's charge for the padded shapes it executed, and ``swaps`` —
        ``(t, params, version)`` triples — hot-swap the model when the
        clock reaches ``t``. Outputs are the real model's tokens; only
        time is simulated."""
        session = SimulatedServeSession(self, cost, requests)
        for t, params, version in swaps:
            session.push_swap(t, params, version)
        session.drain()
        return session.stats()

    def run_closed_loop(self,  # reprolint: exempt[RL002]
                        requests: Sequence[ServeRequest]) -> ServeStats:
        """All requests available at t=0, served to completion; real
        wall-clock timing (every step ends in a device-to-host copy of
        the sampled tokens, so the clock sees the device's work)."""
        self._begin_run()
        for r in sorted(requests, key=lambda r: r.rid):
            self.submit(r, now=0.0)
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


class SimulatedServeSession:
    """Incremental discrete-event driver over one engine: feed it
    timestamped arrivals and param swaps, then ``advance_to(t)``. This is
    how ``launch/train_serve.py`` threads ONE clock through the training
    event loop and the serving engine. The clock arithmetic (its order of
    additions and its 1e-12 guards) is the JAX package's, so publish
    times, sheds and latencies are the same floats."""

    def __init__(self, engine: ServingEngine, cost: Any,
                 requests: Sequence[ServeRequest] = ()):
        engine._begin_run()
        self.engine = engine
        self.cost = cost
        self._reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._by_rid = {r.rid: r for r in self._reqs}
        if len(self._by_rid) != len(self._reqs):
            raise ValueError("duplicate request ids")
        self._i = 0
        self._swaps: Deque[Tuple[float, ParamTree, Optional[int]]] = deque()
        self.clock = 0.0
        self.completions: List[Completion] = []

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        """Every request is ANSWERED: completed, or explicitly shed
        (``engine.shed_log`` is reset at session start)."""
        return len(self.completions) + len(self.engine.shed_log) \
            == len(self._reqs)

    def push_swap(self, t: float, params: ParamTree,
                  version: Optional[int] = None) -> None:
        """Schedule a hot swap at clock time ``t`` (pushes must arrive in
        time order — the natural order of a training loop's publishes)."""
        if self._swaps and t < self._swaps[-1][0]:
            raise ValueError("swaps must be pushed in time order")
        self._swaps.append((float(t), params, version))

    # ------------------------------------------------------------------
    def _apply_due(self) -> None:
        while self._swaps and self._swaps[0][0] <= self.clock + 1e-12:
            _, params, version = self._swaps.popleft()
            self.engine.swap_params(params, version)
            swap_time = getattr(self.cost, "swap_time", None)
            if swap_time is not None:
                self.clock += swap_time()
        while self._i < len(self._reqs) \
                and self._reqs[self._i].arrival <= self.clock + 1e-12:
            # a False return means the request shed at admission — the
            # refusal is already in engine.shed_log
            self.engine.submit(self._reqs[self._i], now=self.clock)
            self._i += 1

    def _next_event(self) -> Optional[float]:
        times = []
        if self._i < len(self._reqs):
            times.append(self._reqs[self._i].arrival)
        if self._swaps:
            times.append(self._swaps[0][0])
        return min(times) if times else None

    def _step_once(self) -> None:
        rep = self.engine.step(now=self.clock)
        dt = 0.0
        for shape in rep.prefill_shapes:
            dt += self.cost.prefill_time(*shape)
        draft_time = getattr(self.cost, "draft_time", None)
        if rep.draft_dispatches and draft_time is not None:
            spec = self.engine._spec
            dt += rep.draft_dispatches * draft_time(
                spec.k, self.engine.max_batch, spec.window)
        paged_time = getattr(self.cost, "decode_time_paged", None)
        flash_time = getattr(self.cost, "decode_time_flash", None)
        if rep.verify_shapes:
            # speculative: a verify is a prefill-chunk dispatch, charged
            # at prefill rates
            for shape in rep.verify_shapes:
                dt += self.cost.prefill_time(*shape)
        elif rep.decode_pages and paged_time is not None:
            # paged engine: decode streams only the LIVE pages
            for pages in rep.decode_pages:
                dt += paged_time(pages, self.engine.pages_per_slot)
        elif rep.decode_kv and flash_time is not None:
            # dense flash kernel: the pos-bounded scan touches only the
            # live KV tokens, not the full max_seq rectangle
            for kv in rep.decode_kv:
                dt += flash_time(kv, self.engine.max_seq)
        else:
            dt += rep.decode_dispatches \
                * self.cost.decode_time(self.engine.max_batch)
        self.clock += dt
        for c in rep.completed:
            req = self._by_rid[c.rid]
            c.finish = self.clock
            c.latency = self.clock - req.arrival + 2.0 * req.client_latency
            self.completions.append(c)

    def advance_to(self, t_end: float) -> None:
        """Run the engine until the clock reaches ``t_end`` (idle gaps
        jump the clock; work in progress may overshoot — time is charged
        when a step completes, never sliced)."""
        while self.clock < t_end:
            self._apply_due()
            if self.engine.has_work:
                self._step_once()
            else:
                nxt = self._next_event()
                if nxt is None or nxt > t_end:
                    self.clock = t_end
                else:
                    self.clock = max(self.clock, nxt)
        self._apply_due()

    def drain(self) -> None:
        """Run until every submitted-or-future request is answered."""
        while not self.done:
            self._apply_due()
            if self.engine.has_work:
                self._step_once()
            else:
                nxt = self._next_event()
                if nxt is None:
                    raise RuntimeError("no work left but requests missing")
                self.clock = max(self.clock, nxt)

    def stats(self) -> ServeStats:
        # makespan is the LAST COMPLETION's clock, not the session clock:
        # advance_to() may have idled the clock past the serving work
        makespan = max((c.finish for c in self.completions),
                       default=self.clock)
        return self.engine._stats(self.completions, makespan=makespan)
