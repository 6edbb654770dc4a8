"""Attention: GQA with RoPE over full sequences (training) and over the
serving engine's KV caches.

The PyTorch counterpart of ``repro.models.attention`` (full-sequence
self- and cross-attention, the single-shot prefill / lockstep decode
over a ``kpos``-tagged cache, the audio decoder's cross K/V, and the
functions the continuous-batching engine runs).
Layouts are the JAX package's:

  q projections    (d, H, hd)        H = query heads
  k/v projections  (d, K, hd)        K = kv heads (GQA groups G = H/K)
  out projection   (H, hd, d)
  activations      (B, S, H, hd)

KV caches store post-RoPE keys. Where the JAX functions return a new
cache, these update the cache tensors they are given IN PLACE (and
return them), which saves a copy of the cache per layer and step.

JAX drops out-of-bounds scatter writes and clamps out-of-bounds gathers;
PyTorch raises on both. Every site where the JAX code relies on a dropped
write (dead rows at batch index ``B``, padded chunk columns at ``T``,
write-map pages ``>= n_pages``) masks those entries out explicitly here,
and every clamp is kept, so the cache bytes come out equal.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.flash_attention import train as fa_train
from repro_torch.kernels.gemm_3xtf32 import linear
from repro_torch.kernels.runtime import (DeviceLike, launch_counter,
                                         resolve_device)
from repro_torch.models.layers import (Init, apply_rope, as_dtype, f32,
                                       rmsnorm, rope_tables, rotate)

Params = Dict[str, Any]
NEG_INF = -1e30
# training attention calls by the route they took (``attention``)
FUSED_CALLS = launch_counter("attention.fused_calls")
PLAIN_CALLS = launch_counter("attention.plain_calls")


# ---------------------------------------------------------------------------
def init_attention(init: Init, path: str, d: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qk_norm: bool = False,
                   bias: bool = False, dtype=torch.float32,
                   lead: Tuple[int, ...] = ()) -> Params:
    """Random attention weights (``lead`` prepends stacking axes)."""
    s = d ** -0.5
    p: Params = {
        "wq": init.normal(f"{path}/wq", lead + (d, n_heads, head_dim), s,
                          dtype),
        "wk": init.normal(f"{path}/wk", lead + (d, n_kv_heads, head_dim), s,
                          dtype),
        "wv": init.normal(f"{path}/wv", lead + (d, n_kv_heads, head_dim), s,
                          dtype),
        "wo": init.normal(f"{path}/wo", lead + (n_heads, head_dim, d),
                          (n_heads * head_dim) ** -0.5, dtype),
    }
    if bias:
        p["bq"] = init.full(lead + (n_heads, head_dim), 0.0, dtype)
        p["bk"] = init.full(lead + (n_kv_heads, head_dim), 0.0, dtype)
        p["bv"] = init.full(lead + (n_kv_heads, head_dim), 0.0, dtype)
        p["bo"] = init.full(lead + (d,), 0.0, dtype)
    if qk_norm:
        p["q_norm"] = {"scale": init.full(lead + (head_dim,), 1.0, dtype)}
        p["k_norm"] = {"scale": init.full(lead + (head_dim,), 1.0, dtype)}
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    B, S, d = x.shape
    return linear(x.reshape(B * S, d), w.reshape(d, -1)).view(
        B, S, *w.shape[1:])


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor):
    q = _proj(xq, p["wq"])
    k = _proj(xkv, p["wk"])
    v = _proj(xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _local_kv(p: Params) -> Params:
    """A split attention's weights with replicated KV heads narrowed to
    the heads its local query heads read (``tp.local_kv_heads``): a
    slice of consecutive heads each read by a group of local heads, or
    one KV head per local query head."""
    heads, grouped = tp.local_kv_heads(p["wq"].shape[-2], p["wk"].shape[-2])
    out = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name not in p:
            continue
        w = p[name]
        out[name] = w.narrow(-2, heads[0], len(heads)) if grouped else \
            w.index_select(w.dim() - 2, torch.tensor(heads,
                                                     device=w.device))
    return out


def _out_proj(p: Params, o: torch.Tensor, split: bool = False
              ) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` as one matrix product;
    ``split``: the local heads' partial, summed over ``model`` before
    the bias."""
    B, S, H, hd = o.shape
    wo = p["wo"]
    out = linear(o.reshape(B * S, H * hd), wo.reshape(H * hd, -1)).view(
        B, S, -1)
    if split:
        out = tp.reduce_from_model(out)
    if "bo" in p:
        out = out + p["bo"]
    return out


def grouped_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,K,hd), mask broadcastable to (B,1,1,S,T).

    Returns (B,S,H,hd). GQA via a group axis — no kv repetition. The
    softmax is written out (einsum + ``-1e30`` mask) to keep the JAX
    masking exactly; a masked-out row attends uniformly, as in JAX."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", f32(qg),
                          f32(k)) * (hd ** -0.5)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", as_dtype(w, v.dtype), v)
    return o.reshape(B, S, H, hd)


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
              window: int = 0) -> torch.Tensor:
    """(B?,S),(B?,T) -> bool (.., 1, 1, S, T) for ``grouped_attend``."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m[..., None, None, :, :]


# ---------------------------------------------------------------------------
# Full-sequence (training) attention
# ---------------------------------------------------------------------------
def attention(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, window: int = 0, use_rope: bool = True,
              rope_theta: float = 10000.0,
              xkv: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              split: bool = False, kv_split: bool = False,
              by_index: bool = False) -> torch.Tensor:
    """Attention over the whole sequence x (B,S,d) at ``positions`` (S,)
    — causal and/or sliding-window — on plain tensor ops, as the JAX
    training forward (autograd differentiates it). Self-attention, or
    cross-attention over ``xkv`` (B,T,d) at ``kv_positions`` (T,) (the
    audio decoder over the encoder's states).

    ``split`` (``distributed/tensor_parallel.py``): the query heads of
    ``wq`` / ``bq`` / ``wo`` are this rank's; so are the KV heads where
    ``kv_split``, else they are replicated and narrowed to those the
    local query heads read. The inputs go through ``copy_to_model`` and
    the output projection's partial through ``reduce_from_model``.

    ``by_index``: the caller states that ``positions`` is the sequence's
    own index ``0..S-1``, so the masks are the kernels' masks by index. The
    softmax runs in ``grouped_attend``, or, where ``fa_train.route`` says
    "fused" (CUDA, float32, a built head width, self-attention
    ``by_index``), in ``fa_train.attention_train``'s kernels;
    ``FUSED_CALLS`` / ``PLAIN_CALLS`` count the calls of each."""
    cross = xkv is not None
    kv_positions = positions if kv_positions is None else kv_positions
    if split:
        if xkv is not None:
            xkv = tp.copy_to_model(xkv)
        x = tp.copy_to_model(x)
        if not kv_split:
            p = _local_kv(p)
    xkv = x if xkv is None else xkv
    q, k, v = _project_qkv(p, x, xkv)
    if use_rope:
        cos, sin = rope_tables(positions, q.shape[-1], rope_theta)
        q = rotate(q, cos, sin)
        if kv_positions is not positions:
            cos, sin = rope_tables(kv_positions, q.shape[-1], rope_theta)
        k = rotate(k, cos, sin)
    if fa_train.route(q.device.type, q.dtype, q.shape[-1], cross,
                      by_index and kv_positions is positions) == "fused":
        FUSED_CALLS.count += 1
        o = fa_train.attention_train(q, k, v, causal=causal, window=window)
    else:
        PLAIN_CALLS.count += 1
        mask = make_mask(positions, kv_positions, causal, window) \
            if (causal or window) else None
        o = grouped_attend(q, k, v, mask)
    return _out_proj(p, o, split)


# ---------------------------------------------------------------------------
# Single-shot KV-cache path (prefill + lockstep decode)
# ---------------------------------------------------------------------------
def init_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device: DeviceLike = "cuda") -> Params:
    """One layer's decode cache on ``device`` (default ``"cuda"``; raises
    without CUDA unless given ``"cpu"``): k/v ``(B, T, K, hd)`` and
    ``kpos`` (T,), the absolute position each slot holds (``-1``: empty)."""
    dev = resolve_device(device)
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=dev),
        "kpos": torch.full((cache_len,), -1, dtype=torch.int32, device=dev),
    }


def attention_prefill(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                      cache: Params, window: int = 0, use_rope: bool = True,
                      rope_theta: float = 10000.0
                      ) -> Tuple[torch.Tensor, Params]:
    """Full causal forward over x (B,S,d) writing post-RoPE k/v into the
    cache's first S slots (in place). ``positions`` (S,) or (B,S) start
    at 0; S must not exceed the cache length."""
    q, k, v = _project_qkv(p, x, x)
    if use_rope:
        cos, sin = rope_tables(positions, q.shape[-1], rope_theta)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
    o = grouped_attend(q, k, v, make_mask(positions, positions, True, window))
    S, T = x.shape[1], cache["k"].shape[1]
    if S > T:
        raise ValueError(f"prefill of {S} tokens into a cache of {T} slots")
    pos1d = positions[0] if positions.dim() > 1 else positions
    cache["k"][:, :S] = as_dtype(k, cache["k"].dtype)
    cache["v"][:, :S] = as_dtype(v, cache["v"].dtype)
    cache["kpos"][:S] = pos1d.to(torch.int32)
    return _out_proj(p, o), cache


def attention_decode(p: Params, x: torch.Tensor, pos: torch.Tensor, *,
                     cache: Params, window: int = 0, use_rope: bool = True,
                     rope_theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token decode of every row at ONE position. x: (B,1,d); pos: 0-d
    int tensor. With ``window > 0`` the cache is a ring (slot
    ``pos % T``), else slot ``pos``; the slot is clamped into
    ``[0, T-1]`` as ``jax.lax.dynamic_update_slice`` clamps its start.
    Writes k/v and ``kpos`` in place, then attends every slot holding a
    position in ``(pos - window, pos]``."""
    B, T = x.shape[0], cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, x)
    pos = pos.to(torch.int64).reshape(())
    if use_rope:
        cos, sin = rope_tables(pos.expand(B, 1), q.shape[-1], rope_theta)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
    slot = (pos % T if window > 0 else pos).clamp(0, T - 1).reshape(1)
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    ck.index_copy_(1, slot, as_dtype(k, ck.dtype))
    cv.index_copy_(1, slot, as_dtype(v, cv.dtype))
    kpos.index_copy_(0, slot, pos.to(torch.int32).reshape(1))
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    o = grouped_attend(q, ck, cv, valid[None, None, None, None, :])
    return _out_proj(p, o), cache


# ---------------------------------------------------------------------------
# Serving-engine KV-cache paths
# ---------------------------------------------------------------------------
class DecodePlan(NamedTuple):
    """What one ragged decode step's attention needs besides the layer's
    weights and cache — the same for every layer, so a model step builds
    it once (``dense_decode_plan`` / ``paged_decode_plan``) instead of
    once per layer."""
    cos: torch.Tensor       # (B,1,1,hd/2) RoPE tables at each row's pos
    sin: torch.Tensor
    rows: torch.Tensor      # rows that write their new k/v
    wrow: torch.Tensor      # where they write: dense row / pool page
    wcol: torch.Tensor      # ... and column / offset in the page
    qpos: torch.Tensor      # (B,) int32 last key to attend (0 when dead)
    live: torch.Tensor      # (B,) int32
    pmap: torch.Tensor      # (B,P) int32 page map the kernel reads
                            # (the identity map over a dense cache)


def _rope_and_pos(pos: torch.Tensor, live: torch.Tensor, head_dim: int,
                  rope_theta: float, use_rope: bool):
    posb = pos.long()
    cos = sin = posb.new_zeros(())
    if use_rope:
        cos, sin = rope_tables(posb[:, None], head_dim, rope_theta)
    qpos = torch.where(live, posb, 0).to(torch.int32)
    return posb, cos, sin, qpos


def dense_decode_plan(pos: torch.Tensor, live: torch.Tensor, T: int,
                      head_dim: int, *, use_rope: bool = True,
                      rope_theta: float = 10000.0) -> DecodePlan:
    """Plan over the linear slot cache (B, T, ..): live rows write column
    ``clamp(pos, 0, T-1)`` (JAX sends dead rows to batch index B, where
    the write drops); the flash path reads the cache as ``T // ps`` pages
    through an identity map."""
    posb, cos, sin, qpos = _rope_and_pos(pos, live, head_dim, rope_theta,
                                         use_rope)
    rows = torch.nonzero(live, as_tuple=True)[0]
    B = pos.shape[0]
    nb = T // _pow2_kv_block(T)
    idmap = torch.arange(B * nb, dtype=torch.int32,
                         device=pos.device).reshape(B, nb)
    return DecodePlan(cos, sin, rows, rows, posb.clamp(0, T - 1)[rows],
                      qpos, live.to(torch.int32), idmap)


def paged_decode_plan(pos: torch.Tensor, live: torch.Tensor,
                      rmap: torch.Tensor, wmap: torch.Tensor,
                      page_size: int, n_pages: int, head_dim: int, *,
                      use_rope: bool = True,
                      rope_theta: float = 10000.0) -> DecodePlan:
    """Plan over the paged pool: row b writes (page, offset) =
    ``(wmap[b, pos_b // ps], pos_b % ps)``, with the page index clamped
    to the map, and only where that page is real (< n_pages) — JAX drops
    the write for frozen/shared pages and other rows."""
    posb, cos, sin, qpos = _rope_and_pos(pos, live, head_dim, rope_theta,
                                         use_rope)
    pidx = (posb // page_size).clamp(0, rmap.shape[1] - 1)
    wpage = torch.gather(wmap.long(), 1, pidx[:, None])[:, 0]
    rows = torch.nonzero(wpage < n_pages, as_tuple=True)[0]
    return DecodePlan(cos, sin, rows, wpage[rows], (posb % page_size)[rows],
                      qpos, live.to(torch.int32), rmap.to(torch.int32))


def _decode_qkv(p: Params, x: torch.Tensor, plan: DecodePlan,
                use_rope: bool):
    q, k, v = _project_qkv(p, x, x)
    if use_rope:
        q = rotate(q, plan.cos, plan.sin)
        k = rotate(k, plan.cos, plan.sin)
    return q, k, v


def _write(ck: torch.Tensor, cv: torch.Tensor, plan: DecodePlan,
           k: torch.Tensor, v: torch.Tensor) -> None:
    """The plan's rows write their new token's k/v (in place)."""
    ck[plan.wrow, plan.wcol] = as_dtype(k[plan.rows, 0], ck.dtype)
    cv[plan.wrow, plan.wcol] = as_dtype(v[plan.rows, 0], cv.dtype)


def attention_decode_ragged(p: Params, x: torch.Tensor, pos: torch.Tensor, *,
                            cache: Params, live: torch.Tensor,
                            use_rope: bool = True,
                            rope_theta: float = 10000.0,
                            plan: Optional[DecodePlan] = None
                            ) -> Tuple[torch.Tensor, Params]:
    """One-token decode with PER-ROW positions over the engine's linear
    slot cache. x: (B,1,d); pos: (B,) absolute position of each row's
    current token; live: (B,) bool. Row b's cache is valid on
    ``[0, pos_b]`` after this call's write; dead rows do not write and
    attend only slot 0 (finite, discarded). ``plan`` (from
    ``dense_decode_plan``) may be shared by all layers of a step."""
    T = cache["k"].shape[1]
    if plan is None:
        plan = dense_decode_plan(pos, live, T, p["wq"].shape[-1],
                                 use_rope=use_rope, rope_theta=rope_theta)
    q, k, v = _decode_qkv(p, x, plan, use_rope)
    ck, cv = cache["k"], cache["v"]
    _write(ck, cv, plan, k, v)
    t = torch.arange(T, device=x.device)
    mask = (t[None, :] <= plan.qpos[:, None])[:, None, None, None, :]
    o = grouped_attend(q, ck, cv, mask)
    return _out_proj(p, o), {"k": ck, "v": cv}


def _pow2_kv_block(cache_len: int) -> int:
    """Page size for viewing a DENSE (B, T, ..) slot cache as kernel
    pages: the largest power of two dividing ``cache_len``, capped at
    128."""
    block = cache_len & (-cache_len)
    return min(block, 128)


def attention_decode_ragged_flash(p: Params, x: torch.Tensor,
                                  pos: torch.Tensor, *, cache: Params,
                                  live: torch.Tensor, use_rope: bool = True,
                                  rope_theta: float = 10000.0,
                                  plan: Optional[DecodePlan] = None
                                  ) -> Tuple[torch.Tensor, Params]:
    """``attention_decode_ragged`` with the attention contraction done by
    the flash-decode kernel, which views the dense ``(B, T, ..)`` rows
    as ``T // block`` pages under an identity page map. The cache write
    is the same as the plain path's."""
    from repro_torch.kernels.flash_decode import flash_decode
    B = x.shape[0]
    T = cache["k"].shape[1]
    if plan is None:
        plan = dense_decode_plan(pos, live, T, p["wq"].shape[-1],
                                 use_rope=use_rope, rope_theta=rope_theta)
    q, k, v = _decode_qkv(p, x, plan, use_rope)
    ck, cv = cache["k"], cache["v"]
    _write(ck, cv, plan, k, v)
    ps = _pow2_kv_block(T)
    kpool = ck.view(B * (T // ps), ps, *ck.shape[2:])  # views: the cache
    vpool = cv.view(B * (T // ps), ps, *cv.shape[2:])  # is contiguous
    o = flash_decode(q[:, 0], kpool, vpool, plan.pmap, plan.qpos, plan.live)
    return _out_proj(p, as_dtype(o, q.dtype)[:, None]), {"k": ck, "v": cv}


def attention_decode_ragged_paged_flash(p: Params, x: torch.Tensor,
                                        pos: torch.Tensor, *,
                                        kbuf: torch.Tensor,
                                        vbuf: torch.Tensor,
                                        live: torch.Tensor,
                                        rmap: torch.Tensor,
                                        wmap: torch.Tensor,
                                        use_rope: bool = True,
                                        rope_theta: float = 10000.0,
                                        plan: Optional[DecodePlan] = None
                                        ) -> Tuple[torch.Tensor,
                                                   Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """Ragged one-token decode directly over one layer's paged KV pool
    ``(n_pages, page_size, K, hd)``: the new token's k/v lands on one
    (page, offset) cell through ``wmap`` (entries ``>= n_pages`` drop the
    write: frozen, shared and dead rows), and the kernel reads each row's
    pages through ``rmap``. ``plan`` (from ``paged_decode_plan``) may be
    shared by all layers of a step. Returns ``(out (B,1,d), (kbuf,
    vbuf))``."""
    from repro_torch.kernels.flash_decode import flash_decode
    if plan is None:
        plan = paged_decode_plan(pos, live, rmap, wmap, kbuf.shape[1],
                                 kbuf.shape[0], p["wq"].shape[-1],
                                 use_rope=use_rope, rope_theta=rope_theta)
    q, k, v = _decode_qkv(p, x, plan, use_rope)
    _write(kbuf, vbuf, plan, k, v)
    o = flash_decode(q[:, 0], kbuf, vbuf, plan.pmap, plan.qpos, plan.live)
    return _out_proj(p, as_dtype(o, q.dtype)[:, None]), (kbuf, vbuf)


def attention_prefill_chunk(p: Params, x: torch.Tensor, off: torch.Tensor,
                            clen: torch.Tensor, *, cache: Params,
                            use_rope: bool = True,
                            rope_theta: float = 10000.0
                            ) -> Tuple[torch.Tensor, Params]:
    """One CHUNK of a chunked ragged prefill into the linear slot cache.
    x: (B,C,d); row b's chunk occupies absolute positions
    ``[off_b, off_b + clen_b)``; the rest of the chunk is padding, which
    does not write (JAX scatters it to column T and drops it). Query
    ``i`` attends ``t <= off_b + i``; padding queries attend ``t == 0``
    (finite, discarded)."""
    B, C, _ = x.shape
    T = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, x)
    i = torch.arange(C, device=x.device)
    qpos = off[:, None].long() + i[None, :]                  # (B,C) absolute
    if use_rope:
        q = apply_rope(q, qpos, rope_theta)
        k = apply_rope(k, qpos, rope_theta)
    valid_q = i[None, :] < clen[:, None].long()              # (B,C)
    # a valid column past T would also be dropped by JAX's scatter
    valid_w = valid_q & (qpos < T)
    bi, ci = torch.nonzero(valid_w, as_tuple=True)
    ck, cv = cache["k"], cache["v"]
    ck[bi, qpos[bi, ci]] = k[bi, ci].to(ck.dtype)
    cv[bi, qpos[bi, ci]] = v[bi, ci].to(cv.dtype)
    t = torch.arange(T, device=x.device)
    lim = torch.where(valid_q, qpos, torch.zeros_like(qpos))
    mask = (t[None, None, :] <= lim[..., None])[:, None, None, :, :]
    o = grouped_attend(q, ck, cv, mask)
    return _out_proj(p, o), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Cross-attention K/V (the audio decoder): made once per sequence
# ---------------------------------------------------------------------------
def cross_kv(p: Params, enc: torch.Tensor) -> Params:
    """The cross-attention's k/v (B,F,K,hd) over the encoder's states
    enc (B,F,d): what ``cross_attend`` reads at every decode step."""
    k, v = _proj(enc, p["wk"]), _proj(enc, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k, "v": v}


def cross_attend(p: Params, x: torch.Tensor, kv: Params) -> torch.Tensor:
    """x (B,S,d) attends, unmasked, to every encoder position of ``kv``
    (from ``cross_kv``)."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return _out_proj(p, grouped_attend(q, kv["k"], kv["v"], None))
