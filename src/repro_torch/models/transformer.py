"""Dense decoder LM: parameters, the training forward and the serving
engine's step functions.

The PyTorch counterpart of ``repro.models.transformer`` for the dense
family. The parameter tree has the JAX package's names and layouts —
``{embed, blocks, final_norm[, lm_head]}`` with the blocks stacked on a
leading ``L`` axis — held in a ``ParamTree`` module; the JAX ``scan``
over layers is a Python loop. KV caches are ``{"layers": {"k", "v"}}``
with a leading ``L`` axis, updated in place and returned.

  decode cache      (L, B, T, K, hd) + kpos (L, T)   single-shot path
  dense slot cache  (L, B, T, K, hd)          one linear row per slot
  paged pool        (L, n_pages, ps, K, hd)   rows read through page maps
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamTree, apply_norm, as_dtype,
                                       dtype_of, embed, layer, mlp, unembed)

Params = Dict[str, Any]


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} is not ported; the "
            f"port runs the dense family (ROADMAP C7: MoE/VLM/audio/SSM)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _norm(cfg: ArchConfig, dtype, lead=()) -> Params:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype)}
    if cfg.attn_bias:                                    # layernorm
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype)
    return p


def _init_mlp(gen: torch.Generator, d: int, ff: int, act: str, bias: bool,
              dtype, lead=()) -> Params:
    def normal(*shape):
        return torch.randn(lead + shape, generator=gen)

    if act in ("silu", "gelu_glu"):
        return {"w_gate": (normal(d, ff) * d ** -0.5).to(dtype),
                "w_up": (normal(d, ff) * d ** -0.5).to(dtype),
                "w_down": (normal(ff, d) * ff ** -0.5).to(dtype)}
    p = {"w_up": (normal(d, ff) * d ** -0.5).to(dtype),
         "w_down": (normal(ff, d) * ff ** -0.5).to(dtype)}
    if bias:
        p["b_up"] = torch.zeros(lead + (ff,), dtype=dtype)
        p["b_down"] = torch.zeros(lead + (d,), dtype=dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = "cuda") -> ParamTree:
    """Random weights from ``torch.Generator().manual_seed(seed)``, drawn
    on the CPU (the same numbers whatever the device) and moved to
    ``device``. Same tree and scales as the JAX ``init_params``; the
    numbers differ (tests carry JAX weights across with
    ``checkpoint.convert.params_from_jax``)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    dtype = dtype_of(cfg.param_dtype)
    L = (cfg.n_layers,)
    tree: Params = {
        "embed": (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen)
                  * 0.02).to(dtype),
        "final_norm": _norm(cfg, dtype)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (torch.randn(cfg.vocab_size, cfg.d_model,
                                       generator=gen) * 0.02).to(dtype)
    tree["blocks"] = {
        "ln1": _norm(cfg, dtype, L),
        "attn": attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, bias=cfg.attn_bias, dtype=dtype, lead=L),
        "ln2": _norm(cfg, dtype, L),
        "mlp": _init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                         cfg.attn_bias, dtype, L)}
    return ParamTree(tree).to(dev)


def param_shapes(cfg: ArchConfig) -> Params:
    """The parameter tree's leaf shapes (nested dict of tuples) — what
    ``init_params`` makes and ``params_from_jax`` checks against."""
    _check_dense(cfg)
    L = cfg.n_layers
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    norm = {"scale": (d,), **({"bias": (d,)} if cfg.attn_bias else {})}
    attn = {"wq": (L, d, H, hd), "wk": (L, d, K, hd), "wv": (L, d, K, hd),
            "wo": (L, H, hd, d)}
    if cfg.attn_bias:
        attn.update(bq=(L, H, hd), bk=(L, K, hd), bv=(L, K, hd), bo=(L, d))
    if cfg.qk_norm:
        attn.update(q_norm={"scale": (L, hd)}, k_norm={"scale": (L, hd)})
    if cfg.mlp_act in ("silu", "gelu_glu"):
        mlp_p = {"w_gate": (L, d, ff), "w_up": (L, d, ff),
                 "w_down": (L, ff, d)}
    else:
        mlp_p = {"w_up": (L, d, ff), "w_down": (L, ff, d),
                 **({"b_up": (L, ff), "b_down": (L, d)}
                    if cfg.attn_bias else {})}
    lnorm = {k: (L,) + v for k, v in norm.items()}
    tree = {"embed": (cfg.vocab_size, d), "final_norm": norm,
            "blocks": {"ln1": lnorm, "attn": attn, "ln2": dict(lnorm),
                       "mlp": mlp_p}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.vocab_size, d)
    return tree


# ---------------------------------------------------------------------------
# Shared pieces of every step
# ---------------------------------------------------------------------------
def _embed_in(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return as_dtype(embed(params["embed"], tokens),
                    dtype_of(cfg.activ_dtype))


def _ffn(bp: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    hh = apply_norm(bp["ln2"], h, cfg.norm_eps)
    return h + mlp(bp["mlp"], hh, cfg.mlp_act)


def _head(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(head, x)


# ---------------------------------------------------------------------------
# Full forward (training path)
# ---------------------------------------------------------------------------
def _attn_block(bp: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    h = apply_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(
        bp["attn"], h, positions, causal=True, window=cfg.sliding_window,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
    return _ffn(bp, x, cfg)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V) f32, aux loss 0), the dense family
    only. Layer ``i`` reads the ``[i]`` views of the blocks' stacked
    leaves, so autograd writes each gradient into the stacked leaf the
    flat buffer holds. ``remat=True`` recomputes each block's activations
    in the backward pass (``torch.utils.checkpoint``), as the JAX
    forward's ``jax.checkpoint`` does."""
    _check_dense(cfg)
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _attn_block, bp, x, positions, cfg, use_reentrant=False)
        else:
            x = _attn_block(bp, x, positions, cfg)
    return _head(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def _take_cols(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Row b's column ``n_b - 1`` of x (B,S,d), clamped into ``[0, S-1]``
    as ``jnp.take_along_axis`` after ``jnp.clip``: (B,1,d)."""
    idx = (n.long() - 1).clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


# ---------------------------------------------------------------------------
# Single-shot path: prefill + lockstep decode over a kpos-tagged cache
# ---------------------------------------------------------------------------
def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device: DeviceLike = "cuda") -> Params:
    """``{"layers": {"k", "v", "kpos"}}`` with a leading ``L`` axis; a
    sliding-window arch gets a ring of ``min(window, cache_len)`` slots.
    ``kpos`` starts at ``-1`` (empty)."""
    _check_dense(cfg)
    eff = min(cfg.sliding_window, cache_len) if cfg.sliding_window \
        else cache_len
    one = attn_mod.init_cache(batch, eff, cfg.n_kv_heads, cfg.head_dim,
                              dtype_of(cfg.activ_dtype), device)
    return {"layers": {n: t.expand(cfg.n_layers, *t.shape).contiguous()
                       for n, t in one.items()}}


def _layer_cache(cache: Params, i: int) -> Params:
    return {n: cache["layers"][n][i] for n in ("k", "v", "kpos")}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Forward over the prompt (B,S), building a decode cache of
    ``cache_len`` slots (default ``S + 64``) on the tokens' device.
    Returns (last-token logits (B,1,V), cache). ``lengths`` (B,) makes the
    batch ragged: row b's prompt is ``tokens[b, :lengths_b]`` and its
    logits are column ``lengths_b - 1`` — causal masking keeps the padded
    tail out of every valid position."""
    _check_dense(cfg)
    B, S = tokens.shape
    w = cfg.sliding_window
    if cache_len is None:
        cache_len = S + 64
    if w and S > min(w, cache_len):
        raise ValueError("sliding-window prefill longer than the window is "
                         "unsupported (decode-only shape); prefill chunking "
                         "is a serving-layer feature")
    cache = init_decode_cache(cfg, B, cache_len, device=tokens.device)
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_prefill(
            bp["attn"], hh, positions, cache=_layer_cache(cache, i),
            window=w, use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
        x = _ffn(bp, x + a, cfg)
    x = x[:, -1:, :] if lengths is None else _take_cols(x, lengths)
    return _head(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cache: Params
                ) -> Tuple[torch.Tensor, Params]:
    """ONE-token lockstep decode: token (B,1), ``pos`` the one absolute
    position of every row (an int or 0-d tensor). Writes the cache in
    place. Returns (logits (B,1,V), cache)."""
    _check_dense(cfg)
    x = _embed_in(params, cfg, token)
    pos = torch.as_tensor(pos, device=x.device)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_decode(
            bp["attn"], hh, pos, cache=_layer_cache(cache, i),
            window=cfg.sliding_window, use_rope=cfg.use_rope,
            rope_theta=cfg.rope_theta)
        x = _ffn(bp, x + a, cfg)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Dense slot cache
# ---------------------------------------------------------------------------
def decode_step_ragged(params, cfg: ArchConfig, token: torch.Tensor,
                       pos: torch.Tensor, cache: Params, live: torch.Tensor,
                       flash: bool = False) -> Tuple[torch.Tensor, Params]:
    """ONE-token decode with per-row positions and a live-slot mask over
    the dense slot cache ``{"layers": {"k","v"}}`` of ``(L, B, T, ..)``.
    token: (B,1); pos: (B,); live: (B,) bool. ``flash=True`` runs the
    attention contraction in the flash-decode kernel (same cache writes).
    Returns (logits (B,1,V), cache)."""
    _check_dense(cfg)
    attn_fn = attn_mod.attention_decode_ragged_flash if flash \
        else attn_mod.attention_decode_ragged
    plan = attn_mod.dense_decode_plan(
        pos, live, cache["layers"]["k"].shape[2], cfg.head_dim,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
    x = _embed_in(params, cfg, token)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        cl = {n: cache["layers"][n][i] for n in ("k", "v")}
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_fn(bp["attn"], hh, pos, cache=cl, live=live,
                       use_rope=cfg.use_rope, plan=plan)
        x = _ffn(bp, x + a, cfg)
    return _head(params, cfg, x), cache


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor,
                  off: torch.Tensor, clen: torch.Tensor, cache: Params,
                  all_logits: bool = False) -> Tuple[torch.Tensor, Params]:
    """One chunk of a chunked ragged prefill into the dense slot cache.
    tokens: (B,C) — row b's valid tokens are ``tokens[b, :clen_b]`` at
    absolute positions ``[off_b, off_b + clen_b)``. Returns (logits at
    each row's last VALID column (B,1,V), cache). ``all_logits=True``
    returns the WHOLE chunk's logits (B,C,V) instead — the speculative
    verify shape, whose column ``clen-1`` equals the default path's bit
    for bit."""
    _check_dense(cfg)
    x = _embed_in(params, cfg, tokens)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        cl = {n: cache["layers"][n][i] for n in ("k", "v")}
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_prefill_chunk(
            bp["attn"], hh, off, clen, cache=cl, use_rope=cfg.use_rope,
            rope_theta=cfg.rope_theta)
        x = _ffn(bp, x + a, cfg)
    if all_logits:
        # one head call per column: a matrix product's rounding may depend
        # on its row count, and column clen-1 must equal the default
        # path's (B,1) call bit for bit
        return torch.cat([_head(params, cfg, x[:, c:c + 1])
                          for c in range(x.shape[1])], dim=1), cache
    return _head(params, cfg, _take_cols(x, clen)), cache


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------
def gather_kv_pages(buf: torch.Tensor, page_map: torch.Tensor
                    ) -> torch.Tensor:
    """Per-row LINEAR views ``(L, B, P*ps, K, hd)`` gathered from the pool
    ``(L, n_pages, ps, K, hd)`` through ``page_map`` (B, P); entries
    ``>= n_pages`` are clamped onto the last page (junk, masked later)."""
    ps = buf.shape[2]
    B, P = page_map.shape
    g = buf[:, page_map.long().clamp(0, buf.shape[1] - 1)]
    return g.reshape(buf.shape[0], B, P * ps, *buf.shape[3:])


def scatter_kv_pages(buf: torch.Tensor, page_map: torch.Tensor,
                     view: torch.Tensor) -> torch.Tensor:
    """Scatter linear views back into the pool (in place). Entries of
    ``page_map`` at or beyond ``n_pages`` do not write — the padding
    rows, unused tail pages and FROZEN shared pages the engine maps out
    of bounds (JAX drops those scatter writes)."""
    ps = buf.shape[2]
    B, P = page_map.shape
    upd = view.reshape(view.shape[0], B, P, ps, *view.shape[3:])
    pm = page_map.long()
    bi, ji = torch.nonzero(pm < buf.shape[1], as_tuple=True)
    buf[:, pm[bi, ji]] = as_dtype(upd[:, bi, ji], buf.dtype)
    return buf


def prefill_chunk_paged(params, cfg: ArchConfig, tokens: torch.Tensor,
                        off: torch.Tensor, clen: torch.Tensor, pool: Params,
                        rmap: torch.Tensor, wmap: torch.Tensor,
                        all_logits: bool = False
                        ) -> Tuple[torch.Tensor, Params]:
    """``prefill_chunk`` through a page table: gather each row's pages
    (``rmap``), run the same chunk math, scatter back through ``wmap``."""
    view = {"layers": {n: gather_kv_pages(pool["layers"][n], rmap)
                       for n in ("k", "v")}}
    logits, view = prefill_chunk(params, cfg, tokens, off, clen, view,
                                 all_logits=all_logits)
    for n in ("k", "v"):
        scatter_kv_pages(pool["layers"][n], wmap, view["layers"][n])
    return logits, pool


def decode_step_ragged_paged(params, cfg: ArchConfig, token: torch.Tensor,
                             pos: torch.Tensor, pool: Params,
                             live: torch.Tensor, rmap: torch.Tensor,
                             wmap: torch.Tensor
                             ) -> Tuple[torch.Tensor, Params]:
    """``decode_step_ragged`` through a page table (gather, plain decode,
    scatter back) — the plain path the kernel path is compared with."""
    view = {"layers": {n: gather_kv_pages(pool["layers"][n], rmap)
                       for n in ("k", "v")}}
    logits, view = decode_step_ragged(params, cfg, token, pos, view, live)
    for n in ("k", "v"):
        scatter_kv_pages(pool["layers"][n], wmap, view["layers"][n])
    return logits, pool


def decode_step_ragged_paged_flash(params, cfg: ArchConfig,
                                   token: torch.Tensor, pos: torch.Tensor,
                                   pool: Params, live: torch.Tensor,
                                   rmap: torch.Tensor, wmap: torch.Tensor
                                   ) -> Tuple[torch.Tensor, Params]:
    """Ragged one-token decode reading the page pool directly through the
    flash-decode kernel: no gather/scatter round trip. Each layer's
    attention reads ``rmap`` inside the kernel and the new token's KV
    lands on one (page, offset) cell through ``wmap``."""
    _check_dense(cfg)
    kb = pool["layers"]["k"]
    plan = attn_mod.paged_decode_plan(
        pos, live, rmap, wmap, kb.shape[2], kb.shape[1], cfg.head_dim,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
    x = _embed_in(params, cfg, token)
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_decode_ragged_paged_flash(
            bp["attn"], hh, pos, kbuf=kb[i], vbuf=pool["layers"]["v"][i],
            live=live, rmap=rmap, wmap=wmap, use_rope=cfg.use_rope,
            plan=plan)
        x = _ffn(bp, x + a, cfg)
    return _head(params, cfg, x), pool
