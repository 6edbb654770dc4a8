"""The models of every family (dense, MoE, SSM, hybrid, VLM, audio):
parameters, the training forward, the single-shot prefill/decode and
the serving engine's step functions.

The PyTorch counterpart of ``repro.models.transformer``. The parameter
tree has the JAX package's names and layouts, held in a ``ParamTree``
module; uniform stacks carry a leading ``L`` axis, and the JAX ``scan``
over layers is a Python loop:

  dense / moe / vlm  {embed, blocks, final_norm[, lm_head]}
  ssm                {embed, blocks, final_norm[, lm_head]}
  hybrid             {embed, super: {ssm (Ns, P-1, ..), attn (Ns, ..)},
                      tail (Nt, ..), final_norm[, lm_head]}
  audio              {embed, encoder (Le, ..), enc_final_norm,
                      blocks (decoder: ln1, self_attn, ln2, cross_attn,
                      ln3, mlp), final_norm[, lm_head]}

The VLM's patch embeddings (``prefix``) and the audio model's frame
embeddings (``frames``) come precomputed: the vision tower and the
mel / conv frontend are stubs, as in the JAX package.

Caches are updated in place and returned:

  decode cache      attention: {k, v (L, B, T, K, hd), kpos (L, T)}
                    ssm: {h (L, B, nh, hd, N) f32, conv (L, B, W-1, C)}
                    hybrid: {super: {ssm (Ns, P-1, ..), attn (Ns, ..)},
                             tail (Nt, ..)}
                    audio: {self: attention, cross: {k, v (L, B, F, K,
                            hd)}} (the encoder's K/V, made once)
  dense slot cache  (L, B, T, K, hd)          one linear row per slot
  paged pool        (L, n_pages, ps, K, hd)   rows read through page maps

The serving engine's steps need an attention cache: the ragged decode
steps take dense, MoE and VLM, the chunked prefill dense and MoE (the
JAX package's limits; its engine serves dense and MoE only).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Init, ParamTree, apply_norm, as_dtype,
                                       dtype_of, embed, layer, mlp, rmsnorm,
                                       unembed)

Params = Dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def _check_attention_cache(cfg: ArchConfig,
                           families=("dense", "vlm", "moe")) -> None:
    """The engine's steps keep one KV row per slot: the ragged decode
    steps take dense, VLM and MoE, the chunked prefill dense and MoE."""
    _check_family(cfg)
    if cfg.arch_type not in families:
        raise ValueError(f"{cfg.name}: the serving steps need an attention "
                         f"cache ({'/'.join(families)}), not "
                         f"{cfg.arch_type!r}")


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embedding of ``positions`` (...,) ->
    (..., d) float32: ``sin`` then ``cos`` of ``positions * freqs``,
    with ``freqs = exp(-arange(d/2) * log(10000) / max(d/2 - 1, 1))``,
    each step in float32 as the JAX package computes it."""
    half = d // 2
    dev = positions.device
    step = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=dev)) \
        / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                      * step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _norm(init: Init, cfg: ArchConfig, dtype, lead=()) -> Params:
    p = {"scale": init.full(lead + (cfg.d_model,), 1.0, dtype)}
    if cfg.attn_bias:                                    # layernorm
        p["bias"] = init.full(lead + (cfg.d_model,), 0.0, dtype)
    return p


def _init_mlp(init: Init, path: str, d: int, ff: int, act: str, bias: bool,
              dtype, lead=()) -> Params:
    def normal(name, shape, scale):
        return init.normal(f"{path}/{name}", lead + shape, scale, dtype)

    if act in ("silu", "gelu_glu"):
        return {"w_gate": normal("w_gate", (d, ff), d ** -0.5),
                "w_up": normal("w_up", (d, ff), d ** -0.5),
                "w_down": normal("w_down", (ff, d), ff ** -0.5)}
    p = {"w_up": normal("w_up", (d, ff), d ** -0.5),
         "w_down": normal("w_down", (ff, d), ff ** -0.5)}
    if bias:
        p["b_up"] = init.full(lead + (ff,), 0.0, dtype)
        p["b_down"] = init.full(lead + (d,), 0.0, dtype)
    return p


def _init_attn_half(init: Init, path: str, cfg: ArchConfig, dtype,
                    lead) -> Params:
    return {"ln1": _norm(init, cfg, dtype, lead),
            "attn": attn_mod.init_attention(
                init, f"{path}/attn", cfg.d_model, cfg.n_heads,
                cfg.n_kv_heads, cfg.head_dim, qk_norm=cfg.qk_norm,
                bias=cfg.attn_bias, dtype=dtype, lead=lead),
            "ln2": _norm(init, cfg, dtype, lead)}


def _init_attn_block(init: Init, path: str, cfg: ArchConfig, dtype,
                     lead) -> Params:
    return {**_init_attn_half(init, path, cfg, dtype, lead),
            "mlp": _init_mlp(init, f"{path}/mlp", cfg.d_model, cfg.d_ff,
                             cfg.mlp_act, cfg.attn_bias, dtype, lead)}


def _init_decoder_xblock(init: Init, path: str, cfg: ArchConfig, dtype,
                         lead) -> Params:
    """An encoder-decoder (whisper) decoder block: causal self-attention,
    cross-attention over the encoder's output, then the MLP."""
    def attn(name):
        return attn_mod.init_attention(
            init, f"{path}/{name}", cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, bias=cfg.attn_bias, dtype=dtype,
            lead=lead)
    return {"ln1": _norm(init, cfg, dtype, lead),
            "self_attn": attn("self_attn"),
            "ln2": _norm(init, cfg, dtype, lead),
            "cross_attn": attn("cross_attn"),
            "ln3": _norm(init, cfg, dtype, lead),
            "mlp": _init_mlp(init, f"{path}/mlp", cfg.d_model, cfg.d_ff,
                             cfg.mlp_act, cfg.attn_bias, dtype, lead)}


def _init_moe_block(init: Init, path: str, cfg: ArchConfig, dtype,
                    lead) -> Params:
    m = cfg.moe
    p = {**_init_attn_half(init, path, cfg, dtype, lead),
         "moe": moe_mod.init_moe(init, f"{path}/moe", cfg.d_model, m, dtype,
                                 lead)}
    if m.shared_expert:
        p["shared"] = _init_mlp(init, f"{path}/shared", cfg.d_model,
                                m.d_ff_expert, "silu", False, dtype, lead)
    if m.dense_residual:
        p["dense"] = _init_mlp(init, f"{path}/dense", cfg.d_model, cfg.d_ff,
                               "silu", False, dtype, lead)
    return p


def _init_ssm_block(init: Init, path: str, cfg: ArchConfig, dtype,
                    lead) -> Params:
    return {"ln": {"scale": init.full(lead + (cfg.d_model,), 1.0, dtype)},
            "ssm": ssm_mod.init_ssm(init, f"{path}/ssm", cfg.d_model,
                                    cfg.ssm, dtype, lead)}


def _hybrid_split(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(period, supers, tail layers) of a hybrid stack."""
    p = cfg.hybrid_attn_period
    return p, cfg.n_layers // p, cfg.n_layers % p


def _build(cfg: ArchConfig, init: Init) -> Params:
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    vd = (cfg.vocab_size, cfg.d_model)
    tree: Params = {"embed": init.normal("embed", vd, 0.02, dtype),
                    "final_norm": _norm(init, cfg, dtype)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = init.normal("lm_head", vd, 0.02, dtype)
    L = (cfg.n_layers,)
    if cfg.arch_type in ("dense", "vlm"):
        tree["blocks"] = _init_attn_block(init, "blocks", cfg, dtype, L)
    elif cfg.arch_type == "audio":
        tree["encoder"] = _init_attn_block(init, "encoder", cfg, dtype,
                                           (cfg.n_encoder_layers,))
        tree["enc_final_norm"] = _norm(init, cfg, dtype)
        tree["blocks"] = _init_decoder_xblock(init, "blocks", cfg, dtype, L)
    elif cfg.arch_type == "moe":
        tree["blocks"] = _init_moe_block(init, "blocks", cfg, dtype, L)
    elif cfg.arch_type == "ssm":
        tree["blocks"] = _init_ssm_block(init, "blocks", cfg, dtype, L)
    else:
        period, ns, nt = _hybrid_split(cfg)
        tree["super"] = {
            "ssm": _init_ssm_block(init, "super/ssm", cfg, dtype,
                                   (ns, period - 1)),
            "attn": _init_attn_block(init, "super/attn", cfg, dtype, (ns,))}
        if nt:
            tree["tail"] = _init_ssm_block(init, "tail", cfg, dtype, (nt,))
    return tree


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = "cuda") -> ParamTree:
    """Random weights on ``device``: each leaf drawn in chunks from
    generators keyed by ``seed`` and the leaf's path (``layers.Init``),
    so the same numbers whatever the device, a few chunks of host memory
    at a time, on every core. Same tree, scales and dtypes as the JAX
    ``init_params`` (the router, ``A_log``, ``D`` and ``dt_bias`` stay
    float32); the numbers differ (tests carry JAX weights across with
    ``checkpoint.convert.params_from_jax``)."""
    init = Init(seed, resolve_device(device))
    try:
        return ParamTree(_build(cfg, init))
    finally:
        init.close()


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype, nothing allocated."""
    return _build(cfg, Init(0, torch.device("meta")))


def param_shapes(cfg: ArchConfig) -> Params:
    """The parameter tree's leaf shapes (nested dict of tuples) — what
    ``init_params`` makes and ``params_from_jax`` checks against."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    return walk(abstract_params(cfg))


# ---------------------------------------------------------------------------
# Shared pieces of every step
# ---------------------------------------------------------------------------
def _embed_in(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings in the activation dtype; a VLM's are scaled
    by ``sqrt(d_model)`` rounded to that dtype (the Gemma convention)."""
    adt = dtype_of(cfg.activ_dtype)
    x = as_dtype(embed(params["embed"], tokens, tp.is_split(("embed",))),
                 adt)
    if cfg.arch_type == "vlm":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt, device=x.device)
    return x


def _with_prefix(x: torch.Tensor, prefix: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """A VLM's patch embeddings (B, Np, d) prepended to the text's."""
    if prefix is None:
        return x
    return torch.cat([as_dtype(torch.as_tensor(prefix, device=x.device),
                               x.dtype), x], dim=1)


def _heads(path: Tuple[str, ...]) -> Dict[str, bool]:
    """``attention``'s split flags for the attention at ``path`` in the
    parameter tree (both False outside a sharded step)."""
    return {"split": tp.is_split(path + ("wq",)),
            "kv_split": tp.is_split(path + ("wk",))}


def _ffn(bp: Params, h: torch.Tensor, cfg: ArchConfig,
         aux: Optional[List[torch.Tensor]] = None,
         path: Tuple[str, ...] = ("blocks",)) -> torch.Tensor:
    """The block's second half: norm, then the dense MLP or the MoE layer
    (with the shared expert / dense residual); the MoE's load-balance
    loss goes to ``aux`` when given. ``path``: the block's place in the
    parameter tree, where a sharded step looks up which of its products
    split over ``model``."""
    hh = apply_norm(bp["ln2"], h, cfg.norm_eps)

    def dense(name, act):
        return mlp(bp[name], hh, act, tp.is_split(path + (name, "w_up")))
    if "moe" not in bp:
        return h + dense("mlp", cfg.mlp_act)
    moe_fn = moe_mod.moe_ffn_sorted if cfg.moe.impl == "sort" \
        else moe_mod.moe_ffn
    y, a = moe_fn(bp["moe"], hh, cfg.moe,
                  tp.is_split(path + ("moe", "w_up")))
    if aux is not None:
        aux.append(a)
    if "shared" in bp:
        y = y + dense("shared", "silu")
    if "dense" in bp:
        y = y + dense("dense", "silu")
    return h + y


def _head(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits in f32 (a sharded step's: over this rank's vocab
    columns where the table splits)."""
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return unembed(params[name], x, tp.is_split((name,)))


# ---------------------------------------------------------------------------
# Full forward (training path)
# ---------------------------------------------------------------------------
def apply_attn_block(bp: Params, x: torch.Tensor, positions: torch.Tensor,
                     cfg: ArchConfig, *, causal: bool = True,
                     path: Tuple[str, ...] = ("blocks",)) -> torch.Tensor:
    h = apply_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(
        bp["attn"], h, positions, causal=causal, window=cfg.sliding_window,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
        **_heads(path + ("attn",)))
    return _ffn(bp, x, cfg, path=path)


def apply_moe_block(bp: Params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    h = apply_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(
        bp["attn"], h, positions, causal=True, window=cfg.sliding_window,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
        **_heads(("blocks", "attn")))
    aux: List[torch.Tensor] = []
    x = _ffn(bp, x, cfg, aux)
    return x, aux[0]


def apply_ssm_block(bp: Params, x: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(bp["ln"], x, cfg.norm_eps)
    return x + ssm_mod.ssm_forward(bp["ssm"], h, cfg.d_model, cfg.ssm)


def _apply_super(sp: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """A hybrid super-block: P-1 SSM blocks, then an attention block."""
    for j in range(cfg.hybrid_attn_period - 1):
        x = apply_ssm_block(layer(sp["ssm"], j), x, cfg)
    return apply_attn_block(sp["attn"], x, positions, cfg,
                            path=("super", "attn"))


def _frames_in(cfg: ArchConfig, frames: Optional[torch.Tensor],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's input: the frame embeddings (B, F, d) in the
    activation dtype plus the sinusoidal embedding of 0..F-1; and those
    frame positions."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family needs frame "
                         f"embeddings (frames=)")
    adt = dtype_of(cfg.activ_dtype)
    frames = torch.as_tensor(frames, device=device)
    fpos = torch.arange(frames.shape[1], dtype=torch.int32, device=device)
    return (as_dtype(frames, adt)
            + as_dtype(sinusoidal_pos(fpos, cfg.d_model), adt)), fpos


def _direct(fn, *args):
    return fn(*args)


def _encode(params, cfg: ArchConfig, frames: Optional[torch.Tensor],
            device: torch.device, run=_direct) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The audio encoder: frames plus positions through the non-causal
    encoder stack (each block called through ``run``), then
    ``enc_final_norm``. Returns (encoder states (B, F, d), frame
    positions (F,))."""
    enc, fpos = _frames_in(cfg, frames, device)
    for i in range(cfg.n_encoder_layers):
        enc = run(_encoder_block, layer(params["encoder"], i), enc, fpos,
                  cfg)
    return apply_norm(params["enc_final_norm"], enc, cfg.norm_eps), fpos


def _encoder_block(bp: Params, x: torch.Tensor, fpos: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    return apply_attn_block(bp, x, fpos, cfg, causal=False,
                            path=("encoder",))


def _cross_mlp(bp: Params, h: torch.Tensor, cfg: ArchConfig, attend
               ) -> torch.Tensor:
    """A decoder block's second and third parts: ``ln2``, the
    cross-attention ``attend(p, x)``, ``ln3`` and the MLP."""
    h = h + attend(bp["cross_attn"], apply_norm(bp["ln2"], h, cfg.norm_eps))
    hh = apply_norm(bp["ln3"], h, cfg.norm_eps)
    return h + mlp(bp["mlp"], hh, cfg.mlp_act,
                   tp.is_split(("blocks", "mlp", "w_up")))


def _decoder_block(bp: Params, h: torch.Tensor, positions: torch.Tensor,
                   enc: torch.Tensor, fpos: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """A whole-sequence decoder block: causal self-attention without
    RoPE, cross-attention over ``enc``, MLP."""
    hh = apply_norm(bp["ln1"], h, cfg.norm_eps)
    h = h + attn_mod.attention(bp["self_attn"], hh, positions, causal=True,
                               use_rope=False,
                               **_heads(("blocks", "self_attn")))
    return _cross_mlp(bp, h, cfg, lambda p, x: attn_mod.attention(
        p, x, positions, causal=False, use_rope=False, xkv=enc,
        kv_positions=fpos, **_heads(("blocks", "cross_attn"))))


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V) f32, aux loss: the MoE blocks'
    load-balance losses summed, else 0). Layer ``i`` reads the ``[i]``
    views of the stacked leaves, so autograd writes each gradient into
    the stacked leaf the flat buffer holds. ``remat=True`` recomputes
    each block's (a hybrid's: each super-block's) activations in the
    backward pass (``torch.utils.checkpoint``), as the JAX forward's
    ``jax.checkpoint`` does.

    A VLM needs ``prefix`` (B, Np, d), the patch embeddings put before
    the scaled token embeddings; its logits are the text columns' only.
    The audio family needs ``frames`` (B, F, d): the encoder runs over
    them, the decoder attends causally to the tokens and fully to the
    encoder's output."""
    _check_family(cfg)
    x = _embed_in(params, cfg, tokens)
    if cfg.arch_type == "vlm":
        if prefix is None:
            raise ValueError(f"{cfg.name}: the VLM family needs patch "
                             f"embeddings (prefix=)")
        x = _with_prefix(x, prefix)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(fn, *args):
        if not remat:
            return fn(*args)
        # in a sharded step the recompute runs every collective of the
        # block again, on every rank alike: none stops early
        with (torch.utils.checkpoint.set_checkpoint_early_stop(False)
              if tp.current() else contextlib.nullcontext()):
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)

    if cfg.arch_type == "audio":
        enc, fpos = _encode(params, cfg, frames, x.device, run)
        x = x + as_dtype(sinusoidal_pos(positions, cfg.d_model), x.dtype)
        for i in range(cfg.n_layers):
            x = run(_decoder_block, layer(params["blocks"], i), x,
                    positions, enc, fpos, cfg)
    elif cfg.arch_type in ("dense", "vlm", "moe"):
        for i in range(cfg.n_layers):
            bp = layer(params["blocks"], i)
            if cfg.arch_type == "moe":
                x, a = run(apply_moe_block, bp, x, positions, cfg)
                aux = aux + a
            else:
                x = run(apply_attn_block, bp, x, positions, cfg)
    elif cfg.arch_type == "ssm":
        for i in range(cfg.n_layers):
            x = run(apply_ssm_block, layer(params["blocks"], i), x, cfg)
    else:
        _, ns, nt = _hybrid_split(cfg)
        for s in range(ns):
            x = run(_apply_super, layer(params["super"], s), x, positions,
                    cfg)
        for i in range(nt):
            x = run(apply_ssm_block, layer(params["tail"], i), x, cfg)
    if cfg.arch_type == "vlm":                       # the text columns
        x = x[:, -tokens.shape[1]:]
    return _head(params, cfg, x), aux


def _take_cols(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Row b's column ``n_b - 1`` of x (B,S,d), clamped into ``[0, S-1]``
    as ``jnp.take_along_axis`` after ``jnp.clip``: (B,1,d)."""
    idx = (n.long() - 1).clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


# ---------------------------------------------------------------------------
# Single-shot path: prefill + lockstep decode over a kpos-tagged cache
# ---------------------------------------------------------------------------
def _stack(tree: Params, lead: Tuple[int, ...]) -> Params:
    return {n: t.expand(*lead, *t.shape).contiguous() for n, t in tree.items()}


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device: DeviceLike = "cuda") -> Params:
    """The decode cache with leading per-stack axes (module docstring).
    A sliding-window arch's attention caches are rings of
    ``min(window, cache_len)`` slots; ``kpos`` starts at ``-1`` (empty),
    SSM states at zero."""
    _check_family(cfg)
    dev = resolve_device(device)
    adt = dtype_of(cfg.activ_dtype)
    eff = min(cfg.sliding_window, cache_len) if cfg.sliding_window \
        else cache_len

    def attn(lead):
        return _stack(attn_mod.init_cache(batch, eff, cfg.n_kv_heads,
                                          cfg.head_dim, adt, dev), lead)

    def ssm(lead):
        return ssm_mod.init_ssm_state(batch, cfg.d_model, cfg.ssm, adt, dev,
                                      lead)

    if cfg.arch_type in ("dense", "vlm", "moe"):
        return {"layers": attn((cfg.n_layers,))}
    if cfg.arch_type == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"self": attn((cfg.n_layers,)),
                "cross": {n: torch.zeros(shape, dtype=adt, device=dev)
                          for n in ("k", "v")}}
    if cfg.arch_type == "ssm":
        return {"layers": ssm((cfg.n_layers,))}
    period, ns, nt = _hybrid_split(cfg)
    cache = {"super": {"ssm": ssm((ns, period - 1)), "attn": attn((ns,))}}
    if nt:
        cache["tail"] = ssm((nt,))
    return cache


def _at(tree: Params, *idx: int) -> Params:
    """The ``[idx]`` views of a cache subtree's leaves."""
    return {n: t[idx] for n, t in tree.items()}


def _put(tree: Params, new: Params) -> None:
    for n, t in new.items():
        tree[n].copy_(t)


def _ssm_stack_prefill(params: Params, states: Params, x: torch.Tensor,
                       cfg: ArchConfig, n: int, idx=()) -> torch.Tensor:
    """Prefill through ``n`` stacked SSM blocks, writing each block's
    decode state into ``states``' ``[*idx, i]`` views."""
    for i in range(n):
        bp = layer(params, i)
        hh = rmsnorm(bp["ln"], x, cfg.norm_eps)
        y, st = ssm_mod.ssm_prefill(bp["ssm"], hh, cfg.d_model, cfg.ssm)
        _put(_at(states, *idx, i), st)
        x = x + y
    return x


def _ssm_stack_decode(params: Params, states: Params, x: torch.Tensor,
                      cfg: ArchConfig, n: int, idx=()) -> torch.Tensor:
    for i in range(n):
        bp = layer(params, i)
        hh = rmsnorm(bp["ln"], x, cfg.norm_eps)
        st = _at(states, *idx, i)
        y, new = ssm_mod.ssm_decode(bp["ssm"], hh, st, cfg.d_model, cfg.ssm)
        _put(st, new)
        x = x + y
    return x


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Forward over the prompt (B,S), building a decode cache of
    ``cache_len`` slots (default: the sequence + 64) on the tokens'
    device. Returns (last-token logits (B,1,V), cache). ``lengths`` (B,)
    makes the batch ragged: row b's prompt is ``tokens[b, :lengths_b]``
    and its logits are column ``lengths_b - 1`` — causal masking keeps
    the padded tail out of every valid position. Ragged prompts need an
    attention cache (an SSM state would consume the padding); a MoE
    routes the padded tail too, with capacity from the padded length, so
    it is exact only while no expert overflows.

    A VLM puts ``prefix`` (B, Np, d) before the scaled tokens, when
    given; its ``lengths`` count text tokens, offset by
    ``n_prefix_tokens``. The audio family runs the encoder over
    ``frames`` (B, F, d) and keeps each decoder block's cross K/V in
    ``cache["cross"]``."""
    _check_family(cfg)
    if lengths is not None and cfg.arch_type not in ("dense", "vlm", "moe"):
        raise ValueError(f"ragged prefill needs an attention cache, not "
                         f"{cfg.arch_type!r}")
    x = _embed_in(params, cfg, tokens)
    if cfg.arch_type == "vlm":
        x = _with_prefix(x, prefix)
    B, S = x.shape[:2]
    w = cfg.sliding_window
    if cache_len is None:
        cache_len = S + 64
    if w and S > min(w, cache_len):
        raise ValueError("sliding-window prefill longer than the window is "
                         "unsupported (decode-only shape); prefill chunking "
                         "is a serving-layer feature")
    cache = init_decode_cache(cfg, B, cache_len, device=tokens.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def attn_block(bp, x, cl):
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_prefill(
            bp["attn"], hh, positions, cache=cl, window=w,
            use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
        return _ffn(bp, x + a, cfg)

    if cfg.arch_type in ("dense", "vlm", "moe"):
        for i in range(cfg.n_layers):
            x = attn_block(layer(params["blocks"], i), x,
                           _at(cache["layers"], i))
    elif cfg.arch_type == "audio":
        enc, _ = _encode(params, cfg, frames, x.device)
        x = x + as_dtype(sinusoidal_pos(positions, cfg.d_model), x.dtype)
        for i in range(cfg.n_layers):
            bp = layer(params["blocks"], i)
            hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
            x = x + attn_mod.attention_prefill(
                bp["self_attn"], hh, positions, cache=_at(cache["self"], i),
                window=w, use_rope=False)[0]
            # the cross K/V once: what attention(xkv=enc) computes, kept
            kv = attn_mod.cross_kv(bp["cross_attn"], enc)
            _put(_at(cache["cross"], i), kv)
            x = _cross_mlp(bp, x, cfg, lambda p, h: attn_mod.cross_attend(
                p, h, kv))
    elif cfg.arch_type == "ssm":
        x = _ssm_stack_prefill(params["blocks"], cache["layers"], x, cfg,
                               cfg.n_layers)
    else:
        period, ns, nt = _hybrid_split(cfg)
        for s in range(ns):
            sp = layer(params["super"], s)
            x = _ssm_stack_prefill(sp["ssm"], cache["super"]["ssm"], x, cfg,
                                   period - 1, (s,))
            x = attn_block(sp["attn"], x, _at(cache["super"]["attn"], s))
        if nt:
            x = _ssm_stack_prefill(params["tail"], cache["tail"], x, cfg, nt)
    if lengths is None:
        x = x[:, -1:, :]
    else:
        off = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
        x = _take_cols(x, torch.as_tensor(lengths, device=x.device) + off)
    return _head(params, cfg, x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cache: Params
                ) -> Tuple[torch.Tensor, Params]:
    """ONE-token lockstep decode: token (B,1), ``pos`` the one absolute
    position of every row (an int or 0-d tensor; a VLM's counts its
    prefix). Writes the cache in place. Returns (logits (B,1,V),
    cache). The audio family attends to the encoder through the cross
    K/V that ``prefill`` left in ``cache["cross"]``."""
    _check_family(cfg)
    x = _embed_in(params, cfg, token)
    pos = torch.as_tensor(pos, device=x.device)

    def attn_block(bp, x, cl):
        hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attention_decode(
            bp["attn"], hh, pos, cache=cl, window=cfg.sliding_window,
            use_rope=cfg.use_rope, rope_theta=cfg.rope_theta)
        return _ffn(bp, x + a, cfg)

    if cfg.arch_type in ("dense", "vlm", "moe"):
        for i in range(cfg.n_layers):
            x = attn_block(layer(params["blocks"], i), x,
                           _at(cache["layers"], i))
    elif cfg.arch_type == "audio":
        x = x + as_dtype(sinusoidal_pos(pos.reshape(1), cfg.d_model),
                         x.dtype)
        for i in range(cfg.n_layers):
            bp = layer(params["blocks"], i)
            hh = apply_norm(bp["ln1"], x, cfg.norm_eps)
            x = x + attn_mod.attention_decode(
                bp["self_attn"], hh, pos, cache=_at(cache["self"], i),
                window=cfg.sliding_window, use_rope=False)[0]
            kv = _at(cache["cross"], i)
            x = _cross_mlp(bp, x, cfg, lambda p, h: attn_mod.cross_attend(
                p, h, kv))
    elif cfg.arch_type == "ssm":
        x = _ssm_stack_decode(params["blocks"], cache["layers"], x, cfg,
                              cfg.n_layers)
    else:
        period, ns, nt = _hybrid_split(cfg)
        for s in range(ns):
            sp = layer(params["super"], s)
            x = _ssm_stack_decode(sp["ssm"], cache["super"]["ssm"], x, cfg,
                                  period - 1, (s,))
            x = attn_block(sp["attn"], x, _at(cache["super"]["attn"], s))
        if nt:
            x = _ssm_stack_decode(params["tail"], cache["tail"], x, cfg, nt)
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
    _check_attention_cache(cfg)
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
    for bit. Dense and MoE only, as the JAX package's."""
    _check_attention_cache(cfg, ("dense", "moe"))
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
    _check_attention_cache(cfg)
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
