"""The model families the reference knows, one module each, found by a
configuration's ``arch_type`` (``reference.models.family``): a new family
is a new module here and no edit elsewhere.

A family module exports

- ``layout(cfg)``: every parameter as ``(path, shape, init)``, in the tree
  the program takes (nested names joined by ``/``, a leading layer axis on
  the block leaves); ``init`` is ``("normal", std)``, ``("ones",)``,
  ``("zeros",)`` or ``("a_log",)`` (``log(linspace(1, 16, heads))``, the
  published Mamba2 initialisation of A). ``weights.make`` draws the
  ``normal`` leaves in this order, so the order is part of the weights.
- ``nll_sum(params, cfg, tokens, labels, mask, num)``: a ``Loss`` over the
  rows given, so a caller can take the weighted mean over any blocks of
  rows.
- ``matmul_params(cfg)``: the matrix parameters a token passes through,
  the head (tied or not) once; ``mixing_flops_per_token(cfg, seq)``: the
  forward FLOPs a token of the sequence mixing's products, all layers
  (``perfbench.flops``).

This module holds the pieces families share, so that a family imports
them instead of copying them. Each block takes one layer's weights
(``layer``) and the normed input, and returns what the residual adds.
``cfg`` is the configuration file's dictionary (``perfbench/configs``);
``num`` the reference's precision (``reference.numerics``).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics

Params = Dict[str, torch.Tensor]
Layout = List[Tuple[str, Tuple[int, ...], tuple]]


class Loss(NamedTuple):
    """A family's loss over the rows it was given. ``extra`` is the one
    slot for a family's own term (a router's load-balance loss): the
    gradient takes ``nll + extra``, divided by the count with it, and the
    reported loss is ``nll`` alone, as the program reports it."""
    nll: torch.Tensor                       # sum of mask * next-token loss
    count: torch.Tensor                     # sum of mask
    extra: Optional[torch.Tensor] = None

    def objective(self) -> torch.Tensor:
        """What the rows' gradient is taken of."""
        return self.nll if self.extra is None else self.nll + self.extra


def embedding_layout(cfg: dict) -> Layout:
    """The leaves every family starts with: the embedding, the final
    norm, and ``lm_head`` where the embedding is not tied."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    out: Layout = [("embed", (V, d), ("normal", 0.02)),
                   ("final_norm/scale", (d,), ("ones",))]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head", (V, d), ("normal", 0.02)))
    return out


def layer(p: Params, prefix: str, i: int) -> Params:
    """Layer ``i`` of the leaves under ``prefix``, by their names below it:
    ``layer(p, "blocks/attn/", 3)["wq"]``."""
    return {k[len(prefix):]: v[i] for k, v in p.items()
            if k.startswith(prefix)}


def head_nll(p: Params, cfg: dict, x: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, num: Numerics
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final RMSNorm, the logits through the tied embedding (or
    ``lm_head``), and (sum of mask * next-token loss, sum of mask)."""
    x = rmsnorm(x, p["final_norm/scale"], cfg["norm_eps"])
    B, S, d = x.shape
    table = p["embed"] if cfg["tie_embeddings"] else p["lm_head"]
    logits = num.mm(x.reshape(B * S, d), table.t())
    nll = torch.logsumexp(logits, dim=-1) \
        - logits.gather(1, labels.reshape(-1, 1).long())[:, 0]
    m = mask.reshape(-1).float()
    return (nll * m).sum(), m.sum()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at positions 0..S-1, rotating
    the pair (x[i], x[i + hd/2]) by position * theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(w: Params, h: torch.Tensor, cfg: dict,
              num: Numerics) -> torch.Tensor:
    """Grouped-query attention (``wq``, ``wk``, ``wv``, ``wo``) with
    rotary embeddings on the split halves of each head, scaled by
    1/sqrt(head_dim), causal softmax."""
    B, S, d = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flat = h.reshape(B * S, d)
    q = num.mm(flat, w["wq"].reshape(d, H * hd))
    k = num.mm(flat, w["wk"].reshape(d, K * hd))
    v = num.mm(flat, w["wv"].reshape(d, K * hd))
    q = _rope(q.view(B, S, H, hd), cfg["rope_theta"])
    k = _rope(k.view(B, S, K, hd), cfg["rope_theta"])
    v = v.view(B, S, K, hd)
    # query head j reads key/value head j // (H / K)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = num.einsum("bhqk,bkhd->bqhd", a, v).reshape(B * S, H * hd)
    return num.mm(o, w["wo"].reshape(H * hd, d)).view(B, S, d)


def mlp(w: Params, h: torch.Tensor, num: Numerics) -> torch.Tensor:
    """SwiGLU: ``w_down(silu(w_gate h) * w_up h)``."""
    B, S, d = h.shape
    flat = h.reshape(B * S, d)
    g = num.mm(flat, w["w_gate"])
    u = num.mm(flat, w["w_up"])
    return num.mm(F.silu(g) * u, w["w_down"]).view(B, S, d)


def ssm_dims(cfg: dict) -> Dict[str, int]:
    """Mamba2's sizes from the configuration's ``ssm`` group: inner width,
    heads, head size, state size, the convolved and projected widths, the
    convolution's width and the chunk."""
    s = cfg["ssm"]
    d = cfg["d_model"]
    di = s["expand"] * d
    nh = di // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return {"di": di, "nh": nh, "hd": s["head_dim"], "n": s["d_state"],
            "conv": di + 2 * gn, "proj": 2 * di + 2 * gn + nh,
            "w": s["d_conv"], "chunk": s["chunk"]}


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry (i, j) = x[j+1] + ... + x[i] for
    j <= i, -inf above the diagonal (the listing's stable segsum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    on_or_below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return s.masked_fill(~on_or_below, float("-inf"))


def ssd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, num: Numerics) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(A_{s+1} + ... + A_t) X_s, per head,
    in chunks of ``chunk`` (arXiv:2405.21060, Listing 1). X (b, S, h, p)
    is dt * x, A (b, S, h) is dt * A, Bm / Cm (b, S, n)."""
    b, S, h, p = X.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    c = S // chunk
    X = X.reshape(b, c, chunk, h, p)
    Bc = Bm.reshape(b, c, chunk, -1)
    Cc = Cm.reshape(b, c, chunk, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # b h c l
    A_cum = torch.cumsum(A, dim=-1)
    # 1. within each chunk
    L = torch.exp(_segsum(A))                                 # b h c l s
    CB = num.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = num.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, X)
    # 2. each chunk's final state
    decay = torch.exp(A_cum[..., -1:] - A_cum)               # b h c l
    states = num.einsum("bcln,bclhp->bchpn", Bc,
                        X * decay.permute(0, 2, 3, 1)[..., None])
    # 3. the recurrence over chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = num.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each chunk's entering state, read out
    y_off = num.einsum("bcln,bchpn->bclhp", Cc, states) \
        * torch.exp(A_cum).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, S, h, p)


def mamba2(w: Params, h: torch.Tensor, cfg: dict,
           num: Numerics) -> torch.Tensor:
    """Mamba2 (arXiv:2405.21060): ``in_proj`` into [z | x | B | C | dt], a
    causal depthwise convolution and SiLU over [x | B | C], dt =
    softplus(dt + dt_bias), A = -exp(A_log), the SSD scan (one group of B
    and C shared by every head), the skip ``D x``, the gate
    ``RMSNorm(y * silu(z))`` and ``out_proj``."""
    B, S, d = h.shape
    m = ssm_dims(cfg)
    di, nh, hd, n = m["di"], m["nh"], m["hd"], m["n"]
    proj = num.mm(h.reshape(B * S, d), w["in_proj"]).view(B, S, -1)
    z, xbc, dt = proj[..., :di], proj[..., di:di + m["conv"]], \
        proj[..., di + m["conv"]:]
    # causal depthwise convolution: out_t = sum_k w[k] x[t - (W-1) + k]
    W = m["w"]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, k:k + S] * w["conv_w"][k] for k in range(W))
    xbc = F.silu(conv + w["conv_b"])
    x = xbc[..., :di].reshape(B, S, nh, hd)
    Bm, Cm = xbc[..., di:di + n], xbc[..., di + n:di + 2 * n]
    dt = F.softplus(dt + w["dt_bias"])                      # b S h
    A = -torch.exp(w["A_log"])
    y = ssd(x * dt[..., None], dt * A, Bm, Cm, m["chunk"], num)
    y = y + w["D"][:, None] * x
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), w["gate_norm/scale"], 1e-5)
    return num.mm(y.reshape(B * S, di), w["out_proj"]).view(B, S, d)
