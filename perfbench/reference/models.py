"""The two model families the cells train, as plain float32 PyTorch.

``layout(cfg)`` lists every parameter as ``(path, shape, init)``, in the
tree the program takes (nested names joined by ``/``, a leading layer
axis on the block leaves); ``init`` is ``("normal", std)``, ``("ones",)``,
``("zeros",)`` or ``("a_log",)`` (``log(linspace(1, 16, heads))``, the
published Mamba2 initialisation of A).

``nll_sum(params, cfg, tokens, labels, mask, num)`` is the masked sum of
the next-token losses and the mask's sum, so a caller can take the
weighted mean over any blocks of rows.

- ``dense``: a pre-norm decoder (RMSNorm; grouped-query attention with
  rotary embeddings on the split halves of each head, causal softmax;
  a SwiGLU MLP), the final RMSNorm, and the logits through the tied
  embedding (or ``lm_head``).
- ``ssm``: Mamba2 (arXiv:2405.21060): RMSNorm, then ``in_proj`` into
  [z | x | B | C | dt], a causal depthwise convolution and SiLU over
  [x | B | C], dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD
  scan as the paper's minimal chunked listing computes it (one group of
  B and C shared by every head), the skip ``D x``, the gate
  ``RMSNorm(y * silu(z))`` and ``out_proj``.

``cfg`` is the configuration file's dictionary (``perfbench/configs``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics

Params = Dict[str, torch.Tensor]
Layout = List[Tuple[str, Tuple[int, ...], tuple]]


def ssm_dims(cfg: dict) -> Dict[str, int]:
    s = cfg["ssm"]
    d = cfg["d_model"]
    di = s["expand"] * d
    nh = di // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return {"di": di, "nh": nh, "hd": s["head_dim"], "n": s["d_state"],
            "conv": di + 2 * gn, "proj": 2 * di + 2 * gn + nh,
            "w": s["d_conv"], "chunk": s["chunk"]}


def layout(cfg: dict) -> Layout:
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    out: Layout = [("embed", (V, d), ("normal", 0.02)),
                   ("final_norm/scale", (d,), ("ones",))]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head", (V, d), ("normal", 0.02)))
    if cfg["arch_type"] == "dense":
        H, K, hd, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                        cfg["d_ff"])
        out += [
            ("blocks/ln1/scale", (L, d), ("ones",)),
            ("blocks/attn/wq", (L, d, H, hd), ("normal", d ** -0.5)),
            ("blocks/attn/wk", (L, d, K, hd), ("normal", d ** -0.5)),
            ("blocks/attn/wv", (L, d, K, hd), ("normal", d ** -0.5)),
            ("blocks/attn/wo", (L, H, hd, d), ("normal", (H * hd) ** -0.5)),
            ("blocks/ln2/scale", (L, d), ("ones",)),
            ("blocks/mlp/w_gate", (L, d, ff), ("normal", d ** -0.5)),
            ("blocks/mlp/w_up", (L, d, ff), ("normal", d ** -0.5)),
            ("blocks/mlp/w_down", (L, ff, d), ("normal", ff ** -0.5)),
        ]
    elif cfg["arch_type"] == "ssm":
        m = ssm_dims(cfg)
        out += [
            ("blocks/ln/scale", (L, d), ("ones",)),
            ("blocks/ssm/in_proj", (L, d, m["proj"]), ("normal", d ** -0.5)),
            ("blocks/ssm/conv_w", (L, m["w"], m["conv"]),
             ("normal", m["w"] ** -0.5)),
            ("blocks/ssm/conv_b", (L, m["conv"]), ("zeros",)),
            ("blocks/ssm/A_log", (L, m["nh"]), ("a_log",)),
            ("blocks/ssm/D", (L, m["nh"]), ("ones",)),
            ("blocks/ssm/dt_bias", (L, m["nh"]), ("zeros",)),
            ("blocks/ssm/gate_norm/scale", (L, m["di"]), ("ones",)),
            ("blocks/ssm/out_proj", (L, m["di"], d),
             ("normal", m["di"] ** -0.5)),
        ]
    else:
        raise ValueError(f"the reference has no {cfg['arch_type']!r} family")
    return out


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


def _attention(p: Params, i: int, h: torch.Tensor, cfg: dict,
               num: Numerics) -> torch.Tensor:
    B, S, d = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flat = h.reshape(B * S, d)
    q = num.mm(flat, p["blocks/attn/wq"][i].reshape(d, H * hd))
    k = num.mm(flat, p["blocks/attn/wk"][i].reshape(d, K * hd))
    v = num.mm(flat, p["blocks/attn/wv"][i].reshape(d, K * hd))
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
    return num.mm(o, p["blocks/attn/wo"][i].reshape(H * hd, d)).view(B, S, d)


def _mlp(p: Params, i: int, h: torch.Tensor, num: Numerics) -> torch.Tensor:
    B, S, d = h.shape
    flat = h.reshape(B * S, d)
    g = num.mm(flat, p["blocks/mlp/w_gate"][i])
    u = num.mm(flat, p["blocks/mlp/w_up"][i])
    return num.mm(F.silu(g) * u, p["blocks/mlp/w_down"][i]).view(B, S, d)


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


def _mamba2(p: Params, i: int, h: torch.Tensor, cfg: dict,
            num: Numerics) -> torch.Tensor:
    B, S, d = h.shape
    m = ssm_dims(cfg)
    di, nh, hd, n = m["di"], m["nh"], m["hd"], m["n"]
    w = {k.split("/", 2)[2]: v[i] for k, v in p.items()
         if k.startswith("blocks/ssm/")}
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


def nll_sum(p: Params, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, num: Numerics
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of mask * next-token loss, sum of mask) over the rows given."""
    eps = cfg["norm_eps"]
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        if cfg["arch_type"] == "dense":
            x = x + _attention(p, i, rmsnorm(x, p["blocks/ln1/scale"][i], eps),
                               cfg, num)
            x = x + _mlp(p, i, rmsnorm(x, p["blocks/ln2/scale"][i], eps), num)
        else:
            x = x + _mamba2(p, i, rmsnorm(x, p["blocks/ln/scale"][i], eps),
                            cfg, num)
    x = rmsnorm(x, p["final_norm/scale"], eps)
    B, S, d = x.shape
    table = p["embed"] if cfg["tie_embeddings"] else p["lm_head"]
    logits = num.mm(x.reshape(B * S, d), table.t())
    nll = torch.logsumexp(logits, dim=-1) \
        - logits.gather(1, labels.reshape(-1, 1).long())[:, 0]
    m = mask.reshape(-1).float()
    return (nll * m).sum(), m.sum()
