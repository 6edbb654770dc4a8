"""``dense``: a pre-norm decoder (RMSNorm; grouped-query attention with
rotary embeddings, causal softmax; a SwiGLU MLP), the final RMSNorm, and
the logits through the tied embedding (or ``lm_head``).

FLOPs: causal attention takes per layer 2 hd H (S + 1) forward (Q K^T and
P V over the (S + 1) / 2 keys a query sees on average)."""
from __future__ import annotations

from perfbench.reference.families import (Layout, Loss, attention,
                                          embedding_layout, head_nll, layer,
                                          mlp, rmsnorm)


def layout(cfg: dict) -> Layout:
    d, L = cfg["d_model"], cfg["n_layers"]
    H, K, hd, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                    cfg["d_ff"])
    return embedding_layout(cfg) + [
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


def nll_sum(p, cfg, tokens, labels, mask, num) -> Loss:
    eps = cfg["norm_eps"]
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = x + attention(layer(p, "blocks/attn/", i),
                          rmsnorm(x, p["blocks/ln1/scale"][i], eps), cfg, num)
        x = x + mlp(layer(p, "blocks/mlp/", i),
                    rmsnorm(x, p["blocks/ln2/scale"][i], eps), num)
    return Loss(*head_nll(p, cfg, x, labels, mask, num))


def matmul_params(cfg: dict) -> int:
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    H, K, hd, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                    cfg["d_ff"])
    per = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * ff
    return L * per + V * d            # the head (tied or not) once


def mixing_flops_per_token(cfg: dict, seq: int) -> int:
    return cfg["n_layers"] * 2 * cfg["head_dim"] * cfg["n_heads"] * (seq + 1)
