"""``ssm``: Mamba2 blocks (arXiv:2405.21060), each RMSNorm then ``mamba2``
on the residual, the final RMSNorm, and the logits through the tied
embedding (or ``lm_head``).

FLOPs: the chunked SSD at chunk Q, causal pairs only, per layer forward:
(Q + 1) N (C B^T) + (Q + 1) H hd (the masked product with x) + 2 N H hd
(the chunk's state) + 2 N H hd (reading it out)."""
from __future__ import annotations

from perfbench.reference.families import (Layout, Loss, embedding_layout,
                                          head_nll, layer, mamba2, rmsnorm,
                                          ssm_dims)


def layout(cfg: dict) -> Layout:
    d, L = cfg["d_model"], cfg["n_layers"]
    m = ssm_dims(cfg)
    return embedding_layout(cfg) + [
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


def nll_sum(p, cfg, tokens, labels, mask, num) -> Loss:
    eps = cfg["norm_eps"]
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = x + mamba2(layer(p, "blocks/ssm/", i),
                       rmsnorm(x, p["blocks/ln/scale"][i], eps), cfg, num)
    return Loss(*head_nll(p, cfg, x, labels, mask, num))


def matmul_params(cfg: dict) -> int:
    m = ssm_dims(cfg)
    per = cfg["d_model"] * m["proj"] + m["di"] * cfg["d_model"]
    return cfg["n_layers"] * per + cfg["vocab_size"] * cfg["d_model"]


def mixing_flops_per_token(cfg: dict, seq: int) -> int:
    m = ssm_dims(cfg)
    Q, N, hp = m["chunk"], m["n"], m["nh"] * m["hd"]
    return cfg["n_layers"] * ((Q + 1) * N + (Q + 1) * hp + 4 * N * hp)
