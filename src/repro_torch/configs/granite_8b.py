"""Granite-8B-Code — llama-architecture code model.

[arXiv:2405.04324] — 36L, d_model=4096, 32 heads GQA kv=8, d_ff=14336,
vocab 49152 (StarCoder tokenizer).
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-8b")
def granite() -> ArchConfig:
    return ArchConfig(
        name="granite-8b",
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=49_152,
        tie_embeddings=True,
        rope_theta=10_000_000.0,
        citation="arXiv:2405.04324",
    )
