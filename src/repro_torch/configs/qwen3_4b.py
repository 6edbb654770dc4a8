"""Qwen3-4B — dense decoder with QK-RMSNorm and GQA.

[hf:Qwen/Qwen3-8B family] — 36L, d_model=2560, 32 q heads (head_dim 128,
per model card) GQA kv=8, d_ff=9728, vocab 151936, qk_norm=True.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-4b")
def qwen3() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b",
        arch_type="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        citation="hf:Qwen/Qwen3-8B",
    )
