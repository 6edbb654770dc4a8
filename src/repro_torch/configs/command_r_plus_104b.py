"""Command R+ 104B — large dense decoder, GQA, no biases.

[hf:CohereForAI/c4ai-command-r-plus] — 64L, d_model=12288, 96 heads GQA
kv=8, d_ff=33792, vocab 256000, no attention/MLP biases, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register


@register("command-r-plus-104b")
def command_r_plus() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b",
        arch_type="dense",
        n_layers=64,
        d_model=12_288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33_792,
        vocab_size=256_000,
        tie_embeddings=True,
        rope_theta=75_000_000.0,
        citation="hf:CohereForAI/c4ai-command-r-v01",
    )
