"""Minitron-8B — width-pruned Nemotron-4 15B.

[arXiv:2407.14679] — 32L, d_model=4096, 32 heads GQA kv=8, d_ff=16384
(squared-ReLU MLP in the original; we use the registry's silu gate which the
pruning paper also ablates), vocab 256000 (SentencePiece 256k).
"""
from repro_torch.configs.base import ArchConfig, register


@register("minitron-8b")
def minitron() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab_size=256_000,
        citation="arXiv:2407.14679",
    )
