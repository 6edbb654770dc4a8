"""PaliGemma-3B language backbone (Gemma-2B decoder) with vision stub.

[arXiv:2407.07726] — 18L, d_model=2048, 8 q heads (head_dim 256) with MQA
kv=1, d_ff=16384, vocab 257216. The SigLIP vision tower + projector is a
STUB per the assignment: ``input_specs`` provides 256 precomputed patch
embeddings prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig, register


@register("paligemma-3b")
def paligemma() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        arch_type="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        vocab_size=257_216,
        mlp_act="gelu_glu",
        tie_embeddings=True,
        frontend="vision",
        n_prefix_tokens=256,
        citation="arXiv:2407.07726",
    )
