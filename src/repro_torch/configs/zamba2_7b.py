"""Zamba2-7B — Mamba2 backbone with interleaved shared attention blocks.

[arXiv:2411.15242] — 81 blocks, d_model=3584, ssm_state=64; shared
attention(+MLP d_ff=14336) blocks (32 heads, MHA kv=32) interleave the
Mamba2 stack (here: every 6th block), vocab 32000.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("zamba2-7b")
def zamba2() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14_336,
        vocab_size=32_000,
        hybrid_attn_period=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        citation="arXiv:2411.15242",
    )
