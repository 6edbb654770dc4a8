"""Llama-4 Scout 17B-active/16-expert MoE decoder backbone.

[hf:meta-llama/Llama-4-Scout-17B-16E] — 48L, d_model=5120, 40 q heads with
GQA kv=8, expert d_ff=8192, vocab 202048, 16 routed experts top-1 plus a
shared expert ("early fusion" refers to the multimodal token path; the
assignment specifies the language backbone, which is what we build).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        moe=MoEConfig(
            n_experts=16,
            experts_per_token=1,
            d_ff_expert=8192,
            shared_expert=True,
        ),
        rope_theta=500_000.0,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
