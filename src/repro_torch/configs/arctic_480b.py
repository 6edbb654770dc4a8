"""Snowflake Arctic 480B dense-MoE hybrid.

[hf:Snowflake/snowflake-arctic-base] — 35L, d_model=7168, 56 heads GQA kv=8,
128 routed experts top-2 with expert d_ff=4864, PLUS a parallel dense
residual FFN on every layer (Arctic's "dense-MoE hybrid" design).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("arctic-480b")
def arctic() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        arch_type="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        moe=MoEConfig(
            n_experts=128,
            experts_per_token=2,
            d_ff_expert=4864,
            dense_residual=True,
        ),
        citation="hf:Snowflake/snowflake-arctic-base",
    )
