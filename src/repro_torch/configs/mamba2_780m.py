"""Mamba2-780m — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060] — 48L, d_model=1536, ssm_state=128, expand=2 (d_inner
3072, 48 heads of dim 64), vocab 50280 (GPT-NeoX tokenizer). Decode state is
O(1) in sequence length, so long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("mamba2-780m")
def mamba2() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        arch_type="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
        citation="arXiv:2405.21060",
    )
