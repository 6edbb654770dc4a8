"""Whisper-large-v3 transformer backbone (encoder-decoder) with audio stub.

[arXiv:2212.04356] — 32 encoder + 32 decoder layers, d_model=1280, 20 heads
(MHA kv=20), d_ff=5120 (GELU MLP), vocab 51866. The mel-spectrogram + conv
frontend is a STUB per the assignment: ``input_specs`` provides 1500
precomputed frame embeddings. Learned positions, no RoPE, LayerNorm with
bias (true to Whisper).
"""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-large-v3")
def whisper() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3",
        arch_type="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        mlp_act="gelu",
        use_rope=False,
        attn_bias=True,
        enc_dec=True,
        n_encoder_layers=32,
        encoder_seq=1500,
        frontend="audio",
        citation="arXiv:2212.04356",
    )
