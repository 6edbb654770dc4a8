"""~100M-parameter dense LM (copy of ``repro.configs.mlitb_lm_100m``) —
the model this port serves end to end."""
from repro_torch.configs.base import ArchConfig, register


@register("mlitb-lm-100m")
def mlitb_lm_100m() -> ArchConfig:
    return ArchConfig(
        name="mlitb-lm-100m",
        arch_type="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_768,
        tie_embeddings=True,
        param_dtype="float32",
        activ_dtype="float32",
        citation="examples target (GPT-2-small-like)",
    )
