"""Import side-effects: registers every architecture config (copy of
``repro.configs.all_configs``)."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    command_r_plus_104b,
    granite_8b,
    llama4_scout_17b_a16e,
    mamba2_780m,
    minitron_8b,
    mlitb_cnn,
    mlitb_lm_100m,
    paligemma_3b,
    qwen3_4b,
    whisper_large_v3,
    zamba2_7b,
)

ASSIGNED_ARCHS = [
    "llama4-scout-17b-a16e",
    "arctic-480b",
    "mamba2-780m",
    "zamba2-7b",
    "minitron-8b",
    "qwen3-4b",
    "granite-8b",
    "paligemma-3b",
    "whisper-large-v3",
    "command-r-plus-104b",
]
