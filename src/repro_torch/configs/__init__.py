from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    register,
)
from repro_torch.configs import mlitb_cnn, mlitb_lm_100m  # noqa: F401,E402
