from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)
from repro_torch.configs import all_configs  # noqa: F401,E402
