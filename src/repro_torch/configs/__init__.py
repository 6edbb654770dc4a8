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
from repro_torch.configs.shapes import (  # noqa: F401,E402
    SHAPE_REGISTRY,
    InputShape,
    get_shape,
)
