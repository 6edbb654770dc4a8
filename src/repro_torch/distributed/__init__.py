"""The multi-device surface: sharding rules, collectives over a mesh's
axis groups, and the sharded train step (the counterpart of
``repro.distributed``)."""
from repro_torch.distributed.sharding import (batch_spec,  # noqa: F401
                                              cache_specs, param_shardings,
                                              param_specs, to_shardings,
                                              train_batch_specs)
