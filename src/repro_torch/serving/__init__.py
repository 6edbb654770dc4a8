from repro_torch.serving.engine import (Completion, ServeRequest,  # noqa: F401
                                        ServeStats, ServingEngine, Shed,
                                        SimulatedServeSession, StepReport,
                                        pow2_bucket)
from repro_torch.serving.config import (BackpressureConfig,  # noqa: F401
                                        PagingConfig, SamplingConfig,
                                        ServingConfig, SpeculativeConfig)
from repro_torch.serving.baseline import simulate_static_batches  # noqa: F401
from repro_torch.serving.paging import PagePool, PrefixTrie  # noqa: F401
from repro_torch.serving.requests import generate_requests  # noqa: F401
