"""The paper's primary contribution: the MLitB elastic distributed-SGD
runtime (event loop, scheduler, allocator, reducer, closures,
compression, guardrails, adaptive per-worker keep, simulation, the
two-tier hierarchy), ported from ``repro.core``."""
from repro_torch.core.adaptive_frac import AdaptiveFracController  # noqa: F401
from repro_torch.core.allocator import DataAllocator  # noqa: F401
from repro_torch.core.closure import ResearchClosure  # noqa: F401
from repro_torch.core.compression import (CompressedMessage,  # noqa: F401
                                          GradientCompressor,
                                          decompress_flat)
from repro_torch.core.config import (DeadlineConfig,  # noqa: F401
                                     HierarchyConfig, PublishConfig,
                                     TrainingConfig)
from repro_torch.core.elastic import (JoinEvent, LeaveEvent,  # noqa: F401
                                      UploadDataEvent)
from repro_torch.core.event_loop import MasterEventLoop  # noqa: F401
from repro_torch.core.flatbuf import FlatSpec, flat_spec  # noqa: F401
from repro_torch.core.guardrails import (CanaryGate,  # noqa: F401
                                         GuardrailConfig, TrainingGuardrails)
from repro_torch.core.hierarchy import HierarchicalMaster  # noqa: F401
from repro_torch.core.reducer import (MasterReducer,  # noqa: F401
                                      weighted_reduce)
from repro_torch.core.scheduler import AdaptiveScheduler  # noqa: F401
