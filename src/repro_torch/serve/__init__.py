"""The serving tier: ranking service, continuous batcher, supervision,
degradation rungs, warmup and placement (one device, or shards over several); and LM
generation (``generate``)."""

from repro_torch.serve.batching import (
    BatcherHooks,
    BatcherStats,
    BucketPolicy,
    ContinuousBatcher,
)
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.degradation import (
    DegradationController,
    DegradationPolicy,
    ExitRung,
)
from repro_torch.serve.errors import (
    BatcherStopped,
    DeadlineExceeded,
    Overloaded,
    ServeError,
    WorkerCrashed,
    WorkerFailed,
)
from repro_torch.serve.lm_serve import generate
from repro_torch.serve.placement import ServePlacement
from repro_torch.serve.ranking_service import (
    RankingService,
    ServiceConfig,
    ServiceStats,
)
from repro_torch.serve.supervisor import SupervisorHealth, WorkerSupervisor
from repro_torch.serve.tier import ServingTier, TierConfig
from repro_torch.serve.warmup import enable_persistent_cache, warmup_service

__all__ = [
    "BatcherHooks",
    "BatcherStats",
    "BatcherStopped",
    "BucketPolicy",
    "Clock",
    "ContinuousBatcher",
    "DeadlineExceeded",
    "DegradationController",
    "DegradationPolicy",
    "ExitRung",
    "MonotonicClock",
    "Overloaded",
    "RankingService",
    "ServeError",
    "ServePlacement",
    "ServiceConfig",
    "ServiceStats",
    "ServingTier",
    "SupervisorHealth",
    "TierConfig",
    "WorkerCrashed",
    "WorkerFailed",
    "WorkerSupervisor",
    "enable_persistent_cache",
    "generate",
    "warmup_service",
]
