"""The serving tier: service + placement + warmup + continuous batcher.

The port of :mod:`repro.serve.tier`. :class:`ServingTier` is the
deployable unit::

    tier = ServingTier(service, n_features=F, config=TierConfig(doc_counts=(64, 256)))
    tier.start()                 # kernel build dir, warmup, then the batcher
    fut = tier.submit(features)  # non-blocking, one query
    top_idx, scores = fut.result()
    tier.stop()

``start()`` points the kernel build at its directory, installs the
degradation ladder, warms every ``(Q, D)`` bucket the batching policy can
produce for ``doc_counts`` at every rung, and only then opens the queue.

One thread makes every engine call: the batcher's worker (and, before it
starts and after it stops, the caller of ``start``/``stop``). That is what
keeps the service's adaptive state and the kernels' scratch race-free: the
scratch is kept per (device, stream), and the worker and the caller share
the device's default stream. Stand up one tier per service.

The reference's keyword shim (``ServingTier(svc, F, doc_counts=…)`` and
friends) is kept for old callers: it builds the same :class:`TierConfig`
and warns with a ``DeprecationWarning``.
"""

from __future__ import annotations

import dataclasses
import typing
import warnings
from collections.abc import Sequence
from concurrent.futures import Future

from repro_torch.serve.batching import (
    BatcherHooks,
    BatcherStats,
    BucketPolicy,
    ContinuousBatcher,
)
from repro_torch.serve.degradation import DegradationController, DegradationPolicy
from repro_torch.serve.placement import ServePlacement, single_device
from repro_torch.serve.ranking_service import RankingService
from repro_torch.serve.warmup import WarmupReport, enable_persistent_cache, warmup_service

if typing.TYPE_CHECKING:
    import numpy as np
    from numpy.typing import ArrayLike

    from repro_torch.serve.clock import Clock

_DEPRECATED_TIER_MSG = (
    "repro_torch.serve.tier.ServingTier: keyword configuration (doc_counts=…, "
    "warmup=…, …) is deprecated; pass a TierConfig as the third argument. The "
    "shim builds the equivalent config and will be removed in a future release."
)


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """The tier's deployment knobs: what to warm, whether to warm, where
    the kernel library lives (``cache_dir``, default ``build/repro_torch/``)
    and the degradation ladder."""

    doc_counts: tuple[int, ...] = (64,)
    warmup: bool = True
    persistent_cache: bool = True
    cache_dir: str | None = None
    degradation: DegradationPolicy | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "doc_counts", tuple(int(d) for d in self.doc_counts))
        if not self.doc_counts:
            raise ValueError("need at least one doc count")


class ServingTier:
    def __init__(
        self,
        service: RankingService,
        n_features: int,
        config: TierConfig | None = None,
        policy: BucketPolicy | None = None,
        placement: ServePlacement | None = None,
        *,
        clock: Clock | None = None,
        hooks: BatcherHooks | None = None,
        doc_counts: Sequence[int] | None = None,
        warmup: bool | None = None,
        persistent_cache: bool | None = None,
        cache_dir: str | None = None,
    ) -> None:
        if config is not None and not isinstance(config, TierConfig):
            # Legacy positional call: ServingTier(svc, F, (64, 256), …)
            if doc_counts is not None:
                raise TypeError("ServingTier: doc_counts given twice")
            config, doc_counts = None, tuple(config)
        legacy = {
            name: value
            for name, value in (
                ("doc_counts", doc_counts), ("warmup", warmup),
                ("persistent_cache", persistent_cache), ("cache_dir", cache_dir),
            )
            if value is not None
        }
        if config is None:
            if legacy:
                warnings.warn(_DEPRECATED_TIER_MSG, DeprecationWarning, stacklevel=2)
            config = TierConfig(**legacy)
        elif legacy:
            raise TypeError(
                "ServingTier: pass configuration via TierConfig OR the deprecated "
                f"keywords, not both (got {sorted(legacy)})"
            )
        self.config = config
        self.service = service
        self.n_features = int(n_features)
        self.policy = policy or BucketPolicy()
        self.placement = placement or single_device()
        self.warmup_report: WarmupReport | None = None
        self.degradation = (
            DegradationController(service, self.config.degradation, clock=clock)
            if self.config.degradation is not None else None
        )
        self.batcher = ContinuousBatcher(
            service, self.n_features, self.policy,
            placement=self.placement, clock=clock, hooks=hooks,
            degradation=self.degradation,
        )
        self._started = False

    def start(self) -> ServingTier:
        if self._started:
            raise RuntimeError("tier already started")
        cfg = self.config
        cache_dir = enable_persistent_cache(cfg.cache_dir) if cfg.persistent_cache else None
        if self.degradation is not None and self.service.n_rungs == 0:
            # Install every rung before warmup, which then warms them all.
            self.degradation.install()
        if cfg.warmup:
            self.warmup_report = warmup_service(
                self.service, self.n_features, self.policy.buckets(cfg.doc_counts),
                placement=self.placement,
            )
            self.warmup_report.cache_dir = cache_dir
        self.batcher.start()
        self._started = True
        return self

    def submit(self, features: ArrayLike, deadline_ms: float | None = None) -> Future:
        """Non-blocking: one query's ``[n_docs, F]`` candidates → a future
        of ``(top_idx, scores)`` (see :meth:`ContinuousBatcher.submit`)."""
        return self.batcher.submit(features, deadline_ms=deadline_ms)

    def rank(self, features: ArrayLike) -> tuple[np.ndarray, np.ndarray]:
        """Blocking form of :meth:`submit`."""
        return self.submit(features).result()

    def stop(self) -> None:
        if self._started:
            self.batcher.stop()
            self._started = False

    def stats(self) -> dict:
        """Operator snapshot: batcher counters and service aggregates."""
        svc, b = self.service.stats, self.batcher.stats
        return {
            "batcher": {f.name: getattr(b, f.name) for f in dataclasses.fields(BatcherStats)},
            "service": {
                "batches": svc.batches,
                "queries": svc.queries,
                "docs": svc.docs,
                "overflow_docs": svc.overflow_docs,
                "speedup": svc.speedup,
                "continue_rate": svc.continue_rate,
                "batches_fused": svc.batches_fused,
                "batches_staged": svc.batches_staged,
                "queries_exited": svc.queries_exited,
                "query_exit_rate": svc.query_exit_rate,
            },
            "warmup_seconds": self.warmup_report.total_seconds if self.warmup_report else 0.0,
            "n_devices": self.placement.n_devices,
        }

    def health(self) -> dict:
        """Liveness: supervisor state, restarts and crashes, queue depth,
        p50/p99 completion latency, the placement's device count and, with
        a ladder, the current rung."""
        h = self.batcher.health()
        h["started"] = self._started
        h["n_devices"] = self.placement.n_devices
        if self.degradation is not None:
            h["degradation"] = self.degradation.snapshot()
        return h
