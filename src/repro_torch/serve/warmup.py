"""Warmup: pay every first-touch cost before the first real request.

The port of :mod:`repro.serve.warmup`. The reference's warmup compiles one
jitted step per ``(Q, D)`` bucket ahead of time. The port runs eagerly, so
its first-touch costs are different ones, each of which would otherwise
land on a request (:func:`repro_torch.kernels.forest_score.first_touches`
counts them):

- the ``nvcc`` build and load of the kernel libraries;
- the ``padded_forest`` buffers and packed tables of every boundary set
  the rungs use;
- the launcher's plan for every ``(B, F, …)`` the capacities produce, and
  the shared-memory opt-in;
- the per-stream scratch, grown to its largest size;
- a hybrid service's dense scorer at every bucket's row count (the first
  GEMMs of a shape on a stream: BLAS handle, workspace, kernel choice).

:func:`warmup_service` drives one synthetic batch per bucket × rung × EMA
probe, as the reference does. Before a bucket's first batch it seeds the
bucket's survivor peaks at ``seed_peak_frac × Q × D`` (with the default
1.0 the capacities start at the physical maximum: no cold-start overflow,
and the running max keeps them there, so the plans never change). After
it, stats and EMAs are wiped; the peaks stay. A warmed bucket served at
any installed rung then adds no first touch.

:func:`enable_persistent_cache` is the counterpart of JAX's persistent
compilation cache: the kernel libraries are built once per source hash into a
directory that outlives the process.
"""

from __future__ import annotations

import dataclasses
import time
import typing
from collections.abc import Sequence
from pathlib import Path

import numpy as np

from repro_torch.kernels import build
from repro_torch.serve.ranking_service import RankingService, ServiceStats

if typing.TYPE_CHECKING:  # annotation-only: avoids a serve-package cycle
    from repro_torch.serve.placement import ServePlacement

DEFAULT_WARMUP_BUCKETS = ((1, 64), (4, 64), (8, 64))


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Build and find the kernel libraries under ``cache_dir`` (created if
    needed; default ``build/repro_torch/`` in the checkout) and return the
    directory. Call it before the first build: it raises ``RuntimeError``
    once a library is loaded from another directory."""
    path = Path(cache_dir) if cache_dir is not None else build.DEFAULT_BUILD_DIR
    build.set_build_dir(path)
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


@dataclasses.dataclass
class WarmupReport:
    buckets: list[tuple[int, int]]
    seconds_per_bucket: dict[tuple[int, int], float]
    cache_dir: str | None = None
    rungs_warmed: int = 1   # degradation rungs served per bucket

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds_per_bucket.values())


def warmup_service(
    service: RankingService,
    n_features: int,
    buckets: Sequence[tuple[int, int]] = DEFAULT_WARMUP_BUCKETS,
    *,
    seed_peak_frac: float = 1.0,
    run_both_branches: bool = True,
    warm_rungs: bool = True,
    placement: ServePlacement | None = None,
) -> WarmupReport:
    """Serve one synthetic batch per ``(Q, D)`` bucket, installed rung and
    EMA probe before real traffic.

    Per bucket: seed its survivor peaks (stable capacities, no cold-start
    overflow), then run a batch of zeros with the EMA at 0 — and, in
    ``auto`` with several sentinels and ``run_both_branches``, again at
    ``Q·D``, so the host pick runs staged and fused in turn. With
    ``warm_rungs`` and a ladder installed, every rung is served this way.
    Stage counts are ``service.n_stages``, the dense gate included, so a
    hybrid service runs its whole path (dense scorer, gate, compaction,
    tree stages on the compacted block) at every bucket and rung.
    The service is left at rung 0 with clean stats and no EMA; the seeded
    peaks stay.
    """
    n_stages = service.n_stages
    rung_levels: list[int | None] = [None]
    if warm_rungs and service.n_rungs > 1:
        rung_levels = list(range(service.n_rungs))
    report = WarmupReport(buckets=[], seconds_per_bucket={}, rungs_warmed=len(rung_levels))
    for Q, D in buckets:
        t0 = time.perf_counter()
        state = service.bucket_state(Q, D)
        if state.peaks is None:
            state.peaks = [max(1, min(int(seed_peak_frac * Q * D), Q * D))] * n_stages
        X = np.zeros((Q, D, n_features), np.float32)
        mask = np.ones((Q, D), bool)
        # The extreme EMAs steer the host pick to each mode in turn (no
        # survivors prices staged cheapest, all survivors fused).
        ema_probes = [[0.0] * n_stages]
        if run_both_branches and service.execution_mode == "auto" and len(service.sentinels) > 1:
            ema_probes.append([float(Q * D)] * n_stages)
        for level in rung_levels:
            if level is not None:
                service.set_rung(level)
            for ema in ema_probes:
                state.ema = ema
                service.rank_batch(X, mask, placement=placement)
        state.ema = None  # real traffic learns its own survivor rates
        report.buckets.append((Q, D))
        report.seconds_per_bucket[(Q, D)] = time.perf_counter() - t0
    if rung_levels[-1] is not None:
        service.set_rung(0)  # real traffic starts at the baseline
    service.stats = ServiceStats()  # warmup batches are not traffic
    return report
