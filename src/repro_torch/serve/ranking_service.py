"""Batched ranking service with the LEAR cascade.

The port of :mod:`repro.serve.ranking_service`. A batch of queries arrives
with its candidate documents (feature-extracted, padded to ``[Q, D, F]``);
the service scores them through the λ-MART ensemble with document-level
early exit and returns the top-k:

- the multi-sentinel progressive engine
  (:meth:`repro_torch.core.cascade.CascadeRanker.rank_progressive`): all
  three forests of the path — ranker head, LEAR classifier, ranker tail —
  go through the port's forest kernels, and LEAR's sentinel-time features
  are built on the device between the head and the classifier;
- fused vs staged execution picked per batch by :meth:`_pick_mode` on the
  host, from the batch shape's smoothed survivor counts (the reference's
  host reference pick; its on-device ``lax.cond`` has no eager
  counterpart without a sync);
- a calibrated cost model (``launch_overhead_trees="auto"`` measures the
  launch overhead on the service's device at start-up);
- compaction capacities from a running per-stage survivor peak with
  headroom, never below the cold-start estimate, in powers of two;
- ONE device→host copy per batch: the stats (per-stage survivors, trees
  traversed, overflow, doc count, exited queries; float64), the top-k
  (int64) and the scores (float32) are packed, each in its own type, as
  the bytes of one tensor and read together through
  :func:`repro_torch.utils.device_get`, into page-locked memory on the
  card; the response is numpy views of that read, with no cast
  (``count_host_transfers`` holds the tests to the one read);
- overflowing survivors keep their sentinel scores (bounded quality loss,
  never a crash), and the stats record them;
- query-level exit (``ServiceConfig.query_exit``) with the device-gated
  tail, and its smoothed tail-skip rate discounting the tail launch in the
  mode pick;
- the hybrid cascade (``ServiceConfig.dense_stage``): a dense stage-0 gate
  ahead of the tree stages, its scorer moved to the service's device once
  at construction; peaks, EMA and capacities then carry a leading dense
  entry, and the accounting charges its ``cost_trees`` per candidate;
- a degradation ladder of exit rungs (:meth:`RankingService.install_rungs`
  / :meth:`RankingService.set_rung`), each materialized once (its strategy
  closures and, for ``dense_keep_frac``, its dense stage), so stepping it
  swaps objects and allocates nothing;
- data-parallel placement (:mod:`repro_torch.serve.placement`): the batch
  arrives in shards along Q, each on its device; the service keeps one
  copy of its forests (and dense scorer) per device, made at the first
  batch there, runs the cascade on each shard in turn, hands each shard
  the compaction counts of the shards before it (device tensors, so a
  capacity overflows exactly where it would for the whole batch), and
  gathers the shards' response and stats on its own device for the one
  host read. Capacities and mode are picked once, for the whole batch.

Per-``(Q, D)`` bucket state: each padded batch shape keeps its own survivor
peaks, EMA and tail-skip rate, so a sparse trickle does not shrink a bulk
bucket.

:class:`TwoStageCascade` carries the same early exit over to arbitrary
scorers (recommendation retrieval: a cheap score filters, a full model
scores the survivors).

The reference's keyword shim (``RankingService(ens, clf, threshold=…)``)
is kept for old callers: it builds the same :class:`ServiceConfig` and
warns with a ``DeprecationWarning``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import typing
import warnings
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cascade import CascadeRanker, CascadeResult, bucket_capacity
from repro_torch.core.features import rank_plan
from repro_torch.core.lear import LearClassifier, augment_features
from repro_torch.core.stage import DenseStage, EngineConfig, TreeStage
from repro_torch.core.strategies import QueryExitConfig, dense_keep_fraction
from repro_torch.forest.ensemble import TreeEnsemble
from repro_torch.kernels.ops import ENGINE_BLOCK_B
from repro_torch.metrics.speedup import progressive_cost_model
from repro_torch.serve.calibration import calibrate_launch_overhead_trees
from repro_torch.serve.placement import ServePlacement, single_device
from repro_torch.tracing import span
from repro_torch.utils import device_get, host_pinned, resolve_device

if typing.TYPE_CHECKING:  # annotation-only: avoids a serve-package cycle
    from repro_torch.serve.degradation import ExitRung

_DEPRECATED_SERVICE_MSG = (
    "repro_torch.serve.ranking_service.RankingService: keyword configuration "
    "(threshold=…, execution_mode=…, …) is deprecated; pass a ServiceConfig "
    "as the third argument. The shim builds the equivalent config and will "
    "be removed in a future release."
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen bundle of every :class:`RankingService` tuning knob.

    ``query_exit`` turns on query-level exit. ``dense_stage`` turns the
    service into the hybrid cascade (the dense gate is stage 0 of every
    step); set its ``capacity`` to pin the dense survivor block, else the
    per-bucket ratchet sizes it like any stage. ``use_kernel_classifier``
    scores the LEAR classifiers through the forest kernel (else through
    the plain bitvector scorer).
    """

    threshold: float = 0.5
    capacity_headroom: float = 1.25
    top_k: int = 10
    use_kernel_classifier: bool = True
    execution_mode: str = "auto"
    launch_overhead_trees: float | str = "auto"
    survivor_ema: float = 0.3
    query_exit: QueryExitConfig | None = None
    dense_stage: DenseStage | None = None

    def __post_init__(self) -> None:
        if self.dense_stage is not None and not isinstance(self.dense_stage, DenseStage):
            raise ValueError(f"dense_stage must be a DenseStage: {self.dense_stage}")
        if self.execution_mode not in ("auto", "fused", "staged"):
            raise ValueError(self.execution_mode)
        # Capacity can only ratchet up when peak × headroom passes the
        # current power-of-two bucket: headroom must exceed 1.
        if not (
            self.capacity_headroom > 1.0 and self.top_k >= 1
            and 0.0 < self.survivor_ema <= 1.0
        ):
            raise ValueError(f"invalid ServiceConfig {self}")


@dataclasses.dataclass
class _BucketAdaptState:
    """Adaptive state for ONE padded batch shape ``(Q, D)``."""

    peaks: list[int] | None = None  # running max survivors per stage
    ema: list[float] | None = None  # smoothed survivors per stage
    tail_skip: float | None = None  # smoothed P(the gated tail had no
    #   survivors) — discounts the tail launch in the mode pick


@dataclasses.dataclass(frozen=True)
class _RungState:
    """One installed degradation rung, built once at install time: its
    strategy closures (with the rung's threshold), query-exit config and
    dense stage, so :meth:`RankingService.set_rung` swaps these objects and
    nothing else."""

    name: str
    threshold: float
    strategies: tuple[Callable[..., torch.Tensor], ...]
    query_exit: QueryExitConfig | None
    dense_stage: DenseStage | None


@dataclasses.dataclass
class _Replica:
    """The service's forests on one device: the cascade over the ranker
    and the stage classifiers, in stage order."""

    cascade: CascadeRanker
    classifiers: list[LearClassifier]


@dataclasses.dataclass
class ServiceStats:
    batches: int = 0
    queries: int = 0
    docs: int = 0
    docs_continued: int = 0
    overflow_docs: int = 0
    trees_traversed: float = 0.0
    trees_full_equiv: float = 0.0
    batches_fused: int = 0
    batches_staged: int = 0
    queries_exited: int = 0  # queries query-level exit removed (knob on)
    # Batches per tuple of per-stage compaction capacities (stage k's
    # survivors are compacted into capacities[k] rows; the last is the
    # tail's; a hybrid service's first is the dense gate's).
    capacities: dict[tuple[int, ...], int] = dataclasses.field(default_factory=dict)
    # Rows given to the forest range launches on compacted blocks (each
    # launch's capacity: the tail, a staged middle segment, a hybrid's
    # plain head on the dense gate's block), and those of them at or past
    # their launch's survivor count: the kernel writes them 0 and does no
    # tree work for a document tile wholly past the count. A launch whose
    # count reaches its capacity (overflow) adds none to ``rows_gated``. A
    # batch served in shards counts as the one batch it is.
    rows_compacted: int = 0
    rows_gated: int = 0
    # Pairs the sentinel features' rank compare spans: each stage's
    # classifier ranks its [Q, D] grid, D² pairs a query (the card's fused
    # kernel, or the plain direct compare), or the padded D² of the plain
    # blocked compare (core.features.rank_plan). Host arithmetic on shapes,
    # counted once a batch with the other counters. On the card the count
    # is nominal, a constant of the grid: the fused kernel skips masked
    # rows, so it compares about (real documents) x D pairs.
    rank_pairs: int = 0
    # Batches whose one host read landed in page-locked memory (every batch
    # on the card, none on the CPU).
    reads_pinned: int = 0

    @property
    def speedup(self) -> float:
        return self.trees_full_equiv / max(self.trees_traversed, 1.0)

    @property
    def continue_rate(self) -> float:
        return self.docs_continued / max(self.docs, 1)

    @property
    def query_exit_rate(self) -> float:
        return self.queries_exited / max(self.queries, 1)

    @property
    def gated_share(self) -> float:
        return self.rows_gated / max(self.rows_compacted, 1)


class RankingService:
    """LEAR-cascade ranking over padded ``[Q, D, F]`` request blocks.

    ``extra_classifiers`` make it a multi-sentinel cascade: stages are
    ordered by sentinel and each stage's classifier gates the survivors of
    the previous one. ``device`` (``None`` → the card) is where the forests
    and the dense scorer live and the batches are scored; they are moved
    there once, here.

    Not thread-safe: one thread makes every call that touches the engine
    or its adaptive state (:class:`~repro_torch.serve.batching.ContinuousBatcher`
    keeps to that).

    The keywords after ``device`` are the reference's deprecated
    configuration: without a ``config`` they build one (with a
    ``DeprecationWarning``); with one they raise ``TypeError``.
    """

    def __init__(
        self,
        ensemble: TreeEnsemble,
        classifier: LearClassifier,
        config: ServiceConfig | None = None,
        extra_classifiers: Sequence[LearClassifier] = (),
        *,
        device: str | torch.device | None = None,
        threshold: float | None = None,
        capacity_headroom: float | None = None,
        top_k: int | None = None,
        use_kernel_classifier: bool | None = None,
        execution_mode: str | None = None,
        launch_overhead_trees: float | str | None = None,
        survivor_ema: float | None = None,
        query_exit: QueryExitConfig | None = None,
    ) -> None:
        if config is not None and not isinstance(config, ServiceConfig):
            # Legacy positional call: RankingService(ens, clf, 0.3, …)
            if threshold is not None:
                raise TypeError("RankingService: threshold given twice")
            config, threshold = None, float(config)
        legacy = {
            name: value
            for name, value in (
                ("threshold", threshold),
                ("capacity_headroom", capacity_headroom),
                ("top_k", top_k),
                ("use_kernel_classifier", use_kernel_classifier),
                ("execution_mode", execution_mode),
                ("launch_overhead_trees", launch_overhead_trees),
                ("survivor_ema", survivor_ema),
                ("query_exit", query_exit),
            )
            if value is not None
        }
        if config is None:
            if legacy:
                warnings.warn(_DEPRECATED_SERVICE_MSG, DeprecationWarning, stacklevel=2)
            config = ServiceConfig(**legacy)
        elif legacy:
            raise TypeError(
                "RankingService: pass configuration via ServiceConfig OR the "
                f"deprecated keywords, not both (got {sorted(legacy)})"
            )
        self.config = config
        self.device = resolve_device(device)
        self.ensemble = ensemble.to(self.device)
        self.threshold = config.threshold
        self.headroom = config.capacity_headroom
        self.top_k = config.top_k
        self.use_kernel_classifier = config.use_kernel_classifier
        self.execution_mode = config.execution_mode
        loh = config.launch_overhead_trees
        if loh == "auto":
            loh = calibrate_launch_overhead_trees(self.device)
        self.launch_overhead_trees = float(loh)
        self.survivor_ema = config.survivor_ema
        self.query_exit = config.query_exit
        self.dense_stage = _on_device(config.dense_stage, self.device)
        self.stats = ServiceStats()
        self._adapt: dict[tuple[int, int] | None, _BucketAdaptState] = {}
        self._active_key: tuple[int, int] | None = None

        stages = sorted(
            (
                LearClassifier(forest=c.forest.to(self.device), sentinel=c.sentinel)
                for c in (classifier, *extra_classifiers)
            ),
            key=lambda c: c.sentinel,
        )
        self.stage_classifiers = stages
        self.sentinels = tuple(c.sentinel for c in stages)
        if len(set(self.sentinels)) != len(stages):
            raise ValueError(f"stage sentinels must be distinct: {self.sentinels}")
        self.stage_strategies = [self._make_strategy(k) for k in range(len(stages))]
        # Stage tuples per (strategy closures, dense stage): the same
        # objects every batch of a configuration (and of each rung).
        self._stages_cache: dict[tuple, tuple] = {}
        self.n_stages = len(self.sentinels) + (self.dense_stage is not None)
        # The degradation ladder: None until install_rungs; level 0 is the
        # baseline configuration.
        self._rungs: tuple[_RungState, ...] | None = None
        self._rung_level = 0
        self.cascade = CascadeRanker(
            ensemble=self.ensemble,
            sentinel=stages[0].sentinel,
            strategy=self.stage_strategies[0],
            classifier_trees=stages[0].n_trees,
        )
        # The forests per device a placement serves on: this device's are
        # the service's own; another's are copied at its first batch.
        self._replicas = {self.device: _Replica(self.cascade, stages)}

    def bucket_state(self, Q: int, D: int) -> _BucketAdaptState:
        """Adaptive state for batch shape ``(Q, D)``, created on first use."""
        return self._adapt.setdefault((Q, D), _BucketAdaptState())

    def _active_state(self) -> _BucketAdaptState:
        return self._adapt.setdefault(self._active_key, _BucketAdaptState())

    def _replica(self, device: torch.device) -> _Replica:
        """The forests on ``device``, copied there at first use."""
        rep = self._replicas.get(device)
        if rep is None:
            classifiers = [
                LearClassifier(forest=c.forest.to(device), sentinel=c.sentinel)
                for c in self.stage_classifiers
            ]
            cascade = dataclasses.replace(self.cascade, ensemble=self.ensemble.to(device))
            rep = self._replicas[device] = _Replica(cascade, classifiers)
        return rep

    def _engine_stages(self, device: torch.device) -> tuple:
        """The EngineConfig stage list of the active strategies and dense
        stage on ``device``, built once per triple and reused."""
        key = (tuple(self.stage_strategies), self.dense_stage, device)
        stages = self._stages_cache.get(key)
        if stages is None:
            stages = tuple(
                TreeStage(c.sentinel, strat, classifier_trees=float(c.n_trees))
                for c, strat in zip(self.stage_classifiers, key[0])
            )
            if self.dense_stage is not None:
                stages = (_on_device(self.dense_stage, device), *stages)
            self._stages_cache[key] = stages
        return stages

    def _make_strategy(
        self, k: int, threshold: float | None = None
    ) -> Callable[..., torch.Tensor]:
        # Stage ``k``'s classifier, on the device of the scores it gates.
        # ``None`` reads self.threshold per call (the baseline); a rung
        # passes its own threshold and gets its own closure.
        def strategy(partial, mask, features=None):
            clf = self._replica(partial.device).classifiers[k]
            stage = k + (self.dense_stage is not None)   # its entry in the capacities
            method = rank_plan(partial.shape[1], device=partial.device)[0]
            fused = {"method": method} if method == "fused" else {}
            with span("engine.features", stage=stage, **fused):
                aug = augment_features(features, partial, mask)
            th = self.threshold if threshold is None else threshold
            with span("engine.classifier", stage=stage):
                return clf.continue_mask(aug, mask, th, use_kernel=self.use_kernel_classifier)

        return strategy

    # -- degradation rungs -------------------------------------------------

    @property
    def n_rungs(self) -> int:
        """Installed rung count (baseline included); 0 = no ladder."""
        return 0 if self._rungs is None else len(self._rungs)

    @property
    def rung_level(self) -> int:
        return self._rung_level

    @property
    def rung_names(self) -> tuple[str, ...]:
        return tuple(r.name for r in self._rungs or ())

    def install_rungs(self, rungs: Sequence[ExitRung]) -> None:
        """Materialize the ladder: level 0 is the current configuration,
        level ``i`` applies ``rungs[i-1]``'s overrides (``None`` fields
        inherit the baseline). Each rung's strategy closures are built here,
        once. Install before warmup, which then warms every rung.

        A rung changes thresholds, query exit and the dense keep fraction,
        never the sentinels, so the whole ladder uses one ``padded_forest``
        buffer set per forest: it fits the LRU (``PADDED_CACHE_MAX`` ≥ 1),
        and stepping rungs evicts nothing. A rung's ``dense_keep_frac``
        re-points the dense gate at :func:`dense_keep_fraction` with that
        fraction (same scorer); on a service without a dense stage it
        raises ``ValueError``.
        """
        if self._rungs is not None:
            raise RuntimeError("rungs already installed")
        if self.dense_stage is None and any(r.dense_keep_frac is not None for r in rungs):
            raise ValueError("a rung sets dense_keep_frac but the service has no dense stage")
        ladder = [_RungState(
            "baseline", self.threshold, tuple(self.stage_strategies), self.query_exit,
            self.dense_stage,
        )]
        for rung in rungs:
            if rung.threshold is None:
                th, strategies = self.threshold, ladder[0].strategies
            else:
                th = rung.threshold
                strategies = tuple(
                    self._make_strategy(k, th) for k in range(len(self.stage_classifiers))
                )
            qe = rung.query_exit if rung.query_exit is not None else self.query_exit
            dense = self.dense_stage
            if rung.dense_keep_frac is not None:
                dense = dataclasses.replace(dense, policy=functools.partial(
                    dense_keep_fraction, keep_frac=float(rung.dense_keep_frac),
                ))
            ladder.append(_RungState(rung.name, th, strategies, qe, dense))
        self._rungs = tuple(ladder)

    def set_rung(self, level: int) -> None:
        """Swap the active exit configuration to ``level`` of the ladder
        (prebuilt objects only, nothing is built). Call it from the thread
        that owns the engine (the batcher's worker); the next
        ``rank_batch`` serves the rung."""
        if self._rungs is None:
            raise RuntimeError("install_rungs first")
        if not 0 <= level < len(self._rungs):
            raise ValueError(f"rung {level} of {len(self._rungs)}")
        r = self._rungs[level]
        self._rung_level = level
        self.threshold = r.threshold
        self.stage_strategies = list(r.strategies)
        self.query_exit = r.query_exit
        self.dense_stage = r.dense_stage

    def _cold_start_estimate(self, n_docs: int) -> int:
        # Assume a 40% survivor rate at EVERY stage (survivors only shrink;
        # undersizing a later stage on batch 1 would overflow).
        return int(0.4 * n_docs * self.headroom)

    def _pick_capacities(self, n_docs: int) -> list[int]:
        """Per-stage compaction capacities of the ACTIVE bucket: the running
        survivor peak × headroom, never below the cold-start estimate, in
        powers of two. A stage that overflowed observed a peak equal to its
        capacity, so peak × headroom rounds up to the next bucket. A pinned
        ``dense_stage.capacity`` overrides the dense entry (the engine would
        use it anyway; here the cost model prices the real block)."""
        cold = self._cold_start_estimate(n_docs)
        peaks = self._active_state().peaks
        if peaks is None:
            want = [cold] * self.n_stages
        else:
            want = [max(cold, int(peak * self.headroom)) for peak in peaks]
        caps = [bucket_capacity(w, n_docs) for w in want]
        if self.dense_stage is not None and self.dense_stage.capacity is not None:
            caps[0] = min(int(self.dense_stage.capacity), n_docs)
        return caps

    def _pick_mode(
        self, n_docs: int, capacities: Sequence[int] | None = None
    ) -> str:
        """Fused head vs per-stage tails, picked on the host.

        The reference's host reference pick, unchanged: fused until the
        bucket has observed survivors (and always with one sentinel), then
        the cheaper mode under :func:`progressive_cost_model` on the
        smoothed survivor counts, staged stages priced at block-rounded
        survivors clipped at capacity (``block_b=ENGINE_BLOCK_B``).
        """
        if self.execution_mode != "auto":
            return self.execution_mode
        ema = self._active_state().ema
        if ema is None or len(self.sentinels) == 1:
            return "fused"
        if capacities is None:
            capacities = self._pick_capacities(n_docs)
        dense = self.dense_stage
        cost = {
            m: progressive_cost_model(
                n_docs, ema, self.sentinels, self.ensemble.n_trees, m,
                launch_overhead_trees=self.launch_overhead_trees,
                stage_capacities=capacities,
                block_b=ENGINE_BLOCK_B,
                query_exit_rate=self._query_exit_rate_estimate(),
                dense_cost_trees=float(dense.cost_trees) if dense is not None else 0.0,
                dense_stage=dense is not None,
            )
            for m in ("fused", "staged")
        }
        return "staged" if cost["staged"] < cost["fused"] else "fused"

    def _query_exit_rate_estimate(self) -> float:
        """Smoothed tail-skip rate of the ACTIVE bucket: 0 with query exit
        off or before the bucket's first batch."""
        if self.query_exit is None:
            return 0.0
        return self._active_state().tail_skip or 0.0

    def rank_batch(
        self,
        X: torch.Tensor | np.ndarray,
        mask: torch.Tensor | np.ndarray,
        placement: ServePlacement | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``X: [Q, D, F]`` → (top-k doc indices ``[Q, k]``, scores ``[Q, D]``).

        Everything from submit to the response stays on the devices; the
        only device→host transfer is one copy of one packed tensor, and the
        two arrays are views of it that no later call overwrites.
        ``placement`` puts the operands on the devices, in shards along Q;
        ``None`` is :func:`~repro_torch.serve.placement.single_device`.
        """
        with span("service.rank_batch", Q=int(X.shape[0]), D=int(X.shape[1])):
            return self._rank_batch(X, mask, placement)

    def _rank_batch(
        self, X: torch.Tensor | np.ndarray, mask: torch.Tensor | np.ndarray,
        placement: ServePlacement | None,
    ) -> tuple[np.ndarray, np.ndarray]:
        with span("service.put"):
            shards = (placement or single_device()).put_shards(X, mask, self.device)
        Q = sum(m.shape[0] for _, m in shards)
        D = shards[0][1].shape[1]
        self._active_key = (Q, D)
        n_docs = Q * D
        with span("service.pick") as sp:
            capacities = self._pick_capacities(n_docs)
            mode = self._pick_mode(n_docs, capacities)
            sp.set(capacities=tuple(capacities), mode=mode)
        k = min(self.top_k, D)
        parts, before = [], None
        for i, (Xs, ms) in enumerate(shards):
            top_s, scores_s, stats_s, result = self._rank_shard(
                Xs, ms, mode, capacities, k, before
            )
            parts.append((top_s, scores_s, stats_s))
            if i == 0:   # every shard launches the same: count the batch once
                gated = result.gated_launches
            if i + 1 < len(shards):   # the next shard's survivors_before
                nxt = shards[i + 1][0].device
                before = [
                    _moved(c if before is None else before[j] + c, nxt)
                    for j, c in enumerate(result.survivors)
                ]
        if len(parts) == 1:
            top_idx, scores, stats = parts[0]
        else:
            top_idx, scores, stats = (
                torch.cat([_moved(p[j], self.device) for p in parts])
                for j in range(3)
            )
            stats = stats.reshape(len(parts), -1).sum(0)

        # ONE device read, each value in its own type: the stats (float64,
        # as the counts pass 2**24), the top-k (int64) and the scores
        # (float32), as the bytes of one buffer; the 8-byte fields go first,
        # so every view of it is aligned.
        with span("service.read") as sp:
            packed = device_get(_packed(stats, top_idx, scores))
            pinned = host_pinned(packed)
            sp.set(bytes=packed.nbytes, pinned=pinned)
        with span("service.unpack"):
            return self._unpack(packed, Q, D, k, mode, capacities, gated, pinned)

    def _unpack(
        self, packed: np.ndarray, Q: int, D: int, k: int, mode: str, capacities: list[int],
        gated: tuple[int, ...], pinned: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        """The packed read as (top-k, scores), views of its bytes, with the
        bucket's adaptive state and the service's stats moved by what it
        counted. ``gated``: the cascade's gated launches
        (``CascadeResult.gated_launches``), as entries of ``capacities``;
        ``pinned``: whether the read landed in page-locked memory."""
        T = self.ensemble.n_trees
        S = self.n_stages
        stats, top_idx, scores = _unpacked(packed, S, Q, k, D)
        survivors = stats[:S].astype(np.int64)
        traversed, overflow, batch_docs, q_exited = stats[S:]

        a = self.survivor_ema
        state = self._active_state()
        if state.peaks is None:
            state.peaks = [int(n) for n in survivors]
        else:
            state.peaks = [max(p, int(n)) for p, n in zip(state.peaks, survivors)]
        if state.ema is None:
            state.ema = [float(n) for n in survivors]
        else:
            state.ema = [(1 - a) * e + a * float(n) for e, n in zip(state.ema, survivors)]
        if self.query_exit is not None:
            # No final-stage survivor ⟺ the gated tail did no tree work.
            skipped = float(survivors[-1] == 0)
            state.tail_skip = (
                skipped if state.tail_skip is None
                else (1 - a) * state.tail_skip + a * skipped
            )

        s = self.stats
        s.batches += 1
        s.batches_staged += mode == "staged"
        s.batches_fused += mode != "staged"
        s.capacities[tuple(capacities)] = s.capacities.get(tuple(capacities), 0) + 1
        s.queries += Q
        s.docs += int(batch_docs)
        s.docs_continued += int(survivors[-1])
        s.overflow_docs += int(overflow)
        s.queries_exited += int(q_exited)
        s.trees_traversed += float(traversed)
        s.trees_full_equiv += int(batch_docs) * T
        for j in gated:
            s.rows_compacted += capacities[j]
            s.rows_gated += max(0, capacities[j] - int(survivors[j]))
        s.rank_pairs += len(self.sentinels) * Q * rank_plan(D, device=self.device)[1]
        s.reads_pinned += pinned
        return top_idx, scores

    def _rank_shard(
        self, X: torch.Tensor, mask: torch.Tensor, mode: str, capacities: Sequence[int],
        k: int, before: list[torch.Tensor] | None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, CascadeResult]:
        """The cascade on one shard, on its device: (top-k ``[Qs, k]``,
        scores ``[Qs, D]``, the stats vector, the cascade's result)."""
        dev = X.device
        config = EngineConfig(
            stages=self._engine_stages(dev),
            mode=mode,
            capacities=tuple(capacities),
            query_exit=self.query_exit,
        )
        with span("engine.rank_progressive", mode=mode, stages=config.n_stages):
            result = self._replica(dev).cascade.rank_progressive(
                X, mask, config, features=X, survivors_before=before,
            )
        # Top-k (clamped to D) with the reference's lax.top_k tie-break:
        # the lower index first, which a stable descending sort gives.
        with span("service.topk"):
            masked = torch.where(mask, result.scores, torch.full_like(result.scores, -torch.inf))
            top_idx = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :k]
            exited = result.query_exited
            stats = torch.stack([t.double() for t in (
                *(m.sum() for m in result.stage_masks),
                result.trees_traversed,
                result.overflow,
                mask.sum(),
                exited.sum() if exited is not None else torch.zeros((), device=dev),
            )])
        return top_idx, result.scores, stats, result


@dataclasses.dataclass
class TwoStageCascade:
    """The LEAR-style cascade over arbitrary scorers.

    ``sentinel_fn`` cheaply scores every candidate id; the ``keep_fraction``
    best (at least one) survive; ``full_fn`` scores the survivors. The
    survivors are the cheap scores' top in the reference's ``lax.top_k``
    order: descending, ties to the lower position, which a stable
    descending sort gives (``torch.topk`` promises no order among ties).
    Used for recommendation retrieval (``retrieval_cand``), as in the
    reference's ``examples/cascade_retrieval.py``.
    """

    sentinel_fn: Callable[[torch.Tensor], torch.Tensor]  # ids -> cheap scores
    full_fn: Callable[[torch.Tensor], torch.Tensor]      # ids -> full scores
    keep_fraction: float = 0.05

    def keep(self, n_candidates: int) -> int:
        """Survivors kept of ``n_candidates``."""
        return max(1, int(n_candidates * self.keep_fraction))

    def score(
        self, cand_ids: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``cand_ids [C]`` → (survivor ids ``[k]``, their full scores
        ``[k]``, every candidate's cheap score ``[C]``)."""
        cheap = self.sentinel_fn(cand_ids)
        top_idx = torch.sort(cheap, descending=True, stable=True).indices[
            : self.keep(cand_ids.shape[0])
        ]
        survivors = cand_ids[top_idx]
        return survivors, self.full_fn(survivors), cheap


def _packed(*parts: torch.Tensor) -> torch.Tensor:
    """``parts``, each flattened in its own type, as the bytes of one
    ``uint8`` tensor, in order: one ``cat`` of byte views."""
    return torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])


def _unpacked(
    packed: np.ndarray, S: int, Q: int, k: int, D: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The read of ``_packed(stats, top_idx, scores)`` as views of its
    bytes, no value cast: stats float64 ``[S + 4]``, top-k int64
    ``[Q, k]``, scores float32 ``[Q, D]``."""
    a = 8 * (S + 4)
    b = a + 8 * Q * k
    return (
        packed[:a].view(np.float64),
        packed[a:b].view(np.int64).reshape(Q, k),
        packed[b:].view(np.float32).reshape(Q, D),
    )


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself if it is there, else an asynchronous
    device-to-device copy (ordered after both devices' current streams)."""
    return t if t.device == device else t.to(device, non_blocking=True)


def _on_device(dense: DenseStage | None, device: torch.device) -> DenseStage | None:
    """``dense`` with its scorer on ``device``: a module scorer elsewhere is
    copied there (the caller's module stays where it is); other scorers are
    the caller's to place."""
    if dense is None or not isinstance(dense.scorer, torch.nn.Module):
        return dense
    param = next(dense.scorer.parameters(), None)
    if param is None or param.device == device:
        return dense
    return dataclasses.replace(dense, scorer=copy.deepcopy(dense.scorer).to(device))
