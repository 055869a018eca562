"""Cascade stages as values: :class:`TreeStage` and :class:`EngineConfig`.

The port of :mod:`repro.core.stage`. A :class:`TreeStage` is a
sentinel-segmented tree prefix with its exit policy and survivor capacity;
:class:`EngineConfig` is the frozen, hashable stage list plus the engine
knobs of one progressive step. (The reference's ``launch_overhead_trees``
field prices its in-engine ``mode="auto"`` pick; here the service prices
the pick itself, so the engine has no such field.)

``query_exit`` (a :class:`~repro_torch.core.strategies.QueryExitConfig`)
turns on query-level exit and the gated tail
(:mod:`repro_torch.core.cascade`). Not ported yet, a queued item of
``ROADMAP.md``: the dense/hybrid stage (:class:`DenseStage` exists as a
type, and a config holding one raises ``NotImplementedError``).
``mode="auto"`` is not an engine mode here: eager PyTorch cannot branch on
device data without a sync, so the port picks fused vs staged on the host
(:meth:`repro_torch.serve.ranking_service.RankingService._pick_mode`).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence

import torch

from repro_torch.core.strategies import QueryExitConfig
from repro_torch.kernels.ops import env_int

#: Exit-policy signature: ``(partial [Q, D], alive [Q, D], **kwargs) ->
#: continue mask [Q, D]``; pure and mask-invariant.
Strategy = Callable[..., torch.Tensor]

#: Accounting price of one dense evaluation in doc·tree equivalents (the
#: reference's ``repro.models.dense_scorer.DENSE_COST_TREES``).
DENSE_COST_TREES = env_int("REPRO_DENSE_COST_TREES", 4)

MODES = ("fused", "staged")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (ROADMAP.md, queue A: "
        f"'{what}')"
    )


@dataclasses.dataclass(frozen=True)
class TreeStage:
    """A sentinel-segmented tree-prefix stage.

    ``strategy`` (``None`` → the ranker's default) decides which documents
    continue; ``classifier_trees`` (``None`` → the ranker's default) is the
    per-document accounting cost of that decision; ``capacity`` bounds the
    stage's compacted survivor block (``None`` → the config entry, else the
    bucket default).
    """

    sentinel: int
    strategy: Strategy | None = None
    capacity: int | None = None
    classifier_trees: float | None = None

    def __post_init__(self) -> None:
        if self.sentinel <= 0 or (self.capacity is not None and self.capacity <= 0):
            raise ValueError(f"invalid TreeStage {self}")


@dataclasses.dataclass(frozen=True)
class DenseStage:
    """A dense scorer stage (stage 0 of the reference's hybrid cascade).
    Ported as a type only: an :class:`EngineConfig` holding one raises."""

    scorer: Callable[[torch.Tensor], torch.Tensor]
    policy: Strategy
    capacity: int | None = None
    cost_trees: float = float(DENSE_COST_TREES)


def _as_capacities(
    capacities: Sequence[int] | int | None,
) -> tuple[int, ...] | int | None:
    if capacities is None or isinstance(capacities, int):
        return capacities
    return tuple(int(c) for c in capacities)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen, hashable configuration of one progressive-engine step.

    ``stages`` are :class:`TreeStage` entries with strictly increasing
    sentinels. ``capacities`` (an int for every stage, or one per stage)
    is the config-level survivor bound; a stage's own ``capacity`` wins.
    """

    stages: tuple[TreeStage, ...]
    mode: str = "fused"
    leaf_gather: str = "auto"
    block_t: int = 16
    capacities: tuple[int, ...] | int | None = None
    query_exit: QueryExitConfig | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "stages", tuple(self.stages))
        object.__setattr__(self, "capacities", _as_capacities(self.capacities))
        if any(isinstance(st, DenseStage) for st in self.stages):
            raise _not_ported("dense/hybrid stage")
        if self.mode not in MODES:
            raise ValueError(
                f"mode {self.mode!r} not in {MODES}; the port picks between "
                "them on the host (RankingService._pick_mode)"
            )
        if not self.stages or not all(isinstance(st, TreeStage) for st in self.stages):
            raise ValueError("EngineConfig needs TreeStage entries")
        sents = self.sentinels
        if list(sents) != sorted(set(sents)):
            raise ValueError(f"sentinels must strictly increase: {sents}")
        if isinstance(self.capacities, tuple) and len(self.capacities) != len(self.stages):
            raise ValueError("capacities must have one entry per stage")

    @property
    def sentinels(self) -> tuple[int, ...]:
        return tuple(st.sentinel for st in self.stages)

    @classmethod
    def trees(
        cls,
        sentinels: Sequence[int],
        strategies: Sequence[Strategy | None] | Strategy | None = None,
        *,
        classifier_trees: Sequence[float] | float | None = None,
        capacities: Sequence[int] | int | None = None,
        mode: str = "fused",
        leaf_gather: str = "auto",
        block_t: int = 16,
        query_exit: QueryExitConfig | None = None,
    ) -> EngineConfig:
        """All-trees cascade from parallel sequences."""
        sents = tuple(int(s) for s in sentinels)
        S = len(sents)
        if strategies is None or callable(strategies):
            strategies = (strategies,) * S
        if classifier_trees is None or isinstance(classifier_trees, (int, float)):
            classifier_trees = (classifier_trees,) * S
        if len(strategies) != S or len(classifier_trees) != S:
            raise ValueError("one strategy and classifier cost per sentinel")
        stages = tuple(
            TreeStage(
                sentinel=s,
                strategy=strategies[k],
                classifier_trees=(
                    None if classifier_trees[k] is None else float(classifier_trees[k])
                ),
            )
            for k, s in enumerate(sents)
        )
        return cls(
            stages=stages, mode=mode, leaf_gather=leaf_gather, block_t=block_t,
            capacities=capacities, query_exit=query_exit,
        )
