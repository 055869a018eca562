"""Cascade stages as values: :class:`TreeStage`, :class:`DenseStage` and
:class:`EngineConfig`.

The port of :mod:`repro.core.stage`. Both stage kinds satisfy the
:class:`CascadeStage` protocol (a ``capacity`` and a ``stage_cost_trees``).
A :class:`TreeStage` is a
sentinel-segmented tree prefix with its exit policy and survivor capacity.
A :class:`DenseStage` is the hybrid cascade's stage 0: a dense scorer
(:mod:`repro_torch.models.dense_scorer`) over the whole ``[Q·D, F]``
block, whose policy prunes the easy majority before any tree runs.
:class:`EngineConfig` is the frozen, hashable stage list plus the engine
knobs of one progressive step. (The reference's ``launch_overhead_trees``
field prices its in-engine ``mode="auto"`` pick; here the service prices
the pick itself, so the engine has no such field.)

``query_exit`` (a :class:`~repro_torch.core.strategies.QueryExitConfig`)
turns on query-level exit and the gated tail
(:mod:`repro_torch.core.cascade`). ``mode="auto"`` is not an engine mode
here: eager PyTorch cannot branch on device data without a sync, so the
port picks fused vs staged on the host
(:meth:`repro_torch.serve.ranking_service.RankingService._pick_mode`).
Stages compare their callables by identity, as in the reference: build a
scorer and a policy closure once per configuration and reuse them.
"""

from __future__ import annotations

import dataclasses
import typing
from collections.abc import Callable, Sequence

import torch

from repro_torch.core.strategies import QueryExitConfig
from repro_torch.models.dense_scorer import DENSE_COST_TREES

#: Exit-policy signature: ``(partial [Q, D], alive [Q, D], **kwargs) ->
#: continue mask [Q, D]``; pure and mask-invariant.
Strategy = Callable[..., torch.Tensor]

#: Dense scorer signature: ``[B, F] float32 -> [B]`` scores (a
#: :class:`~repro_torch.models.dense_scorer.DenseScorer` module is one).
DenseScorer = Callable[[torch.Tensor], torch.Tensor]

MODES = ("fused", "staged")


@typing.runtime_checkable
class CascadeStage(typing.Protocol):
    """One stage of the progressive cascade: scorer + exit policy + capacity.

    ``capacity`` bounds the compacted survivor block handed to the next
    stage (``None`` defers to :class:`EngineConfig` / the bucket default);
    ``stage_cost_trees`` is the per-document accounting charge of the
    stage's policy or scorer in doc·tree traversals — the LEAR classifier's
    trees for a :class:`TreeStage`, ``cost_trees`` for a :class:`DenseStage`.
    """

    capacity: int | None

    @property
    def stage_cost_trees(self) -> float:
        """Per-document accounting charge, in tree-traversal equivalents."""
        ...


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

    @property
    def stage_cost_trees(self) -> float:
        return float(self.classifier_trees or 0.0)


@dataclasses.dataclass(frozen=True)
class DenseStage:
    """A dense (non-tree) scorer stage: stage 0 of the hybrid cascade.

    ``scorer`` maps the flat ``[B, F]`` block to ``[B]`` scores (e.g. a
    :class:`~repro_torch.models.dense_scorer.DenseScorer`); ``policy`` is
    called as ``policy(scores [Q, D], mask [Q, D])`` with no strategy
    kwargs (close knobs over it, e.g.
    ``functools.partial(dense_keep_fraction, keep_frac=0.35)``). Documents
    the policy exits keep the dense score as their final score.
    ``cost_trees`` prices one dense evaluation in doc·tree equivalents;
    ``capacity`` bounds the compacted survivor block the tree stages run
    on, a real kernel block bound in both modes.
    """

    scorer: DenseScorer
    policy: Strategy
    capacity: int | None = None
    cost_trees: float = float(DENSE_COST_TREES)

    def __post_init__(self) -> None:
        if self.capacity is not None and self.capacity <= 0:
            raise ValueError(f"DenseStage capacity must be positive: {self.capacity}")
        if self.cost_trees < 0.0:
            raise ValueError(f"DenseStage cost_trees must be >= 0: {self.cost_trees}")

    @property
    def stage_cost_trees(self) -> float:
        return float(self.cost_trees)


def _as_capacities(
    capacities: Sequence[int] | int | None,
) -> tuple[int, ...] | int | None:
    if capacities is None or isinstance(capacities, int):
        return capacities
    return tuple(int(c) for c in capacities)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen, hashable configuration of one progressive-engine step.

    ``stages`` holds at most one :class:`DenseStage`, only at position 0,
    then :class:`TreeStage` entries with strictly increasing sentinels.
    ``capacities`` (an int for every stage, or one entry per stage, the
    dense stage included) is the config-level survivor bound; a stage's own
    ``capacity`` wins.
    """

    stages: tuple[TreeStage | DenseStage, ...]
    mode: str = "fused"
    leaf_gather: str = "auto"
    block_t: int = 16
    capacities: tuple[int, ...] | int | None = None
    query_exit: QueryExitConfig | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "stages", tuple(self.stages))
        object.__setattr__(self, "capacities", _as_capacities(self.capacities))
        if self.mode not in MODES:
            raise ValueError(
                f"mode {self.mode!r} not in {MODES}; the port picks between "
                "them on the host (RankingService._pick_mode)"
            )
        for i, st in enumerate(self.stages):
            if isinstance(st, DenseStage):
                if i != 0:
                    raise ValueError("DenseStage is only supported as stage 0")
            elif not isinstance(st, TreeStage):
                raise ValueError(f"stage {i} is neither a TreeStage nor a DenseStage: {st}")
        sents = self.sentinels
        if not sents:
            raise ValueError("EngineConfig needs at least one TreeStage")
        if list(sents) != sorted(set(sents)):
            raise ValueError(f"sentinels must strictly increase: {sents}")
        if isinstance(self.capacities, tuple) and len(self.capacities) != len(self.stages):
            raise ValueError("capacities must have one entry per stage")

    @property
    def dense(self) -> DenseStage | None:
        """The dense stage-0 gate, or ``None`` for an all-trees cascade."""
        first = self.stages[0]
        return first if isinstance(first, DenseStage) else None

    @property
    def tree_stages(self) -> tuple[TreeStage, ...]:
        return tuple(st for st in self.stages if isinstance(st, TreeStage))

    @property
    def sentinels(self) -> tuple[int, ...]:
        return tuple(st.sentinel for st in self.tree_stages)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

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

    @classmethod
    def hybrid(
        cls,
        dense: DenseStage,
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
        """Dense stage 0 + tree stages from parallel sequences.
        ``capacities`` covers the TREE stages (as in :meth:`trees`); the
        dense bound is ``dense.capacity``, else the last tree entry of a
        sequence (the reference's rule), else the bucket default."""
        base = cls.trees(
            sentinels, strategies, classifier_trees=classifier_trees,
            mode=mode, leaf_gather=leaf_gather, block_t=block_t, query_exit=query_exit,
        )
        caps = _as_capacities(capacities)
        if isinstance(caps, tuple):
            caps = (dense.capacity if dense.capacity is not None else caps[-1], *caps)
        return dataclasses.replace(base, stages=(dense, *base.stages), capacities=caps)
