"""Sentinel-partitioned cascade execution — early exit as batch compaction.

The port of :mod:`repro.core.cascade`. Three execution paths with the
same ranking semantics:

- :meth:`CascadeRanker.rank` — *reference* path: scores every document
  through head and tail (:func:`~repro_torch.forest.scoring.score_bitvector`)
  and applies the continue mask arithmetically.
- :meth:`CascadeRanker.rank_compacted` — single-sentinel production path:
  only the cumsum-compacted survivors run the tail kernel.
- :meth:`CascadeRanker.rank_progressive` — the multi-stage engine and the
  serving hot path, configured by a frozen
  :class:`~repro_torch.core.stage.EngineConfig`:

  * ``mode="fused"``: one segmented kernel launch over the head trees gives
    every document's prefix score at every sentinel; stage decisions are
    vector work with nested exit masks; one tail launch runs the remaining
    trees on the compacted survivors of the last stage (1 segmented + ≤1
    plain launch; with one sentinel the head is a plain launch).
  * ``mode="staged"``: segment ``k`` runs only on the compacted stage-(k−1)
    survivors, each capacity a real kernel bound (≤S+1 plain launches).

  Both modes build prefixes with the same left-to-right association
  (``seg0 + base``, then ``+ seg_k``), so they are bit-exact with each
  other off overflow, and with the reference.

  With a :class:`~repro_torch.core.stage.DenseStage` at position 0 (the
  hybrid cascade), the dense scorer runs over the whole ``[Q·D, F]`` block,
  its policy prunes, and the survivors are cumsum-compacted into a block of
  the dense capacity; both modes score their tree head on THAT block (so
  they stay bit-exact with each other), stage decisions read the compacted
  prefixes scattered back onto the ``[Q, D]`` grid, and no tree runs for a
  dense-exited document, which keeps its dense score. The dense gate is
  stage 0 of the accounting (a zero sentinel costing ``cost_trees`` per
  candidate) and of query exit (the first tree stage is stage 1).

  With ``config.query_exit`` each stage's document decision is followed by
  :func:`~repro_torch.core.strategies.query_converged`, folded into the
  alive mask (exit flags accumulate; a converged query's documents skip
  every later stage and the tail). The reference moves its tail launch
  under a ``lax.cond`` on the survivor count; here the tail kernel reads
  that count on the device, as every launch on a compacted block does
  (below), so a batch whose queries all converged launches a kernel that
  only writes zeros, and the host never waits. The launch counts ``gated``.

Capacities are sizes known on the host, so the compacted blocks have fixed
shapes and nothing on this path waits for the device: survivors beyond a
capacity keep their stage prefix and are counted in ``overflow``, a 0-dim
device tensor read later with the batch's stats. Every range launch on a
compacted block (the tail, a staged middle segment, the head on the dense
gate's block) passes its compaction's count as ``n_valid``: the kernel
reads it on the device, writes 0 for the padding rows at or past it and
does no tree work for a document tile wholly past it. Those rows are
discarded by the scatter, so the result is the ungated launch's. The
segmented head cannot be gated; it scores every row of its block.
``CascadeResult.gated_launches`` records which compacted blocks were so
scored, and ``CascadeResult.trees_traversed`` the cascade's accounting, so
a caller reads what ran rather than working it out again.

A batch split along its queries into shards (data-parallel serving) keeps
the one-program batch's overflow: ``survivors_before`` gives a shard, per
compaction, the survivors its earlier shards counted there (0-dim device
tensors), and a survivor holds a slot only if that count plus its own
position stays below the capacity, exactly the slots a cumsum over the
whole batch would give. ``CascadeResult.survivors`` returns this call's
counts, which the next shard adds to its ``survivors_before``.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.compaction import (
    COMPACTORS,
    compact_indices_cumsum_masked,
)
from repro_torch.core.stage import DenseStage, EngineConfig
from repro_torch.core.strategies import QueryExitConfig, query_converged
from repro_torch.forest.ensemble import TreeEnsemble, slice_trees
from repro_torch.forest.scoring import score_bitvector
from repro_torch.kernels.ops import (
    PaddedForest,
    forest_score,
    forest_score_range,
    forest_score_segments,
    padded_forest,
)
from repro_torch.metrics.speedup import speedup_vs_full, trees_traversed_progressive
from repro_torch.tracing import span

_DEPRECATED_KWARGS_MSG = (
    "repro_torch.core.cascade.rank_progressive: keyword configuration "
    "(sentinels=…, capacities=…, strategies=…, mode=…) is deprecated; pass an "
    "EngineConfig — e.g. rank_progressive(X, mask, EngineConfig.trees(sentinels=…, …)). "
    "The shim builds the equivalent config and will be removed in a future release."
)


def bucket_capacity(want: int, limit: int, minimum: int = 64) -> int:
    """Power-of-two capacity bucketing, clipped to ``limit``."""
    cap = 1 << int(np.ceil(np.log2(max(want, minimum, 1))))
    return min(cap, limit)


@dataclasses.dataclass
class CascadeResult:
    scores: torch.Tensor          # [Q, D] final scores (exited docs keep the
    #                               prefix of the stage that exited them, the
    #                               dense score for dense-gate exits)
    continue_mask: torch.Tensor   # [Q, D] survivors of the LAST stage
    speedup: float | torch.Tensor  # trees-traversed speedup vs Full (0-dim
    #                                tensor on the progressive path)
    overflow: torch.Tensor | int = 0  # docs beyond capacity (0-dim tensor)
    stage_masks: list | None = None   # progressive: nested alive mask per
    #   stage, the dense gate's first when present
    partials: torch.Tensor | None = None  # progressive: [Q, D, n_stages]
    #   score grid each stage's policy saw (fused all-trees: exact prefixes
    #   for every doc; staged and hybrid: docs already exited hold their
    #   exit-stage score; hybrid slice 0 is the dense score grid)
    mode: str | None = None
    query_exited: torch.Tensor | None = None  # query exit on: [Q] bool, the
    #   queries whose remaining documents query-level exit removed; else None
    survivors: list | None = None  # progressive: each compaction's survivor
    #   count (0-dim tensors) in the order they ran: the dense gate's, the
    #   staged stages', the tail's
    trees_traversed: torch.Tensor | None = None  # progressive: the trees
    #   (and classifier trees) the cascade traversed, 0-dim f32; ``speedup``
    #   is the full ensemble's traversals over it
    gated_launches: tuple[int, ...] = ()  # progressive: per range launch on
    #   a compacted block, gated on its count, in launch order, the entry in
    #   the capacities (and survivor counts) of the stage it compacted


@dataclasses.dataclass
class CascadeRanker:
    ensemble: TreeEnsemble
    sentinel: int
    strategy: Callable[..., torch.Tensor]
    classifier_trees: int = 0   # extra per-doc cost charged for the strategy
    _ht_cache: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def _head_tail(self) -> tuple[TreeEnsemble, TreeEnsemble]:
        # Cached so repeated calls reuse the same sub-ensembles (and their
        # padded-buffer caches).
        if self._ht_cache is None:
            head = slice_trees(self.ensemble, 0, self.sentinel)
            tail = slice_trees(self.ensemble, self.sentinel, self.ensemble.n_trees)
            self._ht_cache = (head, tail)
        return self._ht_cache

    def rank(
        self, X: torch.Tensor, mask: torch.Tensor, **strategy_kwargs: object
    ) -> CascadeResult:
        """Reference path: full compute, masked combine."""
        Q, D, F = X.shape
        flat = X.reshape(Q * D, F)
        head, tail = self._head_tail()
        partial = score_bitvector(head, flat).reshape(Q, D)
        cont = self.strategy(partial, mask, **strategy_kwargs)
        tail_scores = score_bitvector(tail, flat).reshape(Q, D)
        scores = torch.where(cont, partial + tail_scores, partial)
        sp = speedup_vs_full(
            cont, mask, self.sentinel, self.ensemble.n_trees, self.classifier_trees
        )
        return CascadeResult(scores=scores, continue_mask=cont, speedup=sp)

    def rank_compacted(
        self,
        X: torch.Tensor,
        mask: torch.Tensor,
        capacity: int,
        compaction: str = "cumsum",
        **strategy_kwargs: object,
    ) -> CascadeResult:
        """Single-sentinel production path: the tail sees only compacted
        survivors."""
        Q, D, F = X.shape
        head, tail = self._head_tail()
        partial = forest_score(head, X.reshape(Q * D, F)).reshape(Q, D)
        cont = self.strategy(partial, mask, **strategy_kwargs)
        scores, n_cont = _compacted_tail(X, partial, cont, tail, capacity, compaction)
        sp = speedup_vs_full(
            cont, mask, self.sentinel, self.ensemble.n_trees, self.classifier_trees
        )
        return CascadeResult(
            scores=scores, continue_mask=cont, speedup=sp,
            overflow=torch.clamp_min(n_cont - capacity, 0),
        )

    def rank_progressive(
        self,
        X: torch.Tensor,
        mask: torch.Tensor,
        config: EngineConfig | None = None,
        sentinels: Sequence[int] | None = None,
        capacities: Sequence[int] | int | None = None,
        strategies: Sequence[Callable[..., torch.Tensor]] | None = None,
        *,
        classifier_trees: Sequence[float] | float | None = None,
        block_t: int | None = None,
        leaf_gather: str | None = None,
        mode: str | None = None,
        launch_overhead_trees: float | None = None,
        query_exit: QueryExitConfig | None = None,
        survivors_before: Sequence[torch.Tensor] | None = None,
        **strategy_kwargs: object,
    ) -> CascadeResult:
        """Multi-stage engine (see the module docstring).

        A ``TreeStage`` with ``strategy=None`` / ``classifier_trees=None``
        inherits the ranker's defaults. Per-stage capacities resolve as
        stage.capacity → config.capacities entry → :func:`bucket_capacity`
        of ``Q·D``, each clipped to ``Q·D``. ``strategy_kwargs`` are passed
        to every stage's strategy. ``survivors_before`` makes this batch a
        shard of a larger one (see the module docstring); the capacities
        are then the whole batch's.

        The keywords between ``config`` and ``strategy_kwargs`` are the
        reference's deprecated configuration: without a config they build
        ``EngineConfig.trees(...)`` (with a ``DeprecationWarning``; mode
        ``"fused"`` when none is given); with one they raise ``TypeError``.
        ``launch_overhead_trees`` prices the reference's in-engine mode
        pick, which the port makes on the host: it is accepted and unused.
        """
        config = _legacy_config(
            config, sentinels, capacities, strategies, classifier_trees=classifier_trees,
            block_t=block_t, leaf_gather=leaf_gather, mode=mode,
            launch_overhead_trees=launch_overhead_trees, query_exit=query_exit,
        )
        Q, D, F = X.shape
        dense = config.dense
        sentinels = config.sentinels
        S = len(sentinels)
        T = self.ensemble.n_trees
        if not 0 < sentinels[0] or not sentinels[-1] <= T:
            raise ValueError(f"sentinels {sentinels} outside (0, {T}]")
        strategies = tuple(
            st.strategy if st.strategy is not None else self.strategy
            for st in config.tree_stages
        )
        classifier_trees = tuple(
            float(
                st.classifier_trees if st.classifier_trees is not None
                else self.classifier_trees
            )
            for st in config.tree_stages
        )
        conf_caps = config.capacities
        if conf_caps is None or isinstance(conf_caps, int):
            conf_caps = (conf_caps,) * config.n_stages
        default_cap = bucket_capacity(Q * D, Q * D)
        limits = tuple(
            int(st.capacity if st.capacity is not None
                else (c if c is not None else default_cap))
            for st, c in zip(config.stages, conf_caps)
        )
        caps = tuple(min(c, Q * D) for c in limits)
        slots = _Slots(survivors_before)
        has_tail = sentinels[-1] < T
        pf = padded_forest(
            self.ensemble,
            boundaries=sentinels + ((T,) if has_tail else ()),
            block_t=config.block_t,
            leaf_gather=config.leaf_gather,
        )
        flat = X.reshape(Q * D, F)
        qe = config.query_exit
        gate = None
        acct_sentinels, acct_costs = sentinels, classifier_trees
        if dense is not None:
            gate = _dense_gate(dense, flat, mask, caps[0], qe, slots, limits[0])
            acct_sentinels = (0, *sentinels)
            acct_costs = (float(dense.cost_trees), *classifier_trees)
        body = _fused if config.mode == "fused" else _staged
        scores, alive, stage_masks, partials, overflow, exited = body(
            pf, flat, mask, strategies, caps[len(caps) - S:], strategy_kwargs, qe, gate,
            slots, limits[len(limits) - S:],
        )
        if has_tail:
            scores, overflow = _final_tail(
                pf, S, flat, scores, alive, overflow, caps[-1], slots, limits[-1],
                stage=config.n_stages - 1, gated=qe is not None,
            )
        traversed = trees_traversed_progressive(mask, stage_masks, acct_sentinels, T, acct_costs)
        return CascadeResult(
            scores=scores,
            continue_mask=alive,
            speedup=mask.sum() * T / traversed,
            overflow=overflow,
            stage_masks=stage_masks,
            partials=partials,
            mode=config.mode,
            query_exited=exited if qe is not None else None,
            survivors=slots.counts,
            trees_traversed=traversed,
            gated_launches=tuple(slots.launched),
        )


def _legacy_config(
    config: EngineConfig | Sequence[int] | None,
    sentinels: Sequence[int] | None,
    capacities: Sequence[int] | int | None,
    strategies: Sequence[Callable[..., torch.Tensor]] | None,
    **kwargs: object,
) -> EngineConfig:
    """``config``, or the one the deprecated keywords describe."""
    if config is not None and not isinstance(config, EngineConfig):
        # Legacy positional call: rank_progressive(X, mask, [10, 20], …)
        if sentinels is not None:
            raise TypeError("rank_progressive: sentinels given twice")
        config, sentinels = None, config
    legacy = {
        name: value
        for name, value in (
            ("sentinels", sentinels), ("capacities", capacities),
            ("strategies", strategies), *kwargs.items(),
        )
        if value is not None
    }
    if config is not None:
        if legacy:
            raise TypeError(
                "rank_progressive: pass configuration via EngineConfig OR the "
                f"deprecated keywords, not both (got {sorted(legacy)})"
            )
        return config
    if sentinels is None:
        raise TypeError(
            "rank_progressive needs an EngineConfig (or the deprecated sentinels=… keywords)"
        )
    warnings.warn(_DEPRECATED_KWARGS_MSG, DeprecationWarning, stacklevel=3)
    mode, leaf_gather, block_t = kwargs["mode"], kwargs["leaf_gather"], kwargs["block_t"]
    return EngineConfig.trees(
        sentinels,
        strategies,
        classifier_trees=kwargs["classifier_trees"],
        capacities=capacities,
        mode=mode if mode is not None else "fused",
        leaf_gather=leaf_gather if leaf_gather is not None else "auto",
        block_t=block_t if block_t is not None else 16,
        query_exit=kwargs["query_exit"],
    )


@dataclasses.dataclass
class _Slots:
    """The compactions of one call, in the order they run. ``before``: a
    shard's per-compaction survivor counts of the shards ahead of it
    (``None`` for a whole batch); ``counts``: this call's; ``launched``:
    the stage of each compacted block a gated range launch scored
    (:func:`_gated_range`)."""

    before: Sequence[torch.Tensor] | None
    counts: list = dataclasses.field(default_factory=list)
    launched: list = dataclasses.field(default_factory=list)

    def take(
        self, cont: torch.Tensor, cap: int, limit: int, stage: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Compact ``cont`` into ``cap`` slots: ``(sel, n_valid, within,
        overflow)``, where slots below ``n_valid`` hold survivors (for a
        whole batch ``n_valid`` is the survivor count, which may pass
        ``cap``) and ``limit`` is the whole batch's capacity. ``stage``:
        the stage whose survivors these are (its entry in the capacities)."""
        i = len(self.counts)
        with span("engine.compact", stage=stage, rows=cap):
            if self.before is None:
                sel, n_cont, within = compact_indices_cumsum_masked(cont, cap)
                self.counts.append(n_cont)
                return sel, n_cont, within, torch.clamp_min(n_cont - cap, 0)
            left = torch.clamp_min(limit - self.before[i], 0)
            sel, n_cont, within = compact_indices_cumsum_masked(cont, cap, left)
            self.counts.append(n_cont)
            n_valid = torch.minimum(n_cont, left)
            return sel, n_valid, within, n_cont - n_valid


@dataclasses.dataclass(frozen=True)
class _Gate:
    """The dense gate's outcome: its score grid, the alive mask and exit
    flags after it, its overflow, and the compacted survivor block
    (``sel`` rows of the flat block, ``n_cont`` survivors)."""

    scores: torch.Tensor
    alive: torch.Tensor
    exited: torch.Tensor
    overflow: torch.Tensor
    sel: torch.Tensor
    n_cont: torch.Tensor


def _dense_gate(
    dense: DenseStage, flat: torch.Tensor, mask: torch.Tensor, cap: int,
    qe: QueryExitConfig | None, slots: _Slots, limit: int,
) -> _Gate:
    """Stage 0 of a hybrid cascade: score every candidate densely, prune
    with the stage's policy, fold in query exit at stage 0, and compact the
    survivors into a block of ``cap`` rows (those beyond it keep the dense
    score and count as overflow)."""
    Q, D = mask.shape
    with torch.no_grad():
        scores = dense.scorer(flat).reshape(Q, D).float()
    alive = mask & dense.policy(scores, mask)
    exited = torch.zeros(Q, dtype=torch.bool, device=flat.device)
    alive, exited = _apply_query_exit(qe, 0, scores, alive, exited)
    sel, n_cont, within, overflow = slots.take(alive.reshape(Q * D), cap, limit, stage=0)
    return _Gate(
        scores=scores,
        alive=alive & within.reshape(Q, D),
        exited=exited,
        overflow=overflow,
        sel=sel,
        n_cont=n_cont,
    )


def _scatter(
    vec: torch.Tensor, sel: torch.Tensor, n_valid: torch.Tensor, shape: tuple[int, int]
) -> torch.Tensor:
    """A compacted block's per-row values on the ``[Q, D]`` grid of
    ``shape``, 0 where no valid slot lands. Valid slots hold distinct
    indices, so a plain scatter places each value without atomics; padding
    slots go to a discarded extra element."""
    n = shape[0] * shape[1]
    valid = torch.arange(sel.shape[0], device=sel.device) < n_valid
    idx = torch.where(valid, sel, torch.full_like(sel, n))
    grid = torch.zeros(n + 1, dtype=torch.float32, device=vec.device)
    grid.scatter_(0, idx, vec.float())
    return grid[:n].reshape(shape)


def _gated_range(
    pf: PaddedForest, flat: torch.Tensor, sel: torch.Tensor, n_valid: torch.Tensor,
    seg_lo: int, seg_hi: int | None, slots: _Slots, stage: int, count_as: str = "plain",
) -> torch.Tensor:
    """One range launch over segments ``[seg_lo, seg_hi)`` on the compacted
    block ``flat[sel]``, gated on its compaction's count ``n_valid`` (as the
    one-element int32 the kernel reads); records ``stage``, the compaction's
    entry in the capacities, in ``slots.launched``."""
    slots.launched.append(stage)
    return forest_score_range(
        pf, flat[sel], seg_lo, seg_hi, count_as=count_as, n_valid=n_valid.to(torch.int32),
    )


def _apply_query_exit(
    qe: QueryExitConfig | None, k: int, prefix: torch.Tensor,
    alive: torch.Tensor, exited: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold stage ``k``'s per-query convergence into the alive mask; exit
    flags accumulate, so a converged query never re-enters."""
    if qe is None or k < qe.from_stage:
        return alive, exited
    exited = exited | query_converged(prefix, alive, k=qe.k, margin=qe.margin)
    return alive & ~exited[:, None], exited


def _head_prefixes(
    pf: PaddedForest, flat: torch.Tensor, S: int, gate: _Gate | None, slots: _Slots,
) -> list[torch.Tensor]:
    """Prefix scores at each of the first ``S`` sentinels from one head
    launch (a plain one for ``S == 1``) on every row of ``flat``, or on the
    dense gate's block: ``seg0 + base``, then ``+ seg_k`` left to right. On
    the gate's block the plain launch is gated on its count (the segmented
    one cannot be)."""
    rows = flat.shape[0] if gate is None else gate.sel.shape[0]
    with span("engine.head", rows=rows, trees=pf.boundaries[S - 1]):
        if S == 1 and gate is not None:
            return [_gated_range(pf, flat, gate.sel, gate.n_cont, 0, 1, slots, stage=0)]
        if S == 1:
            return [forest_score_range(pf, flat, 0, 1)]
        seg = forest_score_segments(pf, flat if gate is None else flat[gate.sel], n_segments=S)
        acc = seg[:, 0] + pf.base_score
        prefixes = [acc]
        for k in range(1, S):
            acc = acc + seg[:, k]
            prefixes.append(acc)
        return prefixes


# What a stage body returns: scores, the last stage's alive mask, the
# per-stage masks, the prefix grids, overflow and the exit flags.
_StageOut = tuple[
    torch.Tensor, torch.Tensor, list, torch.Tensor, torch.Tensor, torch.Tensor
]


def _fused(
    pf: PaddedForest, flat: torch.Tensor, mask: torch.Tensor,
    strategies: tuple[Callable[..., torch.Tensor], ...], caps: tuple[int, ...],
    skw: dict, qe: QueryExitConfig | None, gate: _Gate | None,
    slots: _Slots, limits: tuple[int, ...],
) -> _StageOut:
    """All prefixes from one head launch (on the dense gate's block when
    there is one); stage decisions as vector work."""
    Q, D = mask.shape
    S = len(strategies)
    vecs = _head_prefixes(pf, flat, S, gate, slots)
    if gate is None:
        alive = mask
        exited = torch.zeros(Q, dtype=torch.bool, device=flat.device)
        overflow = torch.zeros((), dtype=torch.long, device=flat.device)
        scores, grids, stage_masks, k0 = None, [], [], 0
    else:
        alive, exited, overflow = gate.alive, gate.exited, gate.overflow
        scores, grids, stage_masks, k0 = gate.scores, [gate.scores], [gate.alive], 1
    for k in range(S):
        if gate is None:
            grid = vecs[k].reshape(Q, D)
        else:
            grid = torch.where(
                alive, _scatter(vecs[k], gate.sel, gate.n_cont, mask.shape), grids[-1]
            )
        scores = grid if scores is None else torch.where(alive, grid, scores)
        alive = alive & strategies[k](grid, alive, **skw)
        alive, exited = _apply_query_exit(qe, k + k0, grid, alive, exited)
        stage_masks.append(alive)
        grids.append(grid)
    return scores, alive, stage_masks, torch.stack(grids, dim=-1), overflow, exited


def _staged(
    pf: PaddedForest, flat: torch.Tensor, mask: torch.Tensor,
    strategies: tuple[Callable[..., torch.Tensor], ...], caps: tuple[int, ...],
    skw: dict, qe: QueryExitConfig | None, gate: _Gate | None,
    slots: _Slots, limits: tuple[int, ...],
) -> _StageOut:
    """Segment k scored only on the compacted stage-(k−1) survivors; the
    first segment on the whole block, or on the dense gate's block (the
    rows the fused head scores, so the modes stay bit-exact)."""
    Q, D = mask.shape
    S = len(strategies)
    seg0 = _head_prefixes(pf, flat, 1, gate, slots)[0]
    if gate is None:
        alive = mask
        exited = torch.zeros(Q, dtype=torch.bool, device=flat.device)
        overflow = torch.zeros((), dtype=torch.long, device=flat.device)
        prefix = seg0.reshape(Q, D)
        prefixes, stage_masks, k0 = [prefix], [], 0
    else:
        alive, exited, overflow = gate.alive, gate.exited, gate.overflow
        prefix = torch.where(alive, _scatter(seg0, gate.sel, gate.n_cont, mask.shape), gate.scores)
        prefixes, stage_masks, k0 = [gate.scores, prefix], [alive], 1
    for k in range(S):
        alive = alive & strategies[k](prefix, alive, **skw)
        alive, exited = _apply_query_exit(qe, k + k0, prefix, alive, exited)
        if k + 1 < S:
            sel, n_cont, within, over = slots.take(
                alive.reshape(Q * D), caps[k], limits[k], stage=k + k0
            )
            overflow = overflow + over
            alive = alive & within.reshape(Q, D)
            with span("engine.middle", stage=k + 1 + k0, rows=caps[k],
                      trees=pf.boundaries[k + 1] - pf.boundaries[k]):
                seg_sel = _gated_range(pf, flat, sel, n_cont, k + 1, k + 2, slots, stage=k + k0)
                prefix = torch.where(
                    alive, prefix + _scatter(seg_sel, sel, n_cont, mask.shape), prefix
                )
            prefixes.append(prefix)
        stage_masks.append(alive)
    return prefix, alive, stage_masks, torch.stack(prefixes, dim=-1), overflow, exited


def _final_tail(
    pf: PaddedForest, S: int, flat: torch.Tensor, scores: torch.Tensor,
    alive: torch.Tensor, overflow: torch.Tensor, cap: int, slots: _Slots, limit: int,
    stage: int, gated: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tail launch on the compacted survivors of the last stage (its
    entry in the capacities: ``stage``), gated on their count like every
    compacted launch. ``gated`` (query exit on) counts the launch as the
    reference's gated tail, which may find no survivor at all."""
    with span("engine.tail", rows=cap, trees=pf.boundaries[-1] - pf.boundaries[S - 1]):
        sel, n_cont, _, over = slots.take(alive.reshape(-1), cap, limit, stage=stage)
        tail_sel = _gated_range(
            pf, flat, sel, n_cont, S, None, slots, stage, count_as="gated" if gated else "plain",
        )
        return scores + _scatter(tail_sel, sel, n_cont, scores.shape), overflow + over


def _compacted_tail(
    X: torch.Tensor,
    partial: torch.Tensor,
    cont: torch.Tensor,
    tail: TreeEnsemble,
    capacity: int,
    compaction: str = "cumsum",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather survivors → block of ``capacity`` → tail kernel → scatter."""
    Q, D, F = X.shape
    sel, n_cont = COMPACTORS[compaction](cont.reshape(Q * D), capacity)
    tail_sel = forest_score(tail, X.reshape(Q * D, F)[sel])
    return partial + _scatter(tail_sel, sel, n_cont, partial.shape), n_cont

