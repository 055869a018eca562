"""Scoring-cost accounting in the paper's own currency: trees traversed.

The port of :mod:`repro.metrics.speedup` (the run-time accounting and the
host cost model, with the hybrid cascade's dense terms; the reference's
traced device mirror of the cost model is not needed — the port picks the
execution mode on the host). One unit is
one *document·tree traversal*: a document exiting at sentinel ``s`` costs
``s`` trees, a continuing one all ``n_trees``, and every classifier
evaluation ``classifier_trees``.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch

from repro_torch.kernels.ops import effective_block_b as _stage_block


def _sane_survivors(
    stage_survivors: Sequence[float], n_docs: float
) -> list[float]:
    """Clamp survivor estimates to ``[0, n_docs]``; NaN → 0, ±inf → the
    bound they exceed, so the mode pick never compares NaN costs."""
    out = []
    for s in stage_survivors:
        s = float(s)
        if math.isnan(s):
            s = 0.0
        out.append(min(max(s, 0.0), n_docs))
    return out


def trees_traversed(
    continue_mask: torch.Tensor,
    mask: torch.Tensor,
    sentinel: int,
    n_trees: int,
    classifier_trees: int = 0,
) -> torch.Tensor:
    """Total tree traversals for one EE configuration. Arrays are [Q, D]."""
    n_docs = mask.sum()
    n_cont = (continue_mask & mask).sum()
    return (
        n_docs * (sentinel + classifier_trees) + n_cont * (n_trees - sentinel)
    ).float()


def speedup_vs_full(
    continue_mask: torch.Tensor,
    mask: torch.Tensor,
    sentinel: int,
    n_trees: int,
    classifier_trees: int = 0,
) -> float:
    """Single-sentinel speedup vs scoring every tree (host float)."""
    ee = trees_traversed(continue_mask, mask, sentinel, n_trees, classifier_trees)
    return float(mask.sum() * n_trees / ee)


def trees_traversed_progressive(
    mask: torch.Tensor,
    stage_masks: Sequence[torch.Tensor],
    sentinels: Sequence[int],
    n_trees: int,
    classifier_trees: float | Sequence[float] = 0,
) -> torch.Tensor:
    """Total tree traversals of a multi-sentinel cascade (0-dim f32).

    ``stage_masks[k]`` is the nested continue mask after stage ``k``'s
    decision at ``sentinels[k]``. A document exiting at stage ``k`` costs
    ``sentinels[k-1]`` trees plus one classifier evaluation per stage it
    reached; survivors of the last stage cost all ``n_trees``. A hybrid
    cascade passes its dense gate as a zero sentinel costing
    ``dense_cost_trees``: ``sentinels = (0, *tree_sents)``,
    ``classifier_trees = (dense_cost_trees, *tree_costs)``.
    """
    S = len(sentinels)
    if isinstance(classifier_trees, (int, float)):
        classifier_trees = [classifier_trees] * S
    if len(classifier_trees) != S:
        raise ValueError("one classifier cost per sentinel")
    alive = mask
    prev_s = 0
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for s, cont, ct in zip(sentinels, stage_masks, classifier_trees):
        n_alive = alive.sum()
        total = total + (n_alive * (s - prev_s) + n_alive * ct)
        alive = cont & alive
        prev_s = s
    return total + alive.sum() * (n_trees - prev_s)


def speedup_progressive(
    mask: torch.Tensor,
    stage_masks: Sequence[torch.Tensor],
    sentinels: Sequence[int],
    n_trees: int,
    classifier_trees: float | Sequence[float] = 0,
) -> torch.Tensor:
    """Speedup vs scoring every tree, as a 0-dim device tensor (no sync)."""
    full = mask.sum() * n_trees
    return full / trees_traversed_progressive(
        mask, stage_masks, sentinels, n_trees, classifier_trees
    )


def progressive_cost_model(
    n_docs: float,
    stage_survivors: Sequence[float],
    sentinels: Sequence[int],
    n_trees: int,
    mode: str,
    launch_overhead_trees: float = 0.0,
    stage_capacities: Sequence[int] | None = None,
    block_b: int = 1,
    query_exit_rate: float = 0.0,
    dense_cost_trees: float = 0.0,
    dense_stage: bool = False,
) -> float:
    """Estimated device cost of one progressive batch, in tree-traversal
    equivalents, for picking fused vs per-stage-tail execution (host
    arithmetic only, never syncs).

    Fused scores every document through all ``sentinels[-1]`` head trees
    in one segmented launch; staged scores segment ``k`` only on the
    stage-(k−1) survivors — rounded up to the effective doc block
    (``block_b``, 1 disables the rounding) and clipped at the stage
    capacity — but pays ``launch_overhead_trees`` per extra launch. Both
    run the same compacted tail; ``query_exit_rate`` discounts its launch.

    ``dense_stage=True`` prices a hybrid cascade: ``stage_survivors`` and
    ``stage_capacities`` (then required) carry a leading dense entry, every
    candidate is charged ``dense_cost_trees``, and both modes' tree head is
    priced at the dense capacity (the kernels score the whole compacted
    block). The dense terms are the same in both modes.
    """
    S = len(sentinels)
    n_stages = S + 1 if dense_stage else S
    if mode not in ("fused", "staged") or len(stage_survivors) != n_stages:
        raise ValueError((mode, len(stage_survivors), n_stages))
    n_docs = max(float(n_docs), 0.0)
    surv = _sane_survivors(stage_survivors, n_docs)
    caps = list(stage_capacities) if stage_capacities is not None else None
    dense_term = 0.0
    head_docs = n_docs
    if dense_stage:
        if caps is None or len(caps) != n_stages:
            raise ValueError(("one capacity per stage, the dense one first", caps))
        dense_term = n_docs * float(dense_cost_trees)
        head_docs = float(caps[0])
        caps, surv = caps[1:], surv[1:]
    has_tail = sentinels[-1] < n_trees
    qe = min(max(float(query_exit_rate), 0.0), 1.0)
    tail_launch = (1.0 - qe) if has_tail else 0.0
    tail = surv[-1] * (n_trees - sentinels[-1])
    if mode == "fused":
        head = head_docs * sentinels[-1]
        launches = 1 + tail_launch
    else:
        if caps is None:
            caps = [n_docs] * S
        if len(caps) != S:
            raise ValueError(("one capacity per stage", caps))
        if block_b > 1:
            surv = [
                math.ceil(s / _stage_block(block_b, c)) * _stage_block(block_b, c)
                for c, s in zip(caps, surv)
            ]
        surv = [min(float(c), float(s)) for c, s in zip(caps, surv)]
        head = head_docs * sentinels[0] + sum(
            surv[k] * (sentinels[k + 1] - sentinels[k]) for k in range(S - 1)
        )
        launches = S + tail_launch
    return float(dense_term + head + tail + launch_overhead_trees * launches)
