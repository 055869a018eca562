"""Ranking, classification and cost metrics."""

from repro_torch.metrics.classification import precision_recall
from repro_torch.metrics.ranking import (
    dcg_at_k,
    ideal_dcg_at_k,
    mean_ndcg,
    ndcg_at_k,
    rank_from_scores,
)
from repro_torch.metrics.speedup import speedup_vs_full, trees_traversed

__all__ = [
    "dcg_at_k",
    "ideal_dcg_at_k",
    "ndcg_at_k",
    "rank_from_scores",
    "mean_ndcg",
    "precision_recall",
    "trees_traversed",
    "speedup_vs_full",
]
