"""Tree ensembles in QuickScorer layout, their reference scorers, and GBDT
training (binning, λ-MART, learned tree reordering)."""

from repro_torch.forest.binning import apply_bins, quantile_bins
from repro_torch.forest.ensemble import TreeEnsemble, concat_ensembles, slice_trees
from repro_torch.forest.gbdt import GBDTParams, train_gbdt, train_lambdamart
from repro_torch.forest.reorder import learn_order, reorder_trees, reordered_ensemble
from repro_torch.forest.scoring import (
    partial_scores,
    score_bitvector,
    score_level,
    score_numpy_oracle,
)

__all__ = [
    "TreeEnsemble",
    "slice_trees",
    "concat_ensembles",
    "score_bitvector",
    "score_level",
    "score_numpy_oracle",
    "partial_scores",
    "learn_order",
    "reorder_trees",
    "reordered_ensemble",
    "quantile_bins",
    "apply_bins",
    "GBDTParams",
    "train_gbdt",
    "train_lambdamart",
]
