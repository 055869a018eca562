"""The LEAR cascade: features, strategies, compaction, stages, classifier
training and inference, engine."""

from repro_torch.core.cascade import CascadeRanker, CascadeResult, bucket_capacity
from repro_torch.core.compaction import compact_indices_argsort, compact_indices_cumsum
from repro_torch.core.features import augment_features
from repro_torch.core.lear import (
    LearClassifier,
    build_continue_labels,
    instance_weights,
    train_lear,
)
from repro_torch.core.stage import DenseStage, EngineConfig, TreeStage
from repro_torch.core.strategies import (
    QueryExitConfig,
    dense_keep_fraction,
    ept_continue,
    ert_continue,
    ideal_continue,
    query_converged,
)

__all__ = [
    "TreeStage",
    "DenseStage",
    "EngineConfig",
    "QueryExitConfig",
    "ert_continue",
    "ept_continue",
    "dense_keep_fraction",
    "ideal_continue",
    "query_converged",
    "LearClassifier",
    "augment_features",
    "build_continue_labels",
    "instance_weights",
    "train_lear",
    "CascadeRanker",
    "CascadeResult",
    "bucket_capacity",
    "compact_indices_cumsum",
    "compact_indices_argsort",
]
