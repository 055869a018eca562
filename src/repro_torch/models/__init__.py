"""Models of the port: the hybrid cascade's distilled dense scorer."""

from repro_torch.models.dense_scorer import (
    DenseScorer,
    dense_params_from_numpy,
    dense_score,
    init_dense_scorer,
)

__all__ = ["DenseScorer", "dense_params_from_numpy", "dense_score", "init_dense_scorer"]
