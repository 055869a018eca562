"""LEAR: the learned early-exit classifier — its inference half.

The port of the serving side of :mod:`repro.core.lear`: the Continue/Exit
forest reads the query-document features plus the four sentinel-time
features of :mod:`repro_torch.core.features`, and a document continues
when P(Continue) ≥ the confidence threshold. Training (labels, weights,
``train_lear``) is a later slice; a trained classifier comes in through
:meth:`LearClassifier.from_numpy`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.features import N_AUG, augment_features
from repro_torch.forest.ensemble import TreeEnsemble, from_numpy
from repro_torch.kernels.ops import forest_score

__all__ = ["N_AUG", "augment_features", "LearClassifier"]


@dataclasses.dataclass
class LearClassifier:
    """The trained Continue/Exit forest + its sentinel."""

    forest: TreeEnsemble
    sentinel: int

    @classmethod
    def from_numpy(
        cls,
        arrays: dict[str, np.ndarray],
        sentinel: int,
        device: str | torch.device | None = None,
    ) -> LearClassifier:
        """A classifier from the reference forest's fields as numpy arrays
        (see :func:`repro_torch.forest.ensemble.from_numpy`)."""
        return cls(forest=from_numpy(arrays, device), sentinel=int(sentinel))

    @property
    def n_trees(self) -> int:
        return self.forest.n_trees

    def prob_continue(self, X_aug: torch.Tensor) -> torch.Tensor:
        """P(Continue) for augmented features ``[Q, D, F+4]`` → ``[Q, D]``,
        the forest scored through the same kernel as the ranker."""
        Q, D, F = X_aug.shape
        logits = forest_score(self.forest, X_aug.reshape(Q * D, F))
        return torch.sigmoid(logits).reshape(Q, D)

    def continue_mask(
        self, X_aug: torch.Tensor, mask: torch.Tensor, threshold: float
    ) -> torch.Tensor:
        """Continue ⇔ P(Continue) ≥ threshold. Higher = more aggressive EE."""
        return mask & (self.prob_continue(X_aug) >= threshold)
