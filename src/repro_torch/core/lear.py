"""LEAR: the learned early-exit classifier (the paper's §2 contribution).

The port of :mod:`repro.core.lear`. Training, against a frozen λ-MART
ranker:

1. Score the classifier-training split through the ranker: the partial
   score after the sentinel's first ``s`` trees and the full score.
2. **Labels** — ``Continue`` = relevant (label > 0) AND in the full
   ranking's top-``k`` (k = 15); everything else is ``Exit``.
3. **Augmented representation** — the query-document features plus the
   four sentinel-time features of :mod:`repro_torch.core.features`, the
   same code the serving cascade runs.
4. **Cost-sensitive weights** — ``w_d = 2^{r_d} / f_q(l_d)`` with ``f_q``
   the per-query frequency of the document's Continue/Exit label.
5. **Classifier** — a 10-tree GBDT minimizing weighted logistic loss
   (:func:`repro_torch.forest.gbdt.train_gbdt`).

At serving time a document continues when P(Continue) ≥ the confidence
threshold. A classifier comes out of :func:`train_lear` or, from the
reference's arrays, :meth:`LearClassifier.from_numpy`.

One deliberate difference from the reference: step 1 scores through the
port's kernel path — ``padded_forest(ranker, boundaries=(sentinel, T))``
and one :func:`repro_torch.kernels.ops.forest_score_segments` launch, with
``partial = seg₀ + base`` and ``full = seg₀ + seg₁ + base`` — where the
reference sums ``score_bitvector(..., return_per_tree=True)``. Its
``[B, T, N]`` masks would take ~27 GB at full width (51,200 rows × 1,047
trees × 63 nodes × 8 B), and the classifier is trained on exactly the
partial scores that serving computes. The two agree bit for bit with the
reference's segmented Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.features import N_AUG, augment_features
from repro_torch.forest.ensemble import TreeEnsemble, from_numpy
from repro_torch.forest.gbdt import GBDTParams, train_gbdt
from repro_torch.forest.scoring import score_bitvector
from repro_torch.kernels.ops import forest_score, forest_score_segments, padded_forest
from repro_torch.metrics.ranking import rank_from_scores

__all__ = [
    "N_AUG",
    "augment_features",
    "build_continue_labels",
    "instance_weights",
    "sentinel_scores",
    "continue_training_set",
    "LearClassifier",
    "train_lear",
]


def build_continue_labels(
    full_scores: torch.Tensor,  # [Q, D] scores of the complete ensemble
    rel_labels: torch.Tensor,   # [Q, D] graded relevance
    mask: torch.Tensor,
    k: int = 15,
) -> torch.Tensor:
    """Continue = relevant AND in the full ensemble's top-k (paper §2)."""
    final_rank = rank_from_scores(full_scores, mask)
    return mask & (rel_labels > 0) & (final_rank < k)


def instance_weights(
    continue_labels: torch.Tensor,  # [Q, D] bool
    rel_labels: torch.Tensor,       # [Q, D]
    mask: torch.Tensor,
) -> torch.Tensor:
    """w_d = 2^{r_d} / f_q(l_d); f_q = per-query frequency of d's class."""
    n = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1).float()
    n_cont = (continue_labels & mask).sum(dim=-1, keepdim=True).float()
    f_cont = torch.clamp_min(n_cont, 1.0) / n
    f_exit = torch.clamp_min(n - n_cont, 1.0) / n
    f = torch.where(continue_labels, f_cont, f_exit)
    w = torch.exp2(rel_labels.float()) / f
    return torch.where(mask, w, torch.zeros_like(w))


def sentinel_scores(
    ranker: TreeEnsemble, X: torch.Tensor, sentinel: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(partial, full) scores of flat documents ``X [B, F]``: the first
    ``sentinel`` trees and all of them, from one segmented kernel launch
    (``full = seg₀ + seg₁ + base``)."""
    T = ranker.n_trees
    pf = padded_forest(ranker, boundaries=(sentinel, T) if sentinel < T else (T,))
    seg = forest_score_segments(pf, X)
    partial = seg[:, 0] + pf.base_score
    if pf.n_segments == 1:
        return partial, partial
    return partial, seg[:, 0] + seg[:, 1] + pf.base_score


def continue_training_set(
    X: np.ndarray,           # [Q, D, F] classifier-train split
    rel_labels: np.ndarray,  # [Q, D]
    mask: np.ndarray,        # [Q, D]
    ranker: TreeEnsemble,
    sentinel: int,
    k: int = 15,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The classifier's flat training set, where ``ranker`` lives: augmented
    features ``[Q·D, F + 4]``, Continue labels ``[Q·D]`` (0/1 float) and
    instance weights ``[Q·D]``."""
    dev = ranker.device
    X_t = torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev)
    rel = torch.as_tensor(np.asarray(rel_labels), device=dev)
    mask_t = torch.as_tensor(np.asarray(mask, dtype=bool), device=dev)
    Q, D, F = X_t.shape
    partial, full = sentinel_scores(ranker, X_t.reshape(Q * D, F), sentinel)
    cont = build_continue_labels(full.reshape(Q, D), rel, mask_t, k=k)
    w = instance_weights(cont, rel, mask_t)
    X_aug = augment_features(X_t, partial.reshape(Q, D), mask_t)
    return X_aug.reshape(Q * D, F + N_AUG), cont.reshape(-1).float(), w.reshape(-1)


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

    def prob_continue(self, X_aug: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        """P(Continue) for augmented features ``[Q, D, F+4]`` → ``[Q, D]``.

        ``use_kernel=True`` scores the classifier forest through the same
        kernel as the ranker (:func:`repro_torch.kernels.ops.forest_score`),
        as the serving cascade does; the default is the plain bitvector
        scorer (:func:`repro_torch.forest.scoring.score_bitvector`), the
        reference's default, kept for training and evaluation loops. Its
        trees are summed left to right, the order of the reference's XLA
        reduce on the CPU for a row of up to 32 trees, so a classifier of
        that size gets the reference's logits bit for bit; the probability
        may still differ by an ulp (XLA's float32 ``exp`` is its own).
        """
        Q, D, F = X_aug.shape
        flat = X_aug.reshape(Q * D, F)
        if use_kernel:
            logits = forest_score(self.forest, flat)
        else:
            _, per_tree = score_bitvector(self.forest, flat, return_per_tree=True)
            logits = per_tree[:, 0]
            for t in range(1, per_tree.shape[1]):
                logits = logits + per_tree[:, t]
            logits = logits + self.forest.base_score
        return torch.sigmoid(logits).reshape(Q, D)

    def continue_mask(
        self,
        X_aug: torch.Tensor,
        mask: torch.Tensor,
        threshold: float,
        use_kernel: bool = False,
    ) -> torch.Tensor:
        """Continue ⇔ P(Continue) ≥ threshold. Higher = more aggressive EE."""
        return mask & (self.prob_continue(X_aug, use_kernel=use_kernel) >= threshold)


def train_lear(
    X: np.ndarray,            # [Q, D, F] classifier-train split
    rel_labels: np.ndarray,   # [Q, D]
    mask: np.ndarray,         # [Q, D]
    ranker: TreeEnsemble,
    sentinel: int,
    k: int = 15,
    params: GBDTParams | None = None,
) -> LearClassifier:
    """Train the LEAR classifier against a frozen λ-MART ranker, on the
    ranker's device (:func:`continue_training_set`, then a weighted
    logistic :func:`train_gbdt`)."""
    # Depth-5 / lr-0.2, the reference's choice on the tune split: the
    # shallower forest is better calibrated on the minority Continue class
    # at low thresholds.
    params = params or GBDTParams(n_trees=10, depth=5, learning_rate=0.2, reg_lambda=1.0)
    X_aug, cont, w = continue_training_set(X, rel_labels, mask, ranker, sentinel, k)
    forest = train_gbdt(
        X_aug.cpu().numpy(), cont.cpu().numpy(), params, objective="logistic",
        weights=w.cpu().numpy(), device=ranker.device,
    )
    return LearClassifier(forest=forest, sentinel=int(sentinel))
