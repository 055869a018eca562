"""Reference scorers for tensorized tree ensembles.

The port of :mod:`repro.forest.scoring`:

- :func:`score_numpy_oracle` — per-document recursive traversal in numpy;
  slowest, trusted ground truth for tests.
- :func:`score_bitvector` — QuickScorer: order-free AND of false-node masks,
  exit leaf = lowest set bit, one ``sum`` over the trees. The reference path
  of :meth:`repro_torch.core.cascade.CascadeRanker.rank`.

Both take ``X: [B, F]`` and return ``[B]`` scores.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.forest.ensemble import TreeEnsemble
from repro_torch.kernels.forest_score import exit_leaves


def exit_leaves_bitvector(ens: TreeEnsemble, X: torch.Tensor) -> torch.Tensor:
    """Exit leaf per (doc, tree) via mask AND-reduction → ``[B, T]`` int64."""
    return exit_leaves(X.float(), ens.feature, ens.threshold, ens.mask)


def score_bitvector(
    ens: TreeEnsemble, X: torch.Tensor, return_per_tree: bool = False
):
    leaves = exit_leaves_bitvector(ens, X)
    rows = torch.arange(ens.n_trees, device=leaves.device)
    per_tree = ens.leaf_value[rows[None, :], leaves]
    scores = per_tree.sum(dim=1) + ens.base_score
    if return_per_tree:
        return scores, per_tree
    return scores


def score_numpy_oracle(ens: TreeEnsemble, X: np.ndarray) -> np.ndarray:
    """Per-document recursive traversal — trusted ground truth."""
    feature = ens.feature.cpu().numpy()
    threshold = ens.threshold.cpu().numpy()
    left = ens.left.cpu().numpy()
    right = ens.right.cpu().numpy()
    leaf_value = ens.leaf_value.cpu().numpy()
    B = X.shape[0]
    out = np.full(B, float(ens.base_score), dtype=np.float64)
    for b in range(B):
        for t in range(ens.n_trees):
            n = 0
            while True:
                child = left[t, n] if X[b, feature[t, n]] <= threshold[t, n] else right[t, n]
                if child < 0:
                    out[b] += leaf_value[t, -(child + 1)]
                    break
                n = child
    return out.astype(np.float32)
