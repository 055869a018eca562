"""Reference scorers for tensorized tree ensembles.

The port of :mod:`repro.forest.scoring`:

- :func:`score_numpy_oracle` — per-document recursive traversal in numpy;
  slowest, trusted ground truth for tests.
- :func:`score_level` — vectorized root→leaf stepping (``depth + 1``
  dependent gather steps), classic batched traversal.
- :func:`score_bitvector` — QuickScorer: order-free AND of false-node masks,
  exit leaf = lowest set bit, one ``sum`` over the trees. The reference path
  of :meth:`repro_torch.core.cascade.CascadeRanker.rank`.
- :func:`partial_scores` — the head and tail of a sentinel split.

All take ``X: [B, F]`` and return ``[B]`` scores.
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


def score_level(ens: TreeEnsemble, X: torch.Tensor) -> torch.Tensor:
    """Classic batched root→leaf traversal (``depth + 1`` dependent steps)."""
    B, T = X.shape[0], ens.n_trees
    trees = torch.arange(T, device=X.device)[None, :]
    node = torch.zeros((B, T), dtype=torch.int64, device=X.device)
    done = torch.zeros((B, T), dtype=torch.bool, device=X.device)
    leaf = torch.zeros((B, T), dtype=torch.int64, device=X.device)
    for _ in range(ens.depth + 1):
        safe = torch.where(done, torch.zeros_like(node), node)
        f = ens.feature[trees, safe].long()                       # [B, T]
        t = ens.threshold[trees, safe]
        left = ens.left[trees, safe].long()
        right = ens.right[trees, safe].long()
        xv = torch.gather(X.float(), 1, f)
        child = torch.where(xv <= t, left, right)
        is_leaf = child < 0
        leaf = torch.where(~done & is_leaf, -(child + 1), leaf)
        node = torch.where(~done & ~is_leaf, child, node)
        done = done | is_leaf
    per_tree = ens.leaf_value[trees, leaf]
    return per_tree.sum(dim=1) + ens.base_score


def partial_scores(
    ens: TreeEnsemble, X: torch.Tensor, sentinel: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores after the first ``sentinel`` trees, scores of the remaining
    tail). Full score = partial + tail."""
    _, per_tree = score_bitvector(ens, X, return_per_tree=True)
    head = per_tree[:, :sentinel].sum(dim=1) + ens.base_score
    tail = per_tree[:, sentinel:].sum(dim=1)
    return head, tail


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
