"""Learned tree reordering for additive ensembles (QWYC-style).

The port of :mod:`repro.forest.reorder`. A GBDT's trees arrive in boosting
order, but the additive model does not require traversing them that way.
Reordering the trees so that the *partial* prefix sum converges to the
full score as early as possible makes every early-exit policy cheaper at
matched quality (arXiv 1806.11202). This module learns such an order
offline from per-tree contributions on a validation slice:

- :func:`per_tree_contributions` — ``[B, T]`` leaf values per (doc, tree),
  from the QuickScorer exit leaves, a chunk of rows at a time (the exit-leaf
  masks are ``[rows, T, N]`` int64: 4,096 rows of a 1,047-tree depth-6
  forest would hold ~2.2 GB at once);
- :func:`greedy_order` — greedy residual fit (host numpy, float64);
- :func:`variance_order` — descending contribution variance;
- :func:`reorder_trees` — the permuted ensemble (a NEW instance, so its
  ``padded_forest`` cache starts empty);
- :func:`prefix_residual` — the convergence diagnostic;
- :func:`learn_order` / :func:`reordered_ensemble` — the offline entry points.

Reordering only permutes the per-tree terms: the final score equals the
identity order's up to reassociation of the tree sum, and is bit-exact
through every path that reduces with the same pairwise tree sum on the same
tree count. The order learning runs in host float64 and produces no score.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.forest.ensemble import TreeEnsemble
from repro_torch.kernels.forest_score import exit_leaves, pairwise_tree_sum

CONTRIB_CHUNK_ROWS = 512


def per_tree_contributions(
    ens: TreeEnsemble, X: torch.Tensor, chunk_rows: int = CONTRIB_CHUNK_ROWS
) -> torch.Tensor:
    """Leaf value each tree contributes per document → ``[B, T]`` f32, where
    ``ens`` lives, ``chunk_rows`` rows at a time. ``base_score`` is
    excluded: it is ordering-invariant by definition."""
    rows = torch.arange(ens.n_trees, device=X.device)[None, :]
    parts = []
    for r0 in range(0, X.shape[0], chunk_rows):
        leaves = exit_leaves(
            X[r0:r0 + chunk_rows].float(), ens.feature, ens.threshold, ens.mask
        )
        parts.append(ens.leaf_value[rows, leaves])
    return torch.cat(parts)


def full_from_contributions(ens: TreeEnsemble, per_tree: torch.Tensor) -> torch.Tensor:
    """Total score from a contribution matrix via the kernels' pairwise tree sum."""
    return pairwise_tree_sum(per_tree) + ens.base_score


def greedy_order(contrib: np.ndarray) -> np.ndarray:
    """Greedy residual-fit ordering → permutation ``[T]`` int64.

    At each step, with residual ``r = full − prefix`` over the validation
    docs, adding tree ``t`` changes the squared residual by
    ``||C_t||² − 2⟨r, C_t⟩``, so pick the tree maximizing
    ``2⟨r, C_t⟩ − ||C_t||²``. The Gram matrix makes each step O(T).
    Float64 on the host; numpy's argmax takes the first maximum.
    """
    C = np.asarray(contrib, dtype=np.float64)
    B, T = C.shape
    if B < 1 or T < 1:
        raise ValueError(f"contributions of shape {C.shape}")
    gram = C.T @ C                                              # [T, T]
    # ⟨C_t, r₀⟩ where r₀ = Σ_u C_u: a row of Gram-column totals.
    score = np.einsum("tu->t", gram)
    sq = np.diagonal(gram).copy()
    used = np.zeros(T, dtype=bool)
    order = np.empty(T, dtype=np.int64)
    for i in range(T):
        gain = np.where(used, -np.inf, 2.0 * score - sq)
        t = int(np.argmax(gain))
        order[i] = t
        used[t] = True
        score = score - gram[:, t]
    return order


def variance_order(contrib: np.ndarray) -> np.ndarray:
    """Descending contribution variance → permutation ``[T]`` int64 (stable
    sort: boosting order among ties)."""
    C = np.asarray(contrib, dtype=np.float64)
    B = C.shape[0]
    mean = np.einsum("bt->t", C) / B
    ex2 = np.einsum("bt,bt->t", C, C) / B
    var = ex2 - mean * mean
    return np.argsort(-var, kind="stable").astype(np.int64)


def prefix_residual(contrib: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Mean squared full-score residual after each prefix → ``[T]`` f64:
    ``out[m]`` = mean over docs of ``(prefix_{m+1} − full)²`` under ``order``."""
    C = np.asarray(contrib, dtype=np.float64)[:, np.asarray(order)]
    prefix = np.cumsum(C, axis=1)                               # [B, T]
    resid = prefix - prefix[:, -1:]
    return np.einsum("bt,bt->t", resid, resid) / C.shape[0]


def reorder_trees(ens: TreeEnsemble, order: np.ndarray) -> TreeEnsemble:
    """The permuted ensemble (validated permutation), a new instance."""
    idx = np.asarray(order)
    T = ens.n_trees
    if idx.shape != (T,) or not np.array_equal(np.sort(idx), np.arange(T)):
        raise ValueError(f"order of shape {idx.shape} is not a permutation of {T} trees")
    take = torch.as_tensor(idx, dtype=torch.int64, device=ens.device)
    return TreeEnsemble(
        feature=ens.feature[take],
        threshold=ens.threshold[take],
        left=ens.left[take],
        right=ens.right[take],
        mask=ens.mask[take],
        leaf_value=ens.leaf_value[take],
        base_score=ens.base_score,
    )


def learn_order(
    ens: TreeEnsemble,
    X_valid: torch.Tensor,
    method: str = "greedy",
    max_docs: int | None = 4096,
) -> np.ndarray:
    """Learn a traversal order from flat validation documents ``[B, F]`` →
    ``[T]`` int64. ``max_docs`` caps the slice with a deterministic stride
    (not a prefix: query blocks arrive grouped). ``method`` ∈ {"greedy",
    "variance", "identity"}."""
    if method not in ("greedy", "variance", "identity"):
        raise ValueError(f"method {method!r}")
    if method == "identity":
        return np.arange(ens.n_trees, dtype=np.int64)
    B = X_valid.shape[0]
    if max_docs is not None and B > max_docs:
        stride = -(-B // max_docs)  # ceil: keeps ≤ max_docs rows
        X_valid = X_valid[::stride]
    contrib = per_tree_contributions(ens, X_valid).cpu().numpy()
    if method == "greedy":
        return greedy_order(contrib)
    return variance_order(contrib)


def reordered_ensemble(
    ens: TreeEnsemble,
    X_valid: torch.Tensor,
    method: str = "greedy",
    max_docs: int | None = 4096,
) -> tuple[TreeEnsemble, np.ndarray]:
    """One-call offline entry point: learned order + permuted ensemble."""
    order = learn_order(ens, X_valid, method=method, max_docs=max_docs)
    return reorder_trees(ens, order), order
