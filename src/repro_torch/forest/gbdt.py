"""Histogram-based gradient-boosted decision trees in PyTorch.

The port of :mod:`repro.forest.gbdt`. Level-wise growth of complete
depth-``D`` trees (≤ 64 leaves) with 256-bin quantile histograms; one
boosting round is gradients, a histogram per level, the best split of every
node, leaf fitting and the prediction update, all on the device where the
data lives. The split search keeps the reference's expressions term for
term (gain, validity mask, the dead node's all-left sentinel split,
``-G/(H+λ)·lr`` leaves) and its first-max tie-break (``argmax``).

**Determinism.** The histogram and the leaf sums are scatter-adds
(:func:`_scatter_sum`), and each adds a destination's values one after
another in row order, on either device, so a run is bit-equal to the next
and the card's sums equal the CPU's for equal inputs. On CUDA
``scatter_add_``, ``index_add_`` and ``bincount`` add with float atomics,
and the sorted ``index_put_(..., accumulate=True)`` is deterministic but
slow at histogram size (its kernel walks a destination's duplicates one
thread at a time, 87% of a round); there the sums are segment sums over
rows sorted by destination (:func:`_segment_sum_sorted`: a stable sort,
offsets by ``searchsorted``, ``segment_reduce``). On the CPU they are
``index_add_`` on one-dimensional columns, a serial loop in row order
(the CPU's ``index_put_`` adds with parallel atomics on large inputs).
XLA orders the reference's sums differently, so its histograms differ in
the last bits and a split whose gain ties within that noise may go either
way: parity with the reference is exact where exact arithmetic makes the
order irrelevant, and a tie rule elsewhere (``tests/torch_parity.py``).

**Host reads.** Trees stay on the device; they are read once, at the end,
to build the ensemble. The per-round ``callback`` reads the predictions
only when one is given. (Some PyTorch calls of a round still wait for the
card inside the library.)

Objectives:
- ``l2``        : squared error (MART regression)
- ``logistic``  : binary cross-entropy with per-instance weights — the
  LEAR Continue/Exit classifier (cost-sensitive ``w_d = 2^{r_d} / f_q(l_d)``).
- LambdaRank    : via :func:`repro_torch.forest.lambdamart.lambda_grad_hess`,
  plugged in through :func:`train_lambdamart`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.forest import binning
from repro_torch.forest.ensemble import TreeEnsemble, from_complete_arrays
from repro_torch.forest.lambdamart import lambda_grad_hess
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class GBDTParams:
    n_trees: int = 100
    depth: int = 6                 # complete trees → 2**depth leaves (≤64)
    learning_rate: float = 0.1
    reg_lambda: float = 1.0
    min_child_hess: float = 1e-3
    n_bins: int = 256
    base_score: float = 0.0


# ---------------------------------------------------------------------------
# Single-tree fit.
# ---------------------------------------------------------------------------


def _segment_sum_sorted(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """``out[i] = Σ vals[j] over idx[j] == i`` → ``[size, C]`` for ``vals``
    ``[M, C]``: the rows sorted by destination (stable, so row order within
    one), then one sum per destination from 0, in that order, without
    atomics."""
    keys, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(size + 1, device=idx.device))
    return torch.segment_reduce(vals[order], "sum", offsets=offsets, axis=0, unsafe=True)


def _scatter_sum(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """``out[i] = Σ vals[j] over idx[j] == i`` → ``[size, C]`` for ``vals``
    ``[M, C]``, each destination's values added in row order (see the
    module note): segment sums on CUDA, ``index_add_`` on the CPU."""
    if vals.device.type == "cuda":
        return _segment_sum_sorted(idx, vals, size)
    out = torch.zeros(size, vals.shape[1], dtype=torch.float32, device=vals.device)
    for c in range(vals.shape[1]):
        out[:, c].index_add_(0, idx, vals[:, c].contiguous())
    return out


def _fit_tree(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor, p: GBDTParams):
    """Fit one complete depth-D tree on binned features.

    Xb: [N, F] int32 bins; g/h: [N] float32 (weights pre-folded).
    Returns (feat [n_int] i32, bin [n_int] i32, leaf_value [n_leaves] f32,
    leaf index [N] i64) in heap order.
    """
    N, F = Xb.shape
    dev = Xb.device
    n_bins, depth = p.n_bins, p.depth
    lam = p.reg_lambda
    # Histogram cell of (feature, bin) within one node's [F, n_bins] block.
    cell = (torch.arange(F, device=dev) * n_bins)[None, :] + Xb.long()   # [N, F]
    last_bin = torch.arange(n_bins, device=dev) < n_bins - 1
    gh = torch.stack([g, h], dim=-1)                                    # [N, 2]
    gh_cells = gh[:, None, :].expand(N, F, 2).reshape(N * F, 2)
    feats, bins = [], []
    node = torch.zeros(N, dtype=torch.int64, device=dev)  # node-in-level index

    for level in range(depth):
        n_nodes = 1 << level
        idx = (node[:, None] * (F * n_bins) + cell).reshape(-1)
        hist = _scatter_sum(idx, gh_cells, n_nodes * F * n_bins)
        cum = torch.cumsum(hist.reshape(n_nodes, F, n_bins, 2), dim=2)  # left stats at bin b
        total = cum[:, :, -1:, :]                                       # [n_nodes, F, 1, 2]
        gl, hl = cum[..., 0], cum[..., 1]
        gt, ht = total[..., 0], total[..., 1]
        gr, hr = gt - gl, ht - hl
        gain = (
            gl * gl / (hl + lam)
            + gr * gr / (hr + lam)
            - gt * gt / (ht + lam)
        )
        valid = (hl >= p.min_child_hess) & (hr >= p.min_child_hess)
        # Splitting at the last bin sends everything left — never a real split.
        valid = valid & last_bin[None, None, :]
        gain = torch.where(valid, gain, -torch.inf)
        flat = gain.reshape(n_nodes, F * n_bins)
        best = torch.argmax(flat, dim=1)                                # first max
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        bf = torch.div(best, n_bins, rounding_mode="floor")
        bb = best % n_bins
        # Degenerate node (no valid split): all-left sentinel split.
        dead = ~torch.isfinite(best_gain)
        bf = torch.where(dead, torch.zeros_like(bf), bf)
        bb = torch.where(dead, torch.full_like(bb, n_bins - 1), bb)
        feats.append(bf)
        bins.append(bb)
        # Route documents.
        xb_f = torch.gather(Xb, 1, bf[node][:, None])[:, 0]
        go_left = xb_f <= bb[node]
        node = 2 * node + torch.where(go_left, 0, 1)

    # Leaves: node is now the in-level (== left-to-right leaf) index.
    n_leaves = 1 << depth
    leaf_gh = _scatter_sum(node, gh, n_leaves)
    leaf_g, leaf_h = leaf_gh[:, 0], leaf_gh[:, 1]
    leaf_value = -leaf_g / (leaf_h + lam) * p.learning_rate
    feat_heap = torch.cat(feats).int()  # heap order == level order for complete trees
    bin_heap = torch.cat(bins).int()
    return feat_heap, bin_heap, leaf_value, node


# ---------------------------------------------------------------------------
# Objectives.
# ---------------------------------------------------------------------------


def grad_hess_l2(preds, y, w):
    return (preds - y) * w, w


def grad_hess_logistic(preds, y, w):
    prob = torch.sigmoid(preds)
    return (prob - y) * w, torch.clamp_min(prob * (1 - prob), 1e-6) * w


OBJECTIVES: dict[str, Callable] = {
    "l2": grad_hess_l2,
    "logistic": grad_hess_logistic,
}


# ---------------------------------------------------------------------------
# Boosting loops.
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _binned(X_flat: np.ndarray, edges: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``X_flat`` [N, F] moved to ``dev`` once and binned there."""
    X_t = torch.as_tensor(np.ascontiguousarray(X_flat, dtype=np.float32), device=dev)
    return binning.apply_bins(X_t, torch.as_tensor(edges, device=dev))


def train_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    params: GBDTParams,
    objective: str = "l2",
    weights: np.ndarray | None = None,
    edges: np.ndarray | None = None,
    callback: Callable[[int, np.ndarray], None] | None = None,
    *,
    device: str | torch.device | None = None,
) -> TreeEnsemble:
    """Train a GBDT on a flat dataset ``X [N, F]``, on ``device`` (``None``
    → the card). Returns a real-threshold ``TreeEnsemble`` there."""
    dev = resolve_device(device)
    X, y = _host(X), _host(y)
    if edges is None:
        edges = binning.quantile_bins(X, params.n_bins)
    Xb = _binned(X, edges, dev)
    w = np.ones_like(y, dtype=np.float32) if weights is None else _host(weights).astype(np.float32)
    y_t = torch.as_tensor(np.asarray(y, dtype=np.float32), device=dev)
    w_t = torch.as_tensor(w, device=dev)
    preds = torch.full((X.shape[0],), params.base_score, dtype=torch.float32, device=dev)
    grad_hess = OBJECTIVES[objective]

    trees = []
    for t in range(params.n_trees):
        g, h = grad_hess(preds, y_t, w_t)
        feat, bin_, leaf_value, leaf_idx = _fit_tree(Xb, g, h, params)
        preds = preds + leaf_value[leaf_idx]
        trees.append((feat, bin_, leaf_value))
        if callback is not None:
            callback(t, preds.cpu().numpy())
    return _stack_trees(trees, edges, params, dev)


def _stack_trees(trees, edges: np.ndarray, params: GBDTParams, device) -> TreeEnsemble:
    """The trees read back to the host once, converted to real thresholds."""
    feat, bin_, leaf = (torch.stack([t[i] for t in trees]).cpu().numpy() for i in range(3))
    thr = binning.bin_to_threshold(edges, feat, bin_)
    return from_complete_arrays(feat, thr, leaf, base_score=params.base_score, device=device)


# --- LambdaMART -------------------------------------------------------------


def train_lambdamart(
    X: np.ndarray,        # [Q, D, F] padded per-query features
    labels: np.ndarray,   # [Q, D] graded relevance
    mask: np.ndarray,     # [Q, D] bool
    params: GBDTParams,
    k: int = 10,
    edges: np.ndarray | None = None,
    callback: Callable[[int, np.ndarray], None] | None = None,
    *,
    device: str | torch.device | None = None,
) -> TreeEnsemble:
    """Train a λ-MART ranker (NDCG@k lambda gradients) on ``device``
    (``None`` → the card)."""
    dev = resolve_device(device)
    X, labels, mask = _host(X), _host(labels), _host(mask).astype(bool)
    Q, D, F = X.shape
    flatX = X.reshape(Q * D, F)
    if edges is None:
        edges = binning.quantile_bins(flatX[mask.reshape(-1)], params.n_bins)
    Xb = _binned(flatX, edges, dev)
    preds = torch.zeros((Q, D), dtype=torch.float32, device=dev)
    lab_t = torch.as_tensor(np.asarray(labels, dtype=np.float32), device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    flat_w = mask_t.reshape(-1).float()

    trees = []
    for t in range(params.n_trees):
        g, h = lambda_grad_hess(preds, lab_t, mask_t, k=k)
        g = g.reshape(-1) * flat_w
        h = h.reshape(-1) * flat_w
        feat, bin_, leaf_value, leaf_idx = _fit_tree(Xb, g, h, params)
        preds = preds + leaf_value[leaf_idx].reshape(Q, D)
        trees.append((feat, bin_, leaf_value))
        if callback is not None:
            callback(t, preds.cpu().numpy())
    return _stack_trees(trees, edges, params, dev)
