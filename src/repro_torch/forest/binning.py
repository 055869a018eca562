"""Quantile feature binning for histogram GBDT (256 bins, LightGBM-style).

The port of :mod:`repro.forest.binning`. Binning convention: for feature
``f`` with interior boundaries ``edges[f] = [e_0 < e_1 < ...]``,
``bin(x) = #{j : e_j < x}`` (``searchsorted(edges, x, side='left')``), so
the split condition ``bin(x) <= b  ⟺  x <= edges[b]`` is exact and
bin-space trees convert to real-threshold trees without epsilon fudging.

The edges are learned on the host in numpy (a copy of the reference's
:func:`quantile_bins`); :func:`apply_bins` runs where ``X`` lives. All three
functions only compare values, so they are bit-exact with the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def quantile_bins(X: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """Per-feature interior boundaries ``[F, n_bins - 1]`` from quantiles.

    Duplicate quantiles (low-cardinality features) are padded with +inf so
    unused bins are simply never populated.
    """
    F = X.shape[1]
    n_edges = n_bins - 1
    edges = np.full((F, n_edges), np.inf, dtype=np.float32)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    for f in range(F):
        e = np.unique(np.quantile(X[:, f], qs).astype(np.float32))
        edges[f, : e.shape[0]] = e
    return edges


def apply_bins(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin a feature matrix: ``[N, F] float → [N, F] int32`` bin indices
    (``edges`` ``[F, n_edges]`` on ``X``'s device)."""
    bins = torch.searchsorted(
        edges.contiguous(), X.t().contiguous(), side="left", out_int32=True
    )
    return bins.t().contiguous()


def bin_to_threshold(edges: np.ndarray, feat: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Real threshold for split ``bin(x) <= b`` on feature ``feat``: edges[feat, b].

    ``b == n_edges`` (degenerate all-left split) maps to +inf.
    """
    n_edges = edges.shape[1]
    padded = np.concatenate([edges, np.full((edges.shape[0], 1), np.inf, np.float32)], axis=1)
    return padded[feat, np.minimum(b, n_edges)]
