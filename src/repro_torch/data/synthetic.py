"""Synthetic LETOR datasets calibrated to the paper's two benchmarks.

The port's own copy of :mod:`repro.data.synthetic`. It draws from numpy
only (``np.random.default_rng(seed)``), so a seed gives the reference's
arrays bit for bit; a caller moves them to its device.

MSN-1 and Istella are not redistributable offline, so experiments run on
synthetic datasets matching their *published statistics* (paper §3):

- **msn1**: 136 features, ~120 docs/query, power-law label distribution with
  51% non-relevant (MSLR-WEB30K fold-1 marginals).
- **istella**: 220 features, ~317 docs/query (scaled down by default), 96%
  non-relevant with the relevant mass normally distributed around label 2.

Feature model: each document draws a latent quality ``z`` correlated with
its graded label; features split into informative (monotone transforms of
``z``), query-conditioned, and pure-noise groups — giving a ranking problem
that a GBDT genuinely has to learn (NDCG improves smoothly with ensemble
size, which is what sentinel-based early exit needs to be non-trivial).

Splits follow the paper: 60% λ-MART train / 20% classifier train /
5% classifier fine-tune / 15% test.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LetorPreset:
    n_features: int
    mean_docs: int
    label_probs: tuple[float, ...]  # P(label = 0..4)


PRESETS: dict[str, LetorPreset] = {
    "msn1": LetorPreset(
        n_features=136,
        mean_docs=120,
        label_probs=(0.514, 0.325, 0.134, 0.019, 0.008),
    ),
    "istella": LetorPreset(
        n_features=220,
        mean_docs=317,
        label_probs=(0.960, 0.0103, 0.0170, 0.0103, 0.0024),
    ),
}


@dataclasses.dataclass
class LetorDataset:
    X: np.ndarray        # [Q, D, F] float32
    labels: np.ndarray   # [Q, D] int32 (0..4)
    mask: np.ndarray     # [Q, D] bool
    name: str

    @property
    def n_queries(self) -> int:
        return self.X.shape[0]

    def select(self, idx: np.ndarray) -> LetorDataset:
        return LetorDataset(self.X[idx], self.labels[idx], self.mask[idx], self.name)

    def splits(self) -> dict[str, "LetorDataset"]:
        """Paper partitions: 60/20/5/15 = ranker / classifier / tune / test."""
        q = self.n_queries
        bounds = np.cumsum([int(q * f) for f in (0.60, 0.20, 0.05)])
        idx = np.arange(q)
        return {
            "train": self.select(idx[: bounds[0]]),
            "classifier": self.select(idx[bounds[0]: bounds[1]]),
            "tune": self.select(idx[bounds[1]: bounds[2]]),
            "test": self.select(idx[bounds[2]:]),
        }


def make_letor_dataset(
    preset: str = "msn1",
    n_queries: int = 400,
    max_docs: int | None = None,
    n_features: int | None = None,
    seed: int = 0,
    docs_scale: float = 1.0,
) -> LetorDataset:
    p = PRESETS[preset]
    F = n_features or p.n_features
    mean_docs = max(8, int(p.mean_docs * docs_scale))
    D = max_docs or int(mean_docs * 1.5)
    rng = np.random.default_rng(seed)

    n_docs = np.clip(
        rng.poisson(mean_docs, size=n_queries), 8, D
    )
    labels = np.zeros((n_queries, D), dtype=np.int32)
    mask = np.zeros((n_queries, D), dtype=bool)
    X = np.zeros((n_queries, D, F), dtype=np.float32)

    probs = np.asarray(p.label_probs)
    n_inf = max(4, F * 3 // 10)       # informative features
    n_qf = max(2, F * 2 // 10)        # query-conditioned features
    # Fixed per-feature response curves (shared across queries — a real
    # ranking function, not per-query noise).
    inf_slope = rng.uniform(0.4, 1.6, size=n_inf).astype(np.float32)
    inf_noise = rng.uniform(0.2, 1.0, size=n_inf).astype(np.float32)
    qf_slope = rng.uniform(0.2, 0.8, size=n_qf).astype(np.float32)

    for q in range(n_queries):
        d = n_docs[q]
        mask[q, :d] = True
        lab = rng.choice(5, size=d, p=probs)
        labels[q, :d] = lab
        z = lab / 4.0 + 0.25 * rng.normal(size=d)
        q_off = rng.normal()
        feats = np.zeros((d, F), dtype=np.float32)
        feats[:, :n_inf] = (
            inf_slope[None, :] * z[:, None]
            + inf_noise[None, :] * rng.normal(size=(d, n_inf))
        )
        feats[:, n_inf: n_inf + n_qf] = (
            qf_slope[None, :] * (z[:, None] + q_off)
            + 0.5 * rng.normal(size=(d, n_qf))
        )
        feats[:, n_inf + n_qf:] = rng.normal(size=(d, F - n_inf - n_qf))
        X[q, :d] = feats

    return LetorDataset(X=X, labels=labels, mask=mask, name=preset)
