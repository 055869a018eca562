"""Distil the tree ensemble into the dense stage-0 scorer.

The port of :mod:`repro.train.distill`. The teacher is the ensemble's
exact score (:func:`repro_torch.forest.scoring.score_bitvector`, no kernel
in the loop). The student (:mod:`repro_torch.models.dense_scorer`) is fit
with two terms:

- **MSE** on the raw teacher scale: documents the dense gate exits keep
  the dense score as their final score, so it must live on the ensemble's
  scale.
- **Pairwise logistic loss** within each query over the pairs the teacher
  separates: the gate is rank-based, so the student's per-query order is
  what decides who survives.

Training whitens the features (masked mean and deviation) and at the end
folds the whitening into ``proj`` and ``pb``, so the returned scorer reads
raw features. Full-batch steps through ``torch.autograd`` and the
reference's AdamW (:func:`repro_torch.train.optimizer.adamw`); the loop
runs where the ensemble lives and reads the host only at logged steps.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.forest.ensemble import TreeEnsemble
from repro_torch.forest.scoring import score_bitvector
from repro_torch.models.dense_scorer import (
    DENSE_HIDDEN,
    DENSE_N_VEC,
    DENSE_VEC_DIM,
    DenseScorer,
    dense_score,
    init_dense_scorer,
)
from repro_torch.train.optimizer import adamw

# Bound on the [rows, trees, nodes] working set of one teacher chunk: the
# plain scorer holds an int64 mask per (document, node).
_TEACHER_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class DistillResult:
    """Trained student and its teacher-fit diagnostics."""

    params: dict[str, torch.Tensor]  # folded: reads raw features
    scorer: DenseScorer       # the [B, F] → [B] module over ``params``
    history: list[dict]       # logged (step, loss, mse, rank, pair_accuracy)
    teacher_rmse: float       # masked RMSE against the ensemble, raw scale
    pair_accuracy: float      # teacher-ordered pairs the student orders alike


def teacher_scores(ensemble: TreeEnsemble, X: torch.Tensor) -> torch.Tensor:
    """Exact ensemble scores for a ``[Q, D, F]`` block → ``[Q, D]``, scored
    a bounded chunk of rows at a time (each row is scored on its own, so
    the chunking changes no value)."""
    Q, D, F = X.shape
    flat = X.reshape(Q * D, F)
    T, N = ensemble.feature.shape
    rows = max(1, _TEACHER_CHUNK_ELEMS // max(T * N, 1))
    parts = [score_bitvector(ensemble, flat[i:i + rows]) for i in range(0, Q * D, rows)]
    return torch.cat(parts).reshape(Q, D)


def _pair_terms(
    pred: torch.Tensor, teacher: torch.Tensor, m: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query pairwise logistic loss and pair accuracy over the pairs
    the teacher orders (``dt > 0`` takes each separated pair once)."""
    dt = teacher[:, :, None] - teacher[:, None, :]
    ds = pred[:, :, None] - pred[:, None, :]
    pair_m = (m[:, :, None] * m[:, None, :]) * (dt > 0)
    n_pairs = torch.clamp_min(pair_m.sum(), 1.0)
    loss = (torch.nn.functional.softplus(-ds) * pair_m).sum() / n_pairs
    acc = ((ds > 0) * pair_m).sum() / n_pairs
    return loss, acc


def distill_dense_scorer(
    ensemble: TreeEnsemble,
    X: torch.Tensor | np.ndarray,
    mask: torch.Tensor | np.ndarray,
    steps: int = 400,
    lr: float = 3e-3,
    rank_weight: float = 1.0,
    seed: int = 0,
    n_vec: int = DENSE_N_VEC,
    vec_dim: int = DENSE_VEC_DIM,
    hidden: int = DENSE_HIDDEN,
    log_every: int = 50,
    init: DenseScorer | Mapping[str, np.ndarray] | None = None,
) -> DistillResult:
    """Train the dense student against the ensemble on one block.

    ``X`` is the padded ``[Q, D, F]`` block and ``mask`` its ``[Q, D]``
    validity (padding enters neither loss term nor the whitening). The
    student starts from ``init`` (a scorer, or the reference's parameter
    dict as numpy arrays) or else from :func:`init_dense_scorer` with a
    generator seeded by ``seed``; ``n_vec``, ``vec_dim`` and ``hidden``
    apply to that fresh start. Returns folded parameters.
    """
    dev = ensemble.device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    Q, D, F = X.shape
    teacher = teacher_scores(ensemble, X)
    m = mask.float()
    w = m.reshape(Q * D, 1)
    denom = torch.clamp_min(w.sum(), 1.0)
    flat = X.reshape(Q * D, F)
    mu = (flat * w).sum(0) / denom
    sd = torch.sqrt((torch.square(flat - mu) * w).sum(0) / denom) + 1e-6
    Xn = (flat - mu) / sd

    if init is None:
        init = init_dense_scorer(
            torch.Generator().manual_seed(seed), F, n_vec=n_vec, vec_dim=vec_dim,
            hidden=hidden, device="cpu",
        )
    start = init.params() if isinstance(init, DenseScorer) else {
        k: torch.tensor(np.asarray(v, np.float32)) for k, v in init.items()
    }
    params = {
        k: v.detach().to(dev, torch.float32).clone().requires_grad_(True)
        for k, v in start.items()
    }
    opt = adamw(lr=lr, weight_decay=1e-4)
    state = opt.init(params)

    history = []
    for it in range(steps):
        pred = dense_score(params, Xn).reshape(Q, D)
        mse = (torch.square(pred - teacher) * m).sum() / denom
        rank, acc = _pair_terms(pred, teacher, m)
        loss = mse + rank_weight * rank
        grads = torch.autograd.grad(loss, list(params.values()))
        params, state = opt.update(dict(zip(params, grads)), state, params)
        params = {k: p.requires_grad_(True) for k, p in params.items()}
        if log_every and (it % log_every == 0 or it == steps - 1):
            logged = torch.stack([loss, mse, rank, acc]).detach().cpu().tolist()
            history.append(
                {"step": it, **dict(zip(("loss", "mse", "rank", "pair_accuracy"), logged))}
            )

    # Fold the whitening into the projection so the scorer reads raw
    # features: einsum((x−μ)/σ, P) + b == einsum(x, P/σ) + (b − einsum(μ/σ, P)).
    with torch.no_grad():
        folded = {k: p.detach() for k, p in params.items()}
        folded["proj"] = params["proj"] / sd[:, None, None]
        folded["pb"] = params["pb"] - torch.einsum("f,fnd->nd", mu / sd, params["proj"])
        pred = dense_score(folded, flat).reshape(Q, D)
        rmse = torch.sqrt((torch.square(pred - teacher) * m).sum() / denom)
        _, pair_acc = _pair_terms(pred, teacher, m)
        rmse, pair_acc = torch.stack([rmse, pair_acc]).cpu().tolist()
    return DistillResult(
        params=folded,
        scorer=DenseScorer(folded),
        history=history,
        teacher_rmse=rmse,
        pair_accuracy=pair_acc,
    )
