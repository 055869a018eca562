"""Ranking quality metrics (NDCG@k) over padded per-query blocks.

The port of :mod:`repro.metrics.ranking`. Arrays are padded ``[Q, D]`` with
a boolean ``mask`` marking real documents; padding never contributes.
Exponential gains ``2^label - 1`` and log2 discounts, per the paper.
"""

from __future__ import annotations

import torch

NEG = -1e30


def gain(labels: torch.Tensor) -> torch.Tensor:
    return torch.exp2(labels.float()) - 1.0


def rank_from_scores(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each doc within its query (0 = best); padding ranks
    last; ties broken by document index (stable sort)."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG))
    order = torch.argsort(-masked, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def dcg_at_k(
    scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, k: int
) -> torch.Tensor:
    ranks = rank_from_scores(scores, mask)
    disc = 1.0 / torch.log2(ranks.float() + 2.0)
    contrib = torch.where(
        mask & (ranks < k), gain(labels) * disc, torch.zeros_like(disc)
    )
    return contrib.sum(dim=-1)


def ideal_dcg_at_k(labels: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """DCG@k of the documents ranked by their own labels."""
    return dcg_at_k(labels.float(), labels, mask, k)


def ndcg_at_k(
    scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, k: int = 10
) -> torch.Tensor:
    """Per-query NDCG@k; queries with zero ideal DCG get NDCG 1."""
    idcg = ideal_dcg_at_k(labels, mask, k)
    dcg = dcg_at_k(scores, labels, mask, k)
    return torch.where(
        idcg > 0, dcg / torch.clamp_min(idcg, 1e-12), torch.ones_like(idcg)
    )


def mean_ndcg(
    scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, k: int = 10
) -> torch.Tensor:
    return ndcg_at_k(scores, labels, mask, k).mean()
