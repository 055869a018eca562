"""Heuristic early-exit strategies (Cambazoglu et al., WSDM'10) and the
query-level convergence test.

The port of the tensor functions of :mod:`repro.core.strategies`, with
the hybrid cascade's dense gate policy (:func:`dense_keep_fraction`) and
the per-query oracle cut (:func:`ideal_continue`). A
strategy acts at a sentinel: given per-document *partial* scores after
``s`` trees, it returns the boolean continue mask over a padded ``[Q, D]``
block. Strategies are *mask-invariant*: they read ``partial`` only where
the alive mask is set, because in staged execution exited documents hold
stale prefixes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.metrics.ranking import ndcg_at_k, rank_from_scores

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class QueryExitConfig:
    """Static configuration of query-level early exit (arXiv 2004.14641):
    a query exits once its top-``k`` is margin-stable, checked after each
    stage from ``from_stage`` on. ``margin=inf`` exits only queries with no
    alive documents left (score-preserving). The engine folds it into the
    alive mask after each stage and gates the tail launch on the survivor
    count (:mod:`repro_torch.core.cascade`)."""

    k: int = 10
    margin: float = math.inf
    from_stage: int = 0

    def __post_init__(self) -> None:
        if self.k < 1 or self.margin < 0.0 or self.from_stage < 0:
            raise ValueError(f"invalid QueryExitConfig {self}")


def _kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Values of the ``k`` largest entries along the last axis, descending."""
    return torch.topk(values, k, dim=-1, sorted=True).values


def query_converged(
    partial: torch.Tensor, alive: torch.Tensor, k: int, margin: float
) -> torch.Tensor:
    """Per-query "top-k stabilized" predicate → ``[Q]`` bool.

    With ``margin=inf`` a query converges only once it has no alive
    documents. With finite ``margin`` it also converges when every alive
    document outside its top-``k`` trails the ``k``-th best alive partial
    by more than ``margin`` (vacuously when at most ``k`` are alive). Ties
    never converge. ``k`` is clamped to ``D``.
    """
    n_alive = alive.sum(dim=-1)
    if math.isinf(margin):
        return n_alive == 0
    D = partial.shape[-1]
    kk = min(int(k), D)
    if kk >= D:
        return n_alive >= 0
    masked = torch.where(alive, partial, torch.full_like(partial, NEG))
    top = _kth_largest(masked, kk + 1)
    stable = (top[..., kk - 1] - top[..., kk]) > margin
    return (n_alive <= kk) | stable


def ert_continue(partial: torch.Tensor, mask: torch.Tensor, k_s: int) -> torch.Tensor:
    """EE Using Rank Thresholds: keep the top-``k_s`` by partial score."""
    return mask & (rank_from_scores(partial, mask) < k_s)


def ept_continue(
    partial: torch.Tensor, mask: torch.Tensor, k_s: int, p: float
) -> torch.Tensor:
    """EE Using Proximity Thresholds: keep docs with score ≥ σ_{k_s} − p,
    σ_{k_s} the k_s-th best partial of the query (``k_s`` clamped to D)."""
    masked = torch.where(mask, partial, torch.full_like(partial, NEG))
    k = min(int(k_s), partial.shape[-1])
    kth = _kth_largest(masked, k)[..., -1]
    return mask & (partial >= (kth - p)[..., None])


def dense_keep_fraction(
    partial: torch.Tensor, mask: torch.Tensor, keep_frac: float = 0.25
) -> torch.Tensor:
    """Dense-gate policy: keep the top ``⌈keep_frac · n_alive⌉`` per query.

    Rank-based, so the survivor count (and with it the dense capacity)
    does not depend on the proxy's calibration; scaled by each query's
    alive count, not the padded ``D``. ``keep_frac`` is clamped to
    ``[0, 1]``, and a query with an alive document keeps at least its
    top-1. The product is taken in float32, as in the reference.
    """
    frac = min(max(float(keep_frac), 0.0), 1.0)
    ranks = rank_from_scores(partial, mask)
    n_alive = mask.sum(dim=-1, keepdim=True).to(torch.float32)
    keep = torch.ceil(n_alive * frac).to(torch.int64)
    return mask & (ranks < keep)


def ideal_continue(
    partial: torch.Tensor,
    full: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """EE_ideal: the per-query oracle cut k_s^q (paper §2, Table 1).

    The least rank cut at the sentinel such that NDCG@k of the merged
    ranking (continuing documents take the full score, exited ones keep
    their partial) equals the full ensemble's. All ``D + 1`` cuts are
    evaluated as one ``[D+1, Q]`` grid (the reference maps over them); the
    first cut that reaches the full NDCG wins. Returns
    ``(continue_mask, cut [Q])``.
    """
    D = partial.shape[-1]
    sent_rank = rank_from_scores(partial, mask)
    ndcg_full = ndcg_at_k(full, labels, mask, k)                       # [Q]
    cuts = torch.arange(D + 1, device=partial.device)[:, None, None]
    cont = mask & (sent_rank < cuts)                                   # [D+1, Q, D]
    ndcgs = ndcg_at_k(torch.where(cont, full, partial), labels, mask, k)  # [D+1, Q]
    ok = ndcgs >= ndcg_full - 1e-9
    first = torch.argmax(ok.to(torch.int32), dim=0)                    # first True
    cut = torch.where(ok.any(dim=0), first, torch.full_like(first, D))
    return mask & (sent_rank < cut[:, None]), cut
