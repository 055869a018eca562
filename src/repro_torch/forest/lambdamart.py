"""LambdaRank gradients with |ΔNDCG| weighting (λ-MART objective).

The port of :mod:`repro.forest.lambdamart`. Standard Burges-style lambdas:
for a document pair (i, j) with ``label_i > label_j`` in the same query,

    ρ_ij  = 1 / (1 + exp(σ (s_i − s_j)))
    λ_ij  = −σ · ρ_ij · |ΔNDCG_ij|
    g_i  += λ_ij,  g_j −= λ_ij
    h_i  += σ² · ρ_ij (1 − ρ_ij) · |ΔNDCG_ij|   (and the same for j)

|ΔNDCG_ij| is the NDCG@k change from swapping i and j in the *current*
ranking. The computation is vectorized over padded ``[Q, D]`` blocks with
``[chunk, D, D]`` pairwise intermediates, a chunk of 64 queries at a time
as in the reference, to bound the working set. Sums over the pairs run in
torch's order, not XLA's: the lambdas agree with the reference within
1e-5, not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.metrics.ranking import gain, rank_from_scores

SIGMA = 1.0


def _ideal_dcg(labels: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Ideal DCG@k per query of ``[Q, D]`` labels → ``[Q]``."""
    masked = torch.where(mask, labels.float(), torch.full_like(labels.float(), -torch.inf))
    top = torch.topk(masked, k, dim=-1).values
    disc = 1.0 / torch.log2(torch.arange(k, dtype=torch.float32, device=labels.device) + 2.0)
    g = torch.where(torch.isfinite(top), gain(top), torch.zeros_like(top))
    return (g * disc).sum(dim=-1)


def _per_queries(scores, labels, mask, k: int):
    """Lambda gradients for a block of queries: ``[c, D]`` → ``([c, D], [c, D])``."""
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    ranks = rank_from_scores(scores, mask)
    # Discount at each doc's current rank; 0 beyond the NDCG cutoff.
    disc = torch.where(ranks < k, 1.0 / torch.log2(ranks.float() + 2.0), zero)
    gains = torch.where(mask, gain(labels), zero)
    idcg = _ideal_dcg(labels, mask, k)
    inv_idcg = torch.where(idcg > 0, 1.0 / torch.clamp_min(idcg, 1e-12), zero)

    # Pairwise: swap i and j ⇒ ΔDCG = (gain_i − gain_j) (disc_i − disc_j).
    dgain = gains[:, :, None] - gains[:, None, :]               # [c, D, D]
    ddisc = disc[:, :, None] - disc[:, None, :]
    delta = torch.abs(dgain * ddisc) * inv_idcg[:, None, None]

    sdiff = scores[:, :, None] - scores[:, None, :]
    rho = torch.sigmoid(-SIGMA * sdiff)                          # 1/(1+e^{σ(si−sj)})
    pair_valid = (
        (labels[:, :, None] > labels[:, None, :])
        & mask[:, :, None] & mask[:, None, :]
    )
    lam = torch.where(pair_valid, -SIGMA * rho * delta, zero)
    hess = torch.where(pair_valid, SIGMA * SIGMA * rho * (1 - rho) * delta, zero)

    # g_i accumulates λ_ij over j it beats, and −λ_ji over j that beat it.
    g = lam.sum(dim=2) - lam.sum(dim=1)
    h = hess.sum(dim=2) + hess.sum(dim=1)
    return g, torch.clamp_min(h, 1e-6)


def lambda_grad_hess(
    scores: torch.Tensor,   # [Q, D] f32
    labels: torch.Tensor,   # [Q, D] graded relevance (float)
    mask: torch.Tensor,     # [Q, D] bool
    k: int = 10,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lambdas over padded ``[Q, D]`` blocks, ``chunk`` queries at a time."""
    labels = labels.float()
    gs, hs = [], []
    for q0 in range(0, scores.shape[0], chunk):
        sl = slice(q0, q0 + chunk)
        g, h = _per_queries(scores[sl], labels[sl], mask[sl], k)
        gs.append(g)
        hs.append(h)
    return torch.cat(gs), torch.cat(hs)
