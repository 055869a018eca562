"""LEAR's sentinel-time features, built on the device.

The port of :mod:`repro.core.features`. LEAR's exit decision reads four
features appended to each query-document vector: the partial score at the
sentinel, its rank within the query, the per-query min–max-normalized
partial, and the query's candidate count. They are built between the head
launch and the classifier launch without a host round trip.

- :func:`query_ranks` is sort-free: rank(i) = the number of documents that
  beat ``i`` (strictly higher score, or an equal score at a lower index),
  the same order as the stable-sort ranking of
  :func:`repro_torch.metrics.ranking.rank_from_scores`. The **direct**
  compare builds the ``[Q, D, D]`` predicate; the **blocked** compare tiles
  it into ``[RANK_BLOCK_D, RANK_BLOCK_D]`` chunks so the working set stops
  growing with D². Both count the same pairs, so they are bit-exact;
  ``"auto"`` picks blocked above ``RANK_BLOCKED_MIN_D`` candidates.
  Both are the plain path, which every device but a CUDA card runs.
  :func:`rank_plan` gives the pick with the pairs and tiles it evaluates;
  the blocked compare runs in an ``engine.ranks`` span.
- :func:`query_minmax` / :func:`normalized_partial`: masked per-query
  min/max and a clipped normalization.
- :func:`augment_features` appends the four to ``X``. Where
  :func:`rank_plan` gives ``"fused"`` (a CUDA tensor) it is one launch of
  :func:`repro_torch.kernels.sentinel_features.sentinel_features_kernel`
  (ranks, min–max, count and copy, no ``[Q, D, D]`` predicate in memory),
  bit for bit :func:`augment_features_plain`, which every other device
  runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sentinel_features import sentinel_features_kernel
from repro_torch.tracing import span

N_AUG = 4    # sentinel-time features appended to the q-d vector
NEG = -1e30  # masked-document fill; ranks padding after every real doc

RANK_BLOCK_D = 128  # tile edge of the blocked pairwise-count compare
# The plain path's cutoff: direct up to this many candidates, blocked above
# (the reference's, set by the [Q, D, D] working set). A CUDA card runs
# neither compare.
RANK_BLOCKED_MIN_D = 256


def rank_plan(
    D: int, method: str = "auto", device: torch.device | str | None = None
) -> tuple[str, int, int]:
    """What the rank compare of a query of ``D`` slots does: ``(method,
    pairs, tiles)``, the method ``"auto"`` resolves to, the pairs its
    compare spans (``D²``, or the tile-padded ``D`` squared when blocked)
    and the tile pairs it runs (1 when direct or fused). On a CUDA
    ``device`` ``"auto"`` is ``"fused"``: the sentinel-features kernel's
    compare inside :func:`augment_features`, ``D²`` pairs in its one launch.
    Elsewhere it is the plain path's ``"direct"`` or ``"blocked"``, the
    only methods that may be asked for by name."""
    if method == "auto":
        if device is not None and torch.device(device).type == "cuda":
            return "fused", D * D, 1
        method = "blocked" if D > RANK_BLOCKED_MIN_D else "direct"
    if method == "direct":
        return method, D * D, 1
    if method != "blocked":
        raise ValueError(f"query_ranks method {method!r}")
    n_blocks = -(-D // RANK_BLOCK_D)
    return method, (n_blocks * RANK_BLOCK_D) ** 2, n_blocks * n_blocks


def query_ranks(
    partial: torch.Tensor, mask: torch.Tensor, *, method: str = "auto"
) -> torch.Tensor:
    """Sort-free per-query rank (0 = best) of each document → ``[Q, D]``."""
    D = partial.shape[-1]
    method, _, tiles = rank_plan(D, method)
    if method == "blocked":
        # The direct compare, a few ops on the whole grid, stays in its
        # caller's span.
        with span("engine.ranks", method=method, D=D, tiles=tiles):
            return query_ranks_blocked(partial, mask)
    return query_ranks_direct(partial, mask)


def _beats(
    rows: torch.Tensor, ridx: torch.Tensor, cols: torch.Tensor, cidx: torch.Tensor
) -> torch.Tensor:
    """``beats[..., i, j]``: column doc ``j`` outranks row doc ``i``."""
    r = rows[..., :, None]
    c = cols[..., None, :]
    return (c > r) | ((c == r) & (cidx[None, :] < ridx[:, None]))


def query_ranks_direct(partial: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One-shot pairwise count over the full ``[Q, D, D]`` predicate."""
    s = torch.where(mask, partial, torch.full_like(partial, NEG))
    idx = torch.arange(s.shape[-1], device=s.device)
    return _beats(s, idx, s, idx).sum(dim=-1, dtype=torch.int32)


def query_ranks_blocked(
    partial: torch.Tensor, mask: torch.Tensor, block_d: int = RANK_BLOCK_D
) -> torch.Tensor:
    """Pairwise count tiled into ``[block_d, block_d]`` chunks — the same
    ranks as :func:`query_ranks_direct`. The score axis is padded with
    ``-inf`` to a tile multiple: a padding column never beats a real row
    (below every real score, ``NEG`` included, and above every real index)
    and padding rows are dropped."""
    s = torch.where(mask, partial, torch.full_like(partial, NEG))
    D = s.shape[-1]
    lead = s.shape[:-1]
    s2 = s.reshape(-1, D)
    n_blocks = -(-D // block_d)
    D_pad = n_blocks * block_d
    if D_pad != D:
        pad = torch.full((s2.shape[0], D_pad - D), -torch.inf, device=s.device)
        s2 = torch.cat([s2, pad], dim=1)
    out = torch.zeros(s2.shape, dtype=torch.int32, device=s.device)
    tile = torch.arange(block_d, device=s.device)
    for bi in range(n_blocks):
        rows = s2[:, bi * block_d:(bi + 1) * block_d]
        cnt = torch.zeros(rows.shape, dtype=torch.int32, device=s.device)
        for bj in range(n_blocks):
            cols = s2[:, bj * block_d:(bj + 1) * block_d]
            beats = _beats(rows, bi * block_d + tile, cols, bj * block_d + tile)
            cnt = cnt + beats.sum(dim=-1, dtype=torch.int32)
        out[:, bi * block_d:(bi + 1) * block_d] = cnt
    return out[:, :D].reshape(*lead, D)


def query_minmax(
    partial: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query min/max of the partial score over real documents →
    ``([Q, 1], [Q, 1])``; an all-masked query gives ``lo > hi``."""
    lo = torch.where(mask, partial, torch.full_like(partial, torch.inf))
    hi = torch.where(mask, partial, torch.full_like(partial, -torch.inf))
    return lo.amin(dim=-1, keepdim=True), hi.amax(dim=-1, keepdim=True)


def normalized_partial(
    partial: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Min–max normalization of the partial score, clipped to [0, 1]."""
    norm = (partial - lo) / torch.clamp_min(hi - lo, 1e-9)
    return torch.clamp(norm, 0.0, 1.0)


def augment_features(
    X: torch.Tensor,        # [Q, D, F]
    partial: torch.Tensor,  # [Q, D]
    mask: torch.Tensor,     # [Q, D]
) -> torch.Tensor:
    """Append the four sentinel-time features → ``[Q, D, F + 4]``: one
    kernel launch where :func:`rank_plan` gives ``"fused"`` (a CUDA
    tensor), :func:`augment_features_plain` elsewhere."""
    if rank_plan(X.shape[-2], device=X.device)[0] == "fused":
        return sentinel_features_kernel(X.contiguous(), partial.contiguous(), mask.contiguous())
    return augment_features_plain(X, partial, mask)


def augment_features_plain(
    X: torch.Tensor,        # [Q, D, F]
    partial: torch.Tensor,  # [Q, D]
    mask: torch.Tensor,     # [Q, D]
) -> torch.Tensor:
    """The plain version of :func:`augment_features`: PyTorch ops over the
    ``[Q, D, D]`` rank compare (:func:`query_ranks`), what the kernel is
    held to."""
    ranks = query_ranks(partial, mask).float()
    lo, hi = query_minmax(partial, mask)
    norm = normalized_partial(partial, lo, hi)
    n_cand = mask.sum(dim=-1, keepdim=True).float()
    aug = torch.stack(
        [partial, ranks, norm, n_cand.expand_as(partial)], dim=-1
    )
    aug = torch.where(mask[..., None], aug, torch.zeros_like(aug))
    return torch.cat([X, aug], dim=-1)
