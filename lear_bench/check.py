"""What decides ``correct``: the program's answers against the reference's.

For each sampled request the program returned ``scores [Q, D]`` and ``top
[Q, k]``. Two numbers are compared, each with a limit a cell's file states:

- ``score_gap``: over the real documents, the largest distance from the
  program's score to the nearest value the reference allows the document
  (:class:`lear_bench.reference.Result` ``options``: the prefix of the stage
  that exits it, or the whole score of a survivor; both where its decision
  is fragile). A wrong exit decision misses by a tail's or a segment's sum;
  a wrong head, middle or tail score by its own error.
- ``topk_gap``: for each query and position ``j`` of the top-k, the
  distance between the reference value of the document the program put
  there and the ``j``-th largest reference value of the query. A slot that
  is out of range, repeated, or a padding slot ahead of a real document
  (a real document after the query's last one) reads infinite.

Each reference value used is the option nearest to the program's score.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lear_bench.reference import Result


def score_gaps(
    scores: np.ndarray, top: np.ndarray, mask: torch.Tensor, ref: Result
) -> tuple[float, float]:
    """``(score_gap, topk_gap)`` of one request's answer."""
    Q, D = mask.shape
    k = min(ref.top.shape[1], D)
    if scores.shape != (Q, D) or top.shape != (Q, k):
        return math.inf, math.inf
    mask = mask.cpu()
    opts = ref.options.cpu()
    s = torch.as_tensor(np.asarray(scores), dtype=torch.float64)
    dist = (s[..., None] - opts).abs()
    dist = torch.where(torch.isnan(dist), torch.full_like(dist, math.inf), dist)
    gap, pick = dist.min(dim=-1)
    score_gap = float(gap[mask].max()) if bool(mask.any()) else 0.0

    r = opts.gather(-1, pick[..., None])[..., 0]
    r = torch.where(mask & torch.isfinite(gap), r, torch.full_like(r, -math.inf))
    best = torch.sort(r, dim=-1, descending=True).values[:, :k]
    t = torch.as_tensor(np.asarray(top), dtype=torch.int64)
    in_range = (t >= 0) & (t < D)
    got = r.gather(1, t.clamp(0, D - 1))
    ordered = torch.sort(t, dim=1).values
    repeated = (ordered[:, 1:] == ordered[:, :-1]).any(dim=1, keepdim=True)
    n_real = mask.sum(dim=1, keepdim=True)
    pos = torch.arange(k)[None, :]
    real_slot = pos < n_real
    diff = (got - best).abs()
    gap_k = torch.where(real_slot, diff, torch.zeros_like(diff))
    wrong_kind = torch.where(real_slot, ~torch.isfinite(got), torch.isfinite(got))
    bad = ~in_range | repeated | wrong_kind
    gap_k = torch.where(bad, torch.full_like(gap_k, math.inf), gap_k)
    topk_gap = float(gap_k.max()) if gap_k.numel() else 0.0
    return score_gap, topk_gap


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(numbers[name] <= limit for name, limit in limits.items())
