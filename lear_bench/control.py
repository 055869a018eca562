"""The control: the reference put in the program's place, in bfloat16.

The configurations state float32; the nearest precision below is
bfloat16 (no matrix product runs here, so TF32 has nothing to change). The
control computes the cascade of :mod:`lear_bench.reference` with the
features, thresholds, leaves and sums in bfloat16 and answers the window's
requests with its own decisions' scores and top-k. The comparison that
decides ``correct`` has to find it wrong.
"""

from __future__ import annotations

import numpy as np
import torch

from lear_bench import reference


class ControlService:
    """A stand-in for ``RankingService`` with ``rank_batch`` in bfloat16."""

    def __init__(
        self, ranker: dict, clfs: list[dict], sentinels: tuple[int, ...], cfg: dict,
        threshold: float, dev: object,
    ) -> None:
        self.args = (ranker, clfs, sentinels, threshold, cfg["top_k"])
        self.dev = dev

    def rank_batch(self, X: torch.Tensor, mask: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        ranker, clfs, sentinels, threshold, k = self.args
        X, mask = (torch.as_tensor(a, device=self.dev) for a in (X, mask))
        r = reference.reference(X, mask, ranker, clfs, sentinels, threshold, k,
                                dtype=torch.bfloat16)
        return r.top.cpu().numpy(), r.scores.float().cpu().numpy()
