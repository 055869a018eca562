"""``ServiceStats.capacities``: the per-stage compaction capacities of every
batch, counted per distinct tuple, as the bucket's adaptive state picked
them (the tail's launches run at the last one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.forest.ensemble import random_ensemble  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402

F = 12


@pytest.mark.parametrize("sentinels", [(8,), (8, 28)])
def test_capacities_count_each_batchs_pick(sentinels):
    clfs = [
        LearClassifier(random_ensemble(10 + i, 6, 3, F + 4, device="cpu"), s)
        for i, s in enumerate(sentinels)
    ]
    svc = RankingService(
        random_ensemble(0, 48, 4, F, device="cpu"), clfs[0],
        ServiceConfig(execution_mode="fused", launch_overhead_trees=0.0),
        extra_classifiers=clfs[1:], device="cpu",
    )
    rng = np.random.default_rng(0)
    picked = []
    for Q, D in ((2, 64), (4, 32), (2, 64), (8, 128)):
        svc._active_key = (Q, D)
        picked.append(tuple(svc._pick_capacities(Q * D)))
        X = rng.normal(size=(Q, D, F)).astype(np.float32)
        svc.rank_batch(X, np.arange(D)[None, :] < rng.integers(1, D + 1, size=(Q, 1)))
    want: dict[tuple[int, ...], int] = {}
    for caps in picked:
        assert len(caps) == len(sentinels)
        want[caps] = want.get(caps, 0) + 1
    assert svc.stats.capacities == want
    assert sum(svc.stats.capacities.values()) == svc.stats.batches == 4
