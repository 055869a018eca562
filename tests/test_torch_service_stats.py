"""``ServiceStats.capacities``: the per-stage compaction capacities of every
batch, counted per distinct tuple, as the bucket's adaptive state picked
them (the tail's launches run at the last one); ``rows_compacted`` and
``rows_gated``: the rows of the compacted launches and those their counts
gated, read from the one packed read."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.core.stage import DenseStage  # noqa: E402
from repro_torch.core.strategies import dense_keep_fraction  # noqa: E402
from repro_torch.forest.ensemble import random_ensemble  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import placement  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.utils import count_host_transfers  # noqa: E402

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


# ``rows_compacted`` / ``rows_gated``: the rows of the range launches on
# compacted blocks, and those at or past each launch's count, held to what
# a spy on the kernel wrapper saw launched.


def _service(sentinels, mode, dense=False, threshold=0.5, n_trees=48):
    clfs = [
        LearClassifier(random_ensemble(10 + i, 6, 3, F + 4, device="cpu"), s)
        for i, s in enumerate(sentinels)
    ]
    ds = None
    if dense:
        ds = DenseStage(scorer=lambda x: x[:, 0],
                        policy=functools.partial(dense_keep_fraction, keep_frac=0.6))
    return RankingService(
        random_ensemble(0, n_trees, 4, F, device="cpu"), clfs[0],
        ServiceConfig(threshold=threshold, execution_mode=mode, launch_overhead_trees=0.0,
                      dense_stage=ds),
        extra_classifiers=clfs[1:], device="cpu",
    )


def _batches(seed, n, Q=4, D=32):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        X = rng.normal(size=(Q, D, F)).astype(np.float32)
        yield X, np.arange(D)[None, :] < rng.integers(D // 2, D + 1, size=(Q, 1))


def _gated_launches(monkeypatch):
    """``(rows, n_valid)`` of every gated launch of the range kernel."""
    seen, kernel = [], ops.forest_score_kernel

    def spy(x, *args, n_valid=None, **kw):
        if n_valid is not None:
            seen.append((x.shape[0], int(n_valid)))
        return kernel(x, *args, n_valid=n_valid, **kw)

    monkeypatch.setattr(ops, "forest_score_kernel", spy)
    return seen


@pytest.mark.parametrize("sentinels,mode,dense,threshold", [
    ((8,), "fused", False, 0.5),          # the tail alone
    ((8, 28), "staged", False, 0.5),      # the middle segment and the tail
    ((8, 28), "fused", False, 0.5),       # the segmented head is not compacted
    ((8,), "fused", False, 0.02),         # the tail overflows its capacity
    ((8,), "fused", True, 0.5),           # the plain head on the dense gate's block
    ((8, 28), "staged", True, 0.5),
    ((8, 28), "fused", True, 0.5),        # the segmented head on it: not gated
    ((8, 48), "staged", False, 0.5),      # no tail: the middle alone
])
def test_gated_rows_count_what_the_launches_skipped(monkeypatch, sentinels, mode, dense,
                                                    threshold):
    svc = _service(sentinels, mode, dense, threshold)
    seen = _gated_launches(monkeypatch)
    for X, mask in _batches(len(sentinels), 3):
        svc.rank_batch(X, mask)
    s = svc.stats
    assert s.rows_compacted == sum(rows for rows, _ in seen) > 0
    assert s.rows_gated == sum(max(0, rows - n) for rows, n in seen)
    assert s.gated_share == s.rows_gated / s.rows_compacted
    if threshold < 0.1:   # the first batch's tail overflowed: none of its rows gated
        assert s.overflow_docs > 0 and seen[0][1] > seen[0][0]
        assert s.rows_gated == sum(max(0, rows - n) for rows, n in seen[1:])
    else:
        assert 0 < s.rows_gated < s.rows_compacted


@pytest.mark.parametrize("mode,dense,shards", [
    ("fused", False, 1), ("staged", False, 1), ("fused", True, 1), ("staged", True, 1),
    ("staged", False, 2),
])
def test_trees_traversed_are_reckoned_once_a_shard(monkeypatch, mode, dense, shards):
    """The cascade's accounting runs once a shard a batch, and the service
    packs that result: it reckons no traversal of its own."""
    from repro_torch.core import cascade
    from repro_torch.metrics import speedup
    from repro_torch.serve import ranking_service

    calls, real = [], speedup.trees_traversed_progressive

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    for module in (speedup, cascade, ranking_service):
        if hasattr(module, "trees_traversed_progressive"):
            monkeypatch.setattr(module, "trees_traversed_progressive", spy)
    svc = _service((8, 28), mode, dense)
    pl = placement.data_parallel(devices=["cpu"] * shards) if shards > 1 else None
    batches = list(_batches(7, 3, Q=4 * shards))
    for X, mask in batches:
        svc.rank_batch(X, mask, placement=pl)
    assert len(calls) == shards * len(batches)
    assert svc.stats.trees_traversed > 0


def test_two_shards_count_the_same_as_one_batch():
    single, split = _service((8, 28), "staged"), _service((8, 28), "staged")
    pl = placement.data_parallel(devices=["cpu"] * 2)
    for X, mask in _batches(5, 3, Q=8):
        single.rank_batch(X, mask)
        split.rank_batch(X, mask, placement=pl)
    assert split.stats.rows_compacted == single.stats.rows_compacted > 0
    assert split.stats.rows_gated == single.stats.rows_gated > 0


def test_the_counters_take_no_extra_host_read():
    svc = _service((8, 28), "staged")
    batches = list(_batches(6, 3))
    svc.rank_batch(*batches[0])
    with count_host_transfers() as counts:
        for X, mask in batches[1:]:
            svc.rank_batch(torch.as_tensor(X), torch.as_tensor(mask))
    assert counts.explicit_gets == 2 and counts.implicit_syncs == 0, counts.sites
    assert svc.stats.rows_gated > 0
