"""``ServiceStats.capacities``: the per-stage compaction capacities of every
batch, counted per distinct tuple, as the bucket's adaptive state picked
them (the tail's launches run at the last one); ``rows_compacted`` and
``rows_gated``: the rows of the compacted launches and those their counts
gated, read from the one packed read; the packed read itself: the stats,
top-k and scores each in its own type as the bytes of one buffer, held to
the float64 packing it replaced."""

import dataclasses
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
from repro_torch.serve import ranking_service as rs  # noqa: E402
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


# The packed read: the stats (float64), top-k (int64) and scores (float32)
# as the bytes of one buffer, unpacked as views. The oracle is the float64
# packing it replaced: top-k, scores and stats widened to float64, cast back
# on the host.


def _packed_f64(stats, top_idx, scores):
    return torch.cat([top_idx.reshape(-1).double(), scores.reshape(-1).double(), stats])


def _unpacked_f64(packed, S, Q, k, D):
    return (
        packed[Q * (k + D):],
        packed[:Q * k].astype(np.int64).reshape(Q, k),
        packed[Q * k:Q * (k + D)].astype(np.float32).reshape(Q, D),
    )


# Scores no forest of the tests gives: signed zero, subnormals (the least
# of either sign, 2**-130, the largest), the largest float32 and -inf.
EXTREMES = np.array(
    [-0.0, 1e-45, -1e-45, 2.0 ** -130, 1.1754942e-38, 3.4028235e38, -np.inf], np.float32
)


def _with_extremes(monkeypatch, S):
    """Every shard's scores start and end with ``EXTREMES``, and its stats
    carry counts past 2**24 (traversed, overflow, documents, exited)."""
    real = RankingService._rank_shard
    extremes = torch.as_tensor(EXTREMES)
    counts = torch.tensor([0.0] * S + [2.0 ** 40 + 3, 2.0 ** 24 + 1, 2.0 ** 25 + 3, 2.0 ** 24 + 5],
                          dtype=torch.float64)

    def shard(self, *args, **kw):
        top, scores, stats, result = real(self, *args, **kw)
        scores = scores.clone()
        flat = scores.view(-1)
        flat[:len(EXTREMES)] = extremes
        flat[-len(EXTREMES):] = extremes
        return top, scores, stats + counts, result

    monkeypatch.setattr(RankingService, "_rank_shard", shard)


@pytest.mark.parametrize("sentinels,mode,shards", [
    ((8,), "fused", 1), ((8,), "staged", 1), ((8, 28), "fused", 1), ((8, 28), "staged", 1),
    ((8,), "fused", 2), ((8, 28), "staged", 2),
])
def test_packed_read_is_bit_equal_to_the_float64_packing(monkeypatch, sentinels, mode, shards):
    _with_extremes(monkeypatch, len(sentinels))
    pl = placement.data_parallel(devices=["cpu"] * shards) if shards > 1 else None
    batches = list(_batches(40 + shards, 4, Q=4 * shards))
    svc, oracle = _service(sentinels, mode), _service(sentinels, mode)
    got = [svc.rank_batch(X, mask, placement=pl) for X, mask in batches]
    with monkeypatch.context() as m:
        m.setattr(rs, "_packed", _packed_f64)
        m.setattr(rs, "_unpacked", _unpacked_f64)
        want = [oracle.rank_batch(X, mask, placement=pl) for X, mask in batches]
    for (top, scores), (want_top, want_scores) in zip(got, want):
        assert (top.dtype, scores.dtype) == (np.int64, np.float32)
        assert (top.shape, scores.shape) == (want_top.shape, want_scores.shape)
        assert top.tobytes() == want_top.tobytes()
        assert scores.tobytes() == want_scores.tobytes()
        assert np.any((scores == 0) & np.signbit(scores))
        assert np.sum((scores != 0) & (np.abs(scores) < np.finfo(np.float32).tiny)) == 8 * shards
    assert dataclasses.asdict(svc.stats) == dataclasses.asdict(oracle.stats)
    assert svc.stats.overflow_docs == len(batches) * shards * (2 ** 24 + 1)
    assert svc.stats.trees_traversed > 2.0 ** 40 and svc.stats.reads_pinned == 0
    Q, D = batches[0][1].shape
    assert svc.bucket_state(Q, D) == oracle.bucket_state(Q, D)


@pytest.mark.parametrize("S,Q,k,D", [(1, 4, 10, 32), (2, 3, 5, 7), (3, 1, 1, 1), (2, 8, 32, 32)])
def test_packed_layout_and_views(S, Q, k, D):
    rng = np.random.default_rng(S * 100 + D)
    stats = torch.as_tensor(rng.integers(0, 2 ** 50, size=S + 4).astype(np.float64))
    top = torch.as_tensor(rng.integers(0, 2 ** 62, size=(Q, D)))[:, :k]   # sort's slice
    scores = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32))
    packed = rs._packed(stats, top, scores)
    assert packed.dtype == torch.uint8
    assert packed.numel() == 8 * (S + 4) + 8 * Q * k + 4 * Q * D
    got = rs._unpacked(packed.numpy(), S, Q, k, D)
    for view, want in zip(got, (stats, top, scores)):
        assert view.dtype == want.numpy().dtype and view.shape == tuple(want.shape)
        assert view.flags.c_contiguous and view.flags.aligned
        assert view.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("shards", [1, 2])
def test_an_answer_outlives_eight_later_calls(shards):
    svc = _service((8, 28), "staged")
    pl = placement.data_parallel(devices=["cpu"] * shards) if shards > 1 else None
    batches = list(_batches(50 + shards, 9, Q=4 * shards))
    top, scores = svc.rank_batch(*batches[0], placement=pl)
    kept = top.copy(), scores.copy()
    later = [svc.rank_batch(X, mask, placement=pl) for X, mask in batches[1:]]
    assert all(s.tobytes() != kept[1].tobytes() for _, s in later)
    assert top.tobytes() == kept[0].tobytes() and scores.tobytes() == kept[1].tobytes()
