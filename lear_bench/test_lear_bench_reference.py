"""The plain reference against the port's CPU path at the smoke config, and
the work count on hand-checked cases."""

import pytest

torch = pytest.importorskip("torch")

from lear_bench import check, generator, harness, reference, weights, work  # noqa: E402
from lear_bench.smallcell import LIMITS, small_cell  # noqa: E402


def _draw(cell, seed, device="cpu"):
    cfg = cell.config
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sentinels = harness.sentinels_of(cfg)
    F = cfg["n_features"]
    ranker = weights.draw_ranker(gen, cfg["n_trees"], cfg["depth"], F, dev)
    clfs = [
        weights.draw_classifier(cfg["classifier_seed"] + k, cfg["classifier_trees"],
                                cfg["classifier_depth"], F + 4, dev)
        for k in range(len(sentinels))
    ]
    pool = generator.make_pool(cell.traffic, F, seed, gen, dev)
    return ranker, clfs, pool, sentinels


def _program(ranker, clfs, sentinels, cfg, threshold, mode):
    from repro_torch.core.lear import LearClassifier
    from repro_torch.forest.ensemble import from_complete_arrays
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    def forest(w):
        return from_complete_arrays(*(w[k].numpy() for k in ("feature", "threshold", "leaf_value")),
                                    device="cpu")

    program_clfs = [LearClassifier(forest(c), s) for c, s in zip(clfs, sentinels)]
    return RankingService(
        forest(ranker), program_clfs[0],
        ServiceConfig(threshold=threshold, top_k=cfg["top_k"], execution_mode=mode,
                      launch_overhead_trees=64.0),
        extra_classifiers=program_clfs[1:], device="cpu",
    )


@pytest.mark.parametrize("sentinel2,mode", [(0, "fused"), (12, "fused"), (12, "staged")])
@pytest.mark.parametrize("threshold", [0.5, 0.52, 0.55])
def test_reference_holds_the_port_cpu_path(sentinel2, mode, threshold):
    cell = small_cell(sentinel2=sentinel2, queries=32)
    ranker, clfs, pool, sentinels = _draw(cell, seed=2**31 + 11)
    svc = _program(ranker, clfs, sentinels, cell.config, threshold, mode)
    for X, mask in pool.batches:
        top, scores = svc.rank_batch(X, mask)
        ref = reference.reference(X, mask, ranker, clfs, sentinels, threshold, 10, eps=5e-4)
        assert svc.stats.overflow_docs == 0   # overflowing survivors keep their prefix
        score_gap, topk_gap = check.score_gaps(scores, top, mask, ref)
        assert score_gap < 1e-5 and topk_gap < 1e-5
        assert 0 < ref.survivors[-1] < ref.real
        own = check.score_gaps(ref.scores.float().numpy(), ref.top.numpy(), mask, ref)
        assert own == (0.0, 0.0) or max(own) < 1e-6


def test_traversal_matches_the_ports_bitvector_scorer():
    from repro_torch.forest.ensemble import from_complete_arrays
    from repro_torch.forest.scoring import score_bitvector

    gen = torch.Generator().manual_seed(5)
    w = weights.draw_ranker(gen, 40, 5, 12, torch.device("cpu"))
    X = torch.randn((300, 12), generator=gen)
    ens = from_complete_arrays(*(w[k].numpy() for k in ("feature", "threshold", "leaf_value")),
                               device="cpu")
    ours = reference.forest_sum(X, w, 0, 40, torch.float64)
    theirs = score_bitvector(ens, X)
    torch.testing.assert_close(ours.float(), theirs, rtol=0, atol=1e-5)


def test_sentinel_features_match_the_ports():
    from repro_torch.core.features import augment_features

    gen = torch.Generator().manual_seed(9)
    p = torch.randn((6, 20), generator=gen)
    p[0, 3] = p[0, 7]                       # a tie: the lower slot ranks first
    alive = torch.rand((6, 20), generator=gen) < 0.7
    ours, lo, hi = reference.stage_features(p.double(), alive, 1e-4)
    theirs = augment_features(torch.zeros(6, 20, 0), p, alive)
    torch.testing.assert_close(ours.float(), theirs, rtol=0, atol=1e-6)
    inside = (lo <= ours) & (ours <= hi)
    assert bool(inside[alive].all())


def test_fragile_decisions_allow_both_branches():
    cell = small_cell(queries=32)
    ranker, clfs, pool, sentinels = _draw(cell, seed=3)
    X, mask = pool.batches[0]
    tight = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10, eps=1e-9)
    loose = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10, eps=0.5)
    assert tight.fragile < loose.fragile
    assert torch.equal(tight.scores, loose.scores)


def test_control_in_bfloat16_reads_far_from_the_reference():
    cell = small_cell(queries=32)
    ranker, clfs, pool, sentinels = _draw(cell, seed=4)
    X, mask = pool.batches[0]
    ref = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10, eps=LIMITS["score_gap"])
    low = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10, dtype=torch.bfloat16)
    gap, _ = check.score_gaps(low.scores.float().numpy(), low.top.numpy(), mask, ref)
    assert gap > LIMITS["score_gap"]


def test_work_count_by_hand():
    one = work.request_work(100, [30], (50,), 1047, 6, 10, 5, 136)
    # head 100·50·6, classifier 100·10·5, tail 30·997·6
    assert one.tests == 30000 + 5000 + 179460
    # features 100·136·4, ranker 1047·(63·8 + 64·4), classifier 10·(31·8 + 32·4), scores 100·4
    assert one.nbytes == 54400 + 795720 + 3760 + 400
    assert one.ops == 6 * one.tests
    two = work.request_work(100, [30, 10], (50, 150), 1047, 6, 10, 5, 136)
    # + middle 30·100·6 and second classifier 30·10·5; tail 10·897·6
    assert two.tests == 30000 + 5000 + 18000 + 1500 + 53820
    assert two.least_s == max(two.ops / work.ALU_OPS, two.nbytes / work.HBM_BW)


def test_work_count_reads_the_reference_not_the_program():
    """The count is a function of shapes and the reference's survivors: it
    equals a walk that counts every node test, and the program's own
    counters, which fused and staged runs move differently, never enter."""
    cell = small_cell(sentinel2=12, queries=32)
    ranker, clfs, pool, sentinels = _draw(cell, seed=8)
    X, mask = pool.batches[0]
    ref = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10)
    counted = work.request_work(ref.real, ref.survivors, sentinels, 24, 4, 4, 3, 16)
    tests = ref.real * (6 * 4 + 4 * 3)
    tests += ref.survivors[0] * ((12 - 6) * 4 + 4 * 3) + ref.survivors[1] * (24 - 12) * 4
    assert counted.tests == tests
    for mode in ("fused", "staged"):
        svc = _program(ranker, clfs, sentinels, cell.config, 0.5, mode)
        svc.rank_batch(X, mask)
        again = reference.reference(X, mask, ranker, clfs, sentinels, 0.5, 10)
        assert work.request_work(again.real, again.survivors, sentinels, 24, 4, 4, 3, 16) == counted


@pytest.mark.parametrize("draw", [
    {"draw": "poisson", "mean": 20, "min": 8, "max": 32},
    {"draw": "uniform", "min": 4, "max": 40},
])
def test_candidate_draws_stay_in_range_and_follow_the_seed(draw):
    traffic = dict(small_cell().traffic, candidates=draw)
    a = generator.candidate_counts(traffic, 2**31 + 3)
    assert (a == generator.candidate_counts(traffic, 2**31 + 3)).all()
    assert a.shape == (traffic["pool"], traffic["queries"])
    assert a.min() >= draw["min"] and a.max() <= traffic["slots"]


def test_open_loop_arrivals_follow_the_rate_and_the_seed():
    traffic = dict(small_cell().traffic, loop="open", rate=500.0)
    t = generator.arrivals(traffic, 2**31 + 5, 4.0)
    assert (t == generator.arrivals(traffic, 2**31 + 5, 4.0)).all()
    assert (t[1:] > t[:-1]).all() and 0 < t[0] and t[-1] < 4.0
    assert len(t) == pytest.approx(2000, rel=0.1)
    assert generator.arrivals(small_cell().traffic, 1, 4.0) is None


def test_host_inputs_are_numpy_with_the_device_draw():
    cell = small_cell()
    dev_pool = generator.make_pool(cell.traffic, 16, 7, torch.Generator().manual_seed(7), "cpu")
    traffic = dict(cell.traffic, inputs="host")
    host_pool = generator.make_pool(traffic, 16, 7, torch.Generator().manual_seed(7), "cpu")
    assert host_pool.device_bytes == 0
    assert dev_pool.device_bytes == sum(X.nbytes + m.nbytes for X, m in dev_pool.batches)
    for (X, m), (Xh, mh) in zip(dev_pool.batches, host_pool.batches):
        assert (X.numpy() == Xh).all() and (m.numpy() == mh).all()


def test_first_logits_give_the_first_stage_survivors():
    cell = small_cell(queries=32)
    ranker, clfs, pool, sentinels = _draw(cell, seed=2**31 + 13)
    X, mask = pool.batches[0]
    ref = reference.reference(X, mask, ranker, clfs, sentinels, 0.52, 10)
    th = torch.log(torch.tensor(0.52 / 0.48, dtype=torch.float64))
    assert ref.first_logits.shape == mask.shape
    assert int((ref.first_logits[mask] >= th).sum()) == ref.survivors[0]
