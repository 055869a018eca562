"""Port parity: the serving tier — continuous batching, warmup, rungs,
placement — against single-query serving and the reference tier.

- batched serving is bit-exact with single-query ``rank_batch`` and with
  the reference's batcher on the same queries (padding rows are inert;
  the per-request top-k keeps ``lax.top_k``'s order);
- the flush policy triggers on full buckets and on the wait deadline;
- warmup leaves no first touch for the warmed shapes at any installed
  rung (``first_touches()``; on the CPU the ``padded_forest`` misses),
  no cold-start overflow, clean stats and no EMA, and keeps the seeded
  peaks — the state the reference's warmup leaves;
- a degraded rung is bit-exact with a standalone service at the rung's
  config, in the port and in the reference;
- the single-device placement is the plain path, and the mesh placements
  (``local``, ``data_parallel``) serve the same batch bit for bit.

Threaded tests run on a virtual clock (``tests/torch_faults.py``) and
every wait is bounded.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from faults import FakeClock as RefFakeClock  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import degradation as ref_degradation  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro.serve import warmup as ref_warmup  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.core.strategies import QueryExitConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.serve import placement  # noqa: E402
from repro_torch.serve.batching import BucketPolicy, ContinuousBatcher  # noqa: E402
from repro_torch.serve.degradation import DegradationPolicy, ExitRung  # noqa: E402
from repro_torch.serve.errors import BatcherStopped  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.serve.tier import ServingTier, TierConfig  # noqa: E402
from repro_torch.serve.warmup import enable_persistent_cache, warmup_service  # noqa: E402
from torch_faults import FakeClock, settle  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

F = 12
RUNG_QE = (ref_strategies.QueryExitConfig(k=5, margin=2.0), QueryExitConfig(k=5, margin=2.0))


def _services(sentinels=(8, 28), threshold=0.4, mode="fused", query_exit=(None, None),
              gate=True):
    """The reference's and the port's service over the same forests."""
    ens = ref_ensemble.random_ensemble(0, n_trees=64, depth=4, n_features=F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4), s
        )
        for i, s in enumerate(sentinels)
    ]
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=threshold, execution_mode=mode, launch_overhead_trees=512.0,
            query_exit=query_exit[0],
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(
            threshold=threshold, execution_mode=mode, launch_overhead_trees=512.0,
            query_exit=query_exit[1],
        ),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    if gate:
        # The reference tests' deterministic stage gate: continue ⇔
        # feature 0 positive, so survivor counts are exact.
        for svc in (ref, port):
            svc.stage_strategies = [
                lambda p, m, features=None: m & (features[..., 0] > 0.0)
            ] * len(sentinels)
    return ref, port


def _queries(rng, n, lo=20, hi=32):
    return [
        rng.normal(size=(int(rng.integers(lo, hi + 1)), F)).astype(np.float32)
        for _ in range(n)
    ]


def _alone(svc, q):
    top, scores = svc.rank_batch(q[None], np.ones((1, q.shape[0]), bool))
    return np.asarray(top)[0][: min(svc.top_k, q.shape[0])], np.asarray(scores)[0]


def test_policy_buckets_match_reference():
    p = BucketPolicy(max_queries=8, min_docs=8, max_docs=256)
    r = ref_batching.BucketPolicy(max_queries=8, min_docs=8, max_docs=256)
    assert p.doc_bucket(1) == 8 and p.doc_bucket(9) == 16 and p.doc_bucket(256) == 256
    assert p.query_bucket(3) == 4 and p.query_bucket(100) == 8
    for counts in ((20, 30), (20, 100), (1, 256, 64)):
        assert p.buckets(counts) == r.buckets(counts)
    with pytest.raises(ValueError):
        BucketPolicy(max_queries=6)
    with pytest.raises(ValueError):
        p.doc_bucket(257)


def test_batcher_is_bitexact_with_single_queries_and_the_reference_tier():
    """12 ragged queries → 3 full flushes of 4; every response equals the
    query served alone, and the reference batcher's response."""
    rng = np.random.default_rng(0)
    queries = _queries(rng, 12)
    ref, port = _services()
    policy = dict(max_queries=4, max_wait_ms=50.0)
    b = ContinuousBatcher(port, F, BucketPolicy(**policy), clock=FakeClock())
    rb = ref_batching.ContinuousBatcher(
        ref, F, ref_batching.BucketPolicy(**policy), clock=RefFakeClock()
    )
    b.start()
    rb.start()
    got, _ = settle([b.submit(q) for q in queries], timeout_s=120)
    want, _ = settle([rb.submit(q) for q in queries], timeout_s=120)
    b.stop()
    rb.stop()
    assert b.stats.completed == 12 and b.stats.failed == 0
    assert b.stats.flushes_full == 3 and port.stats.batches == 3
    assert port.stats.queries == 12
    alone_ref, alone_port = _services()
    for q, (top, scores), (w_top, w_scores) in zip(queries, got, want, strict=True):
        a_top, a_scores = _alone(alone_port, q)
        np.testing.assert_array_equal(scores, a_scores)
        np.testing.assert_array_equal(top, a_top)
        np.testing.assert_array_equal(scores, w_scores)
        np.testing.assert_array_equal(top, w_top)
        assert top.dtype == w_top.dtype == np.int32
        np.testing.assert_array_equal(scores, _alone(alone_ref, q)[1])


def test_deadline_flush_frees_a_lone_query():
    clock = FakeClock()
    _, svc = _services()
    b = ContinuousBatcher(svc, F, BucketPolicy(max_queries=8, max_wait_ms=5.0), clock=clock)
    b.start()
    fut = b.submit(np.random.default_rng(1).normal(size=(16, F)).astype(np.float32))
    clock.advance(0.006)
    top, scores = fut.result(timeout=60)
    b.stop()
    assert scores.shape == (16,) and top.shape == (10,)
    assert b.stats.flushes_deadline == 1 and b.stats.flushes_full == 0
    assert svc.stats.batches == 1


def test_batcher_propagates_engine_errors():
    _, svc = _services()

    def boom(*a, **k):
        raise RuntimeError("boom")

    svc.rank_batch = boom
    b = ContinuousBatcher(svc, F, BucketPolicy(max_queries=2), clock=FakeClock())
    b.start()
    futs = [b.submit(np.zeros((8, F), np.float32)) for _ in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=60)
    b.stop()
    assert b.stats.failed == 2 and b.stats.completed == 0


def _dense_batch(Qb, Db, seed):
    X = np.random.default_rng(seed).normal(size=(Qb, Db, F)).astype(np.float32)
    X[..., 0] = 1.0  # every document survives every stage
    return X, np.ones((Qb, Db), bool)


def test_warmup_leaves_no_first_touch_and_no_cold_start_overflow():
    """After warmup of (2, 64): a dense batch of that shape adds no first
    touch and no overflow, and the state equals the reference's."""
    ref, svc = _services(mode="auto")
    report = warmup_service(svc, F, [(2, 64)])
    ref_warmup.warmup_service(ref, F, [(2, 64)])
    assert report.buckets == [(2, 64)] and report.total_seconds > 0
    assert svc.stats.batches == 0
    state, ref_state = svc.bucket_state(2, 64), ref.bucket_state(2, 64)
    assert state.peaks == ref_state.peaks == [128, 128]
    assert state.ema is None and ref_state.ema is None
    X, mask = _dense_batch(2, 64, 2)
    before = fs.first_touches()
    for _ in range(2):
        top, scores = svc.rank_batch(X, mask)
        want_top, want_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_array_equal(scores, np.asarray(want_scores))
        np.testing.assert_array_equal(top, np.asarray(want_top))
    assert fs.first_touches() == before
    assert svc.stats.overflow_docs == 0
    # Without warmup the same batch overflows its cold-start capacity and
    # builds its buffers on the request.
    _, cold = _services(mode="auto")
    cold.rank_batch(X, mask)
    assert cold.stats.overflow_docs > 0
    assert fs.first_touches()["padded_forest"] > before["padded_forest"]


def _ladder(svc, pkg_qe):
    return (ExitRung("tight", threshold=0.7),
            ExitRung("margin", threshold=0.9, query_exit=pkg_qe))


def test_rung_warmup_leaves_no_first_touch_at_any_rung():
    _, svc = _services(gate=False)
    svc.install_rungs(_ladder(svc, RUNG_QE[1]))
    report = warmup_service(svc, F, [(1, 32)])
    assert report.rungs_warmed == 3 and svc.rung_level == 0
    assert svc.stats.batches == 0
    # One buffer set per forest serves every rung: nothing can be evicted.
    forests = [svc.ensemble, *(c.forest for c in svc.stage_classifiers)]
    assert [len(f._padded_cache) for f in forests] == [1] * len(forests)
    X = np.random.default_rng(5).normal(size=(1, 32, F)).astype(np.float32)
    mask = np.ones((1, 32), bool)
    before = fs.first_touches()
    for level in (0, 1, 2, 1, 0):
        svc.set_rung(level)
        svc.rank_batch(X, mask)
    assert fs.first_touches() == before


def test_degraded_rung_is_bitexact_with_standalone_config():
    """Serving at rung N is the computation of a service built with that
    rung's knobs, in the port and in the reference."""
    ref, svc = _services(sentinels=(8,), gate=False)
    svc.install_rungs((
        ExitRung("tight", threshold=0.7),
        ExitRung("margin", threshold=0.7, query_exit=RUNG_QE[1]),
    ))
    ref.install_rungs((
        ref_degradation.ExitRung("tight", threshold=0.7),
        ref_degradation.ExitRung("margin", threshold=0.7, query_exit=RUNG_QE[0]),
    ))
    X = np.random.default_rng(3).normal(size=(1, 32, F)).astype(np.float32)
    mask = np.ones((1, 32), bool)
    for level, qe in ((1, (None, None)), (2, RUNG_QE), (0, (None, None))):
        threshold = 0.4 if level == 0 else 0.7
        svc.set_rung(level)
        ref.set_rung(level)
        top, scores = svc.rank_batch(X, mask)
        r_top, r_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        alone_ref, alone = _services(sentinels=(8,), threshold=threshold, query_exit=qe, gate=False)
        a_top, a_scores = alone.rank_batch(X, mask)
        np.testing.assert_array_equal(scores, a_scores)
        np.testing.assert_array_equal(top, a_top)
        np.testing.assert_array_equal(scores, np.asarray(r_scores))
        np.testing.assert_array_equal(top, np.asarray(r_top))
        w_top, w_scores = alone_ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_array_equal(scores, np.asarray(w_scores))
    assert svc.rung_names == ("baseline", "tight", "margin")
    assert svc.query_exit is None and svc.threshold == 0.4


def test_rung_ladder_misuse_raises():
    _, svc = _services()
    with pytest.raises(RuntimeError, match="install_rungs"):
        svc.set_rung(1)
    # A dense_keep_frac rung needs a dense stage (tests/test_torch_hybrid.py
    # serves one); this service has none.
    with pytest.raises(ValueError, match="no dense stage"):
        svc.install_rungs((ExitRung("dense", dense_keep_frac=0.5),))
    svc.install_rungs((ExitRung("tight", threshold=0.7),))
    assert svc.n_rungs == 2
    with pytest.raises(ValueError):
        svc.set_rung(2)
    with pytest.raises(RuntimeError, match="already"):
        svc.install_rungs((ExitRung("tight", threshold=0.7),))


def test_tier_end_to_end_stats_and_drain():
    clock = FakeClock()
    _, svc = _services()
    tier = ServingTier(
        svc, F, TierConfig(doc_counts=(32,), persistent_cache=False),
        policy=BucketPolicy(max_queries=2, max_wait_ms=20.0), clock=clock,
    )
    tier.start()
    assert tier.warmup_report.buckets == [(1, 32), (2, 32)]
    rng = np.random.default_rng(3)
    futs = [tier.submit(q) for q in _queries(rng, 5)]
    clock.advance(0.021)  # the fifth query flushes on its wait deadline
    res, errors = settle(futs, timeout_s=120)
    tier.stop()
    assert len(res) == 5 and errors == []
    s = tier.stats()
    assert s["batcher"]["completed"] == 5
    assert s["batcher"]["flushes_full"] == 2 and s["batcher"]["flushes_deadline"] == 1
    assert s["service"]["queries"] == 5 and s["service"]["overflow_docs"] == 0
    assert s["warmup_seconds"] > 0 and s["n_devices"] == 1
    with pytest.raises(BatcherStopped):
        tier.submit(_queries(rng, 1)[0])
    h = tier.health()
    assert h["state"] == "stopped" and h["queue_depth"] == 0
    assert h["crashes"] == 0 and not h["started"]
    assert h["p99_ms"] >= h["p50_ms"] >= 0.0


def test_tier_installs_and_warms_every_rung():
    _, svc = _services()
    tier = ServingTier(
        svc, F,
        TierConfig(
            doc_counts=(16,), persistent_cache=False,
            degradation=DegradationPolicy(rungs=_ladder(svc, RUNG_QE[1])),
        ),
        policy=BucketPolicy(max_queries=1), clock=FakeClock(),
    )
    tier.start()
    try:
        assert svc.n_rungs == 3 and tier.warmup_report.rungs_warmed == 3
        assert tier.health()["degradation"]["rung"] == "baseline"
        q = np.random.default_rng(4).normal(size=(16, F)).astype(np.float32)
        top, scores = tier.submit(q).result(timeout=60)
        np.testing.assert_array_equal(scores, _alone(_services()[1], q)[1])
    finally:
        tier.stop()


def test_single_device_placement_is_the_plain_path():
    pl = placement.single_device()
    assert pl.n_devices == 1
    X = np.random.default_rng(4).normal(size=(2, 32, F)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    Xt, mt = pl.put(X, mask, torch.device("cpu"))
    assert Xt.dtype == torch.float32 and mt.dtype == torch.bool
    assert torch.equal(Xt, torch.as_tensor(X))
    (_, a), (_, b) = _services(), _services()
    t_a, s_a = a.rank_batch(X, mask)
    t_b, s_b = b.rank_batch(X, mask, placement=pl)
    np.testing.assert_array_equal(s_a, s_b)
    np.testing.assert_array_equal(t_a, t_b)
    # The mesh placements serve the same batch bit for bit.
    for pl in (placement.local("cpu"), placement.data_parallel(devices=["cpu"] * 2)):
        t_c, s_c = _services()[1].rank_batch(X, mask, placement=pl)
        np.testing.assert_array_equal(s_a, s_c)
        np.testing.assert_array_equal(t_a, t_c)


@pytest.mark.parametrize("library", ["forest_score", "sentinel_features"])
def test_enable_persistent_cache_points_the_build_at_the_dir(tmp_path, monkeypatch, library):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)  # restored after
    d = tmp_path / "kernels"
    assert enable_persistent_cache(str(d)) == str(d)
    assert d.is_dir() and build.BUILD_DIR == d.resolve()
    assert build.library_path(library).parent == d.resolve()
    assert enable_persistent_cache() == str(build.DEFAULT_BUILD_DIR)
    # Once either library is loaded, only its own directory is accepted.
    monkeypatch.setattr(build, "_LOADED", {library: (object(), d.resolve() / f"lib{library}-x.so")})
    assert enable_persistent_cache(str(d)) == str(d)
    with pytest.raises(RuntimeError, match=f"{library} kernel library is already loaded"):
        enable_persistent_cache(str(tmp_path / "elsewhere"))
    with pytest.raises(RuntimeError, match="already loaded"):
        fs.set_build_dir(tmp_path / "elsewhere")
