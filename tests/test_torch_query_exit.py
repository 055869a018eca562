"""Port parity: query-level exit and the gated tail against the reference.

The same ensemble (converted through numpy), the same EPT exit policy and
the same inputs go through ``rank_progressive`` in both packages with
query exit off, at ``margin=inf``, at finite margins and from a later
stage, fused and staged. Scores, stage masks, prefix grids, overflow and
``query_exited`` must be equal, and the dispatch counts (``plain`` /
``segmented`` / ``gated``) of one port call must equal those of one fresh
reference trace. The service keeps ``margin=inf`` responses bit-exact with
the knob off, counts exited queries, feeds the tail-skip rate into the
mode pick as the reference does, and still makes one device read per
batch. The gated tail's plain version zeroes exactly the rows past the
count (the CUDA kernel is held to it in ``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro.serve import tier as ref_tier  # noqa: E402
from repro_torch.core import cascade, stage, strategies  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.serve.tier import ServingTier, TierConfig  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

SENTINELS = (10, 20, 30)
EPT = dict(k_s=5, p=0.5)
Q, D, F, T = 4, 24, 16, 60

REGIMES = {
    "off": (None, None),
    "inf": (ref_strategies.QueryExitConfig(k=3), strategies.QueryExitConfig(k=3)),
    "margin0.1": (
        ref_strategies.QueryExitConfig(k=3, margin=0.1),
        strategies.QueryExitConfig(k=3, margin=0.1),
    ),
    "from_stage1": (
        ref_strategies.QueryExitConfig(k=3, margin=0.1, from_stage=1),
        strategies.QueryExitConfig(k=3, margin=0.1, from_stage=1),
    ),
    "all_exit": (
        ref_strategies.QueryExitConfig(k=D, margin=0.0),
        strategies.QueryExitConfig(k=D, margin=0.0),
    ),
}


def _problem(seed):
    ens = ref_ensemble.random_ensemble(seed, n_trees=T, depth=4, n_features=F)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = rng.random((Q, D)) < 0.9
    return ens, X, mask


def _run_both(seed, sentinels, mode, regime, capacities=None):
    ens, X, mask = _problem(seed)
    ref_qe, port_qe = REGIMES[regime]
    ref_ops.reset_launch_counts()
    want = ref_cascade.CascadeRanker(ens, sentinels[0], ref_strategies.ept_continue).rank_progressive(
        jnp.asarray(X), jnp.asarray(mask),
        ref_stage.EngineConfig.trees(
            sentinels, mode=mode, capacities=capacities, query_exit=ref_qe
        ),
        **EPT,
    )
    ref_counts = ref_ops.launch_counts()
    ops.reset_launch_counts()
    got = cascade.CascadeRanker(to_port(ens), sentinels[0], strategies.ept_continue).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        stage.EngineConfig.trees(
            sentinels, mode=mode, capacities=capacities, query_exit=port_qe
        ),
        **EPT,
    )
    return got, want, ops.launch_counts(), ref_counts


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_rank_progressive_with_query_exit_matches_reference(mode, regime):
    got, want, counts, ref_counts = _run_both(12, SENTINELS, mode, regime)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.continue_mask.numpy(), np.asarray(want.continue_mask))
    for g, w in zip(got.stage_masks, want.stage_masks, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.partials.numpy(), np.asarray(want.partials))
    assert int(got.overflow) == int(want.overflow)
    assert float(got.speedup) == float(want.speedup)
    if regime == "off":
        assert got.query_exited is None and want.query_exited is None
    else:
        assert got.query_exited.shape == (Q,) and got.query_exited.dtype == torch.bool
        np.testing.assert_array_equal(got.query_exited.numpy(), np.asarray(want.query_exited))
    assert counts == ref_counts
    assert counts["gated"] == (regime != "off")


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_query_exit_with_overflow_matches_reference(mode):
    got, want, _, _ = _run_both(13, SENTINELS, mode, "margin0.1", capacities=8)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.query_exited.numpy(), np.asarray(want.query_exited))
    assert int(got.overflow) == int(want.overflow) > 0


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_margin_inf_is_score_preserving(mode):
    """Only queries with no alive document exit at margin=inf, so skipping
    their tail work changes no score."""
    ens, X, mask = _problem(11)
    ranker = cascade.CascadeRanker(to_port(ens), SENTINELS[0], strategies.ept_continue)
    Xt, mt = torch.as_tensor(X), torch.as_tensor(mask)
    base = ranker.rank_progressive(Xt, mt, stage.EngineConfig.trees(SENTINELS, mode=mode), **EPT)
    qe = ranker.rank_progressive(
        Xt, mt,
        stage.EngineConfig.trees(SENTINELS, mode=mode, query_exit=strategies.QueryExitConfig(k=3)),
        **EPT,
    )
    assert torch.equal(base.scores, qe.scores)
    assert torch.equal(base.continue_mask, qe.continue_mask)
    assert base.query_exited is None and qe.query_exited.shape == (Q,)


def test_modes_agree_and_exited_queries_leave_the_alive_mask():
    got_f, _, _, _ = _run_both(15, SENTINELS, "fused", "margin0.1")
    got_s, _, _, _ = _run_both(15, SENTINELS, "staged", "margin0.1")
    assert torch.equal(got_f.scores, got_s.scores)
    assert torch.equal(got_f.query_exited, got_s.query_exited)
    exited = got_f.query_exited
    assert exited.any()
    assert not got_f.stage_masks[-1][exited].any()


def test_all_exit_batch_gates_the_whole_tail():
    """Every query converges at stage 0: one gated dispatch, and the scores
    are the first prefix (the tail added nothing)."""
    got, want, counts, _ = _run_both(16, SENTINELS, "fused", "all_exit")
    assert got.query_exited.all()
    assert counts == {"plain": 0, "segmented": 1, "gated": 1}
    np.testing.assert_array_equal(got.scores.numpy(), got.partials[..., 0].numpy())


def test_no_tail_configuration_has_no_gate():
    got, want, counts, ref_counts = _run_both(18, (10, 20, T), "fused", "margin0.1")
    assert counts == ref_counts and counts["gated"] == 0
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


@pytest.mark.parametrize("count", [0, 1, 31, 33, 99, 100, 250])
def test_gated_plain_version_zeroes_rows_past_the_count(count):
    """Rows below the count equal the ungated call bit for bit; the rest
    are 0.0 (a count above B gates nothing)."""
    ens = to_port(ref_ensemble.random_ensemble(3, n_trees=40, depth=4, n_features=F))
    pf = ops.padded_forest(ens, boundaries=(10, 40))
    x = torch.as_tensor(np.random.default_rng(count).normal(size=(100, F)).astype(np.float32))
    ungated = ops.forest_score_range(pf, x, seg_lo=1)
    gated = ops.forest_score_range(
        pf, x, seg_lo=1, count_as="gated", n_valid=torch.tensor(count, dtype=torch.int32)
    )
    n = min(count, 100)
    assert torch.equal(gated[:n], ungated[:n])
    assert torch.equal(gated[n:], torch.zeros(100 - n))


def test_gate_count_must_be_one_int32_on_the_device():
    ens = to_port(ref_ensemble.random_ensemble(3, n_trees=16, depth=3, n_features=F))
    pf = ops.padded_forest(ens)
    x = torch.zeros(8, F)
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    for bad in (torch.tensor(3), torch.tensor([1, 2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="n_valid"):
            fs.forest_score_kernel(x, *tables, block_t=pf.block_t, n_valid=bad)


# --- the service -------------------------------------------------------------

SVC_F = 12


def _services(query_exit, mode="auto", threshold=0.4):
    ref_qe, port_qe = query_exit
    ens = ref_ensemble.random_ensemble(0, n_trees=64, depth=4, n_features=SVC_F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=SVC_F + 4), s
        )
        for i, s in enumerate((8, 28))
    ]
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=threshold, execution_mode=mode, launch_overhead_trees=50.0,
            query_exit=ref_qe,
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(
            threshold=threshold, execution_mode=mode, launch_overhead_trees=50.0,
            query_exit=port_qe,
        ),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    # The reference tests' deterministic gate: continue ⇔ feature 0 > 0.
    for svc in (ref, port):
        svc.stage_strategies = [lambda p, m, features=None: m & (features[..., 0] > 0.0)] * 2
    return ref, port


def _gated_batch(rng, Qb, Db, survive_frac):
    X = rng.normal(size=(Qb, Db, SVC_F)).astype(np.float32)
    flags = np.full((Qb, Db), -1.0, np.float32)
    flags[:, : int(round(survive_frac * Db))] = 1.0
    X[..., 0] = flags
    return X, np.ones((Qb, Db), bool)


@pytest.mark.parametrize("regime", ["off", "inf", "margin0.1"])
@pytest.mark.parametrize("mode", ["auto", "staged"])
def test_service_query_exit_matches_reference(regime, mode):
    """Responses, exit counts, the tail-skip EMA and the mode picks equal
    the reference's, batch by batch; an all-exit batch is counted."""
    ref, port = _services(REGIMES[regime], mode)
    rng = np.random.default_rng(2)
    for frac in (0.5, 0.0, 0.3, 0.0, 0.6):
        X, m = _gated_batch(rng, 2, 64, frac)
        top, scores = port.rank_batch(X, m)
        want_top, want_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(m))
        np.testing.assert_array_equal(top, np.asarray(want_top))
        np.testing.assert_array_equal(scores, np.asarray(want_scores))
        assert port.stats.batches_staged == ref.stats.batches_staged
        p, r = port.bucket_state(2, 64), ref.bucket_state(2, 64)
        assert (p.peaks, p.ema, p.tail_skip) == (r.peaks, r.ema, r.tail_skip)
        assert port._query_exit_rate_estimate() == ref._query_exit_rate_estimate()
        assert port._pick_mode(128) == ref._pick_mode(128)
    assert port.stats.queries_exited == ref.stats.queries_exited
    assert port.stats.query_exit_rate == ref.stats.query_exit_rate
    if regime != "off":
        assert port.stats.queries_exited >= 4  # the two all-exit batches
        assert 0.0 < port._active_state().tail_skip < 1.0


def test_service_margin_inf_is_bitexact_with_query_exit_off():
    base, qe = (_services(REGIMES[r])[1] for r in ("off", "inf"))
    rng = np.random.default_rng(3)
    for frac in (0.5, 0.0, 0.3):
        X, m = _gated_batch(rng, 2, 64, frac)
        np.testing.assert_array_equal(base.rank_batch(X, m)[1], qe.rank_batch(X, m)[1])
    assert base.stats.queries_exited == 0 and qe.stats.queries_exited == 2
    assert base._query_exit_rate_estimate() == 0.0


def test_rank_batch_with_query_exit_reads_the_device_once(monkeypatch):
    """Query exit adds one value to the one packed read, and no other
    host read; its tail counts one gated dispatch per batch."""
    _, port = _services(REGIMES["margin0.1"], "fused")
    rng = np.random.default_rng(5)
    port.rank_batch(*_gated_batch(rng, 2, 64, 0.5))
    calls = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _r=real, **k: calls.append(_n) or _r(self, *a, **k),
        )
    ops.reset_launch_counts()
    port.rank_batch(*_gated_batch(rng, 2, 64, 0.5))
    assert calls == ["numpy"]   # device_get's view of the CPU tensor
    assert ops.launch_counts()["gated"] == 1


def test_tier_stats_expose_query_exit():
    ref, port = _services(REGIMES["inf"])
    got = ServingTier(port, SVC_F, TierConfig(warmup=False, persistent_cache=False)).stats()
    want = ref_tier.ServingTier(
        ref, n_features=SVC_F,
        config=ref_tier.TierConfig(warmup=False, persistent_cache=False),
    ).stats()
    assert got["service"] == want["service"]
    assert got["service"]["queries_exited"] == 0
    assert got["service"]["query_exit_rate"] == 0.0


def test_query_exit_config_is_held_to_the_reference():
    assert strategies.QueryExitConfig() == strategies.QueryExitConfig(k=10, margin=math.inf)
    for bad in (dict(k=0), dict(margin=-1.0), dict(from_stage=-1)):
        with pytest.raises(ValueError):
            strategies.QueryExitConfig(**bad)
        with pytest.raises(AssertionError):
            ref_strategies.QueryExitConfig(**bad)
