"""Port parity: the tensor glue of the serving path, exact where it can be.

Compaction indices, ranks, masks and integer counts must be equal. The
float features are each one IEEE operation per element (subtract, max,
divide, clip, compare) on the same inputs, so they are equal too; the
cost model is host float arithmetic in the same order, hence equal.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import compaction as ref_compaction  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.metrics import ranking as ref_ranking  # noqa: E402
from repro.metrics import speedup as ref_speedup  # noqa: E402
from repro_torch.core import cascade, compaction, features, strategies  # noqa: E402
from repro_torch.metrics import ranking, speedup  # noqa: E402


def _scores(rng, Q, D, ties=False, p_mask=0.8):
    s = (rng.integers(0, 3, size=(Q, D)) if ties else rng.normal(size=(Q, D)))
    m = rng.random((Q, D)) < p_mask
    return s.astype(np.float32), m


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,capacity,p", [
    (100, 16, 0.5),    # overflow
    (100, 64, 0.0),    # all exit
    (100, 128, 1.0),   # all continue, capacity above n
    (37, 37, 0.3),
])
def test_compaction_matches_reference(n, capacity, p):
    cont = np.random.default_rng(n + capacity).random(n) < p
    sel, n_cont, within = compaction.compact_indices_cumsum_masked(
        torch.as_tensor(cont), capacity
    )
    r_sel, r_n, r_within = ref_compaction.compact_indices_cumsum_masked(
        jnp.asarray(cont), capacity
    )
    _eq(sel, r_sel)
    assert int(n_cont) == int(r_n)
    _eq(within, r_within)
    sel2, n2 = compaction.compact_indices_cumsum(torch.as_tensor(cont), capacity)
    assert torch.equal(sel2, sel) and int(n2) == int(n_cont)
    # The argsort oracle agrees on every occupied slot.
    a_sel, a_n = compaction.compact_indices_argsort(torch.as_tensor(cont), capacity)
    k = min(int(a_n), capacity)
    assert int(a_n) == int(n_cont)
    assert torch.equal(a_sel[:k], sel[:k])


@pytest.mark.parametrize("D", [8, 64, 128, 256, 257, 300])
@pytest.mark.parametrize("ties", [False, True])
def test_query_ranks_direct_and_blocked_match_reference(D, ties):
    """Across the port's own blocked cutoff (``RANK_BLOCKED_MIN_D``), with
    masks and with masses of exact ties."""
    rng = np.random.default_rng(D + ties)
    s, m = _scores(rng, 3, D, ties=ties)
    st, mt = torch.as_tensor(s), torch.as_tensor(m)
    want = np.asarray(ref_features.query_ranks(jnp.asarray(s), jnp.asarray(m)))
    for method in ("direct", "blocked", "auto"):
        np.testing.assert_array_equal(
            features.query_ranks(st, mt, method=method).numpy(), want, err_msg=method
        )
    np.testing.assert_array_equal(ranking.rank_from_scores(st, mt).numpy(), want)
    assert features.RANK_BLOCKED_MIN_D == ref_features.RANK_BLOCKED_MIN_D


def test_minmax_normalization_and_augment_match_reference():
    rng = np.random.default_rng(7)
    Q, D, F = 4, 40, 6
    s, m = _scores(rng, Q, D)
    m[3] = False                      # an all-masked query: lo > hi → 0
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    st, mt = torch.as_tensor(s), torch.as_tensor(m)
    sj, mj = jnp.asarray(s), jnp.asarray(m)
    lo, hi = features.query_minmax(st, mt)
    r_lo, r_hi = ref_features.query_minmax(sj, mj)
    _eq(lo, r_lo)
    _eq(hi, r_hi)
    _eq(features.normalized_partial(st, lo, hi), ref_features.normalized_partial(sj, r_lo, r_hi))
    _eq(
        features.augment_features(torch.as_tensor(X), st, mt),
        ref_features.augment_features(jnp.asarray(X), sj, mj),
    )


@pytest.mark.parametrize("k_s", [1, 5, 40, 100])
def test_ert_ept_and_query_converged_match_reference(k_s):
    rng = np.random.default_rng(k_s)
    s, m = _scores(rng, 5, 40, ties=k_s == 5)
    st, mt = torch.as_tensor(s), torch.as_tensor(m)
    sj, mj = jnp.asarray(s), jnp.asarray(m)
    _eq(strategies.ert_continue(st, mt, k_s), ref_strategies.ert_continue(sj, mj, k_s))
    for p in (0.0, 0.3):
        _eq(
            strategies.ept_continue(st, mt, k_s, p),
            ref_strategies.ept_continue(sj, mj, k_s, p),
        )
    for margin in (math.inf, 0.0, 0.5):
        _eq(
            strategies.query_converged(st, mt, k_s, margin),
            ref_strategies.query_converged(sj, mj, k_s, margin),
        )


def test_ndcg_matches_reference():
    rng = np.random.default_rng(3)
    s, m = _scores(rng, 6, 30, ties=True)
    labels = rng.integers(0, 5, size=(6, 30))
    got = ranking.ndcg_at_k(torch.as_tensor(s), torch.as_tensor(labels), torch.as_tensor(m))
    want = ref_ranking.ndcg_at_k(jnp.asarray(s), jnp.asarray(labels), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("sentinels,costs", [
    ((8,), 10), ((8, 28), [10, 4]), ((5, 19, 33), 2.5),
])
def test_trees_traversed_progressive_matches_reference(sentinels, costs):
    rng = np.random.default_rng(len(sentinels))
    m = rng.random((3, 20)) < 0.9
    masks, alive = [], m
    for _ in sentinels:
        alive = alive & (rng.random(m.shape) < 0.6)
        masks.append(alive)
    got = speedup.trees_traversed_progressive(
        torch.as_tensor(m), [torch.as_tensor(a) for a in masks], sentinels, 40, costs
    )
    want = ref_speedup.trees_traversed_progressive(
        jnp.asarray(m), [jnp.asarray(a) for a in masks], sentinels, 40, costs
    )
    assert got.dtype == torch.float32 and float(got) == float(want)
    assert float(
        speedup.speedup_progressive(
            torch.as_tensor(m), [torch.as_tensor(a) for a in masks], sentinels, 40, costs
        )
    ) == float(
        ref_speedup.speedup_progressive(
            jnp.asarray(m), [jnp.asarray(a) for a in masks], sentinels, 40, costs
        )
    )


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("survivors", [
    (900.0, 300.0), (10.0, 3.0), (0.0, 0.0), (float("nan"), float("inf")), (1024.0, 1024.0),
])
@pytest.mark.parametrize("block_b,caps", [(1, None), (256, (512, 256)), (256, (1024, 64))])
def test_progressive_cost_model_matches_reference(mode, survivors, block_b, caps):
    for loh in (0.0, 4096.0):
        for qe in (0.0, 0.5):
            args = (1024, survivors, (50, 150), 1047, mode)
            kw = dict(
                launch_overhead_trees=loh, stage_capacities=caps,
                block_b=block_b, query_exit_rate=qe,
            )
            assert speedup.progressive_cost_model(*args, **kw) == (
                ref_speedup.progressive_cost_model(*args, **kw)
            )


@pytest.mark.parametrize("want,limit", [(0, 512), (65, 512), (300, 256), (2048, 4096)])
def test_bucket_capacity_matches_reference(want, limit):
    assert cascade.bucket_capacity(want, limit) == ref_cascade.bucket_capacity(want, limit)
