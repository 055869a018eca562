"""Port parity: the progressive cascade engine against the reference's.

``rank_progressive`` runs the same trees, strategies and capacities in both
packages, at one, two and three sentinels, fused and staged, with and
without overflow. Scores, stage masks, prefix grids and overflow must be
equal: the kernels' plain versions are bit-exact with the Pallas kernels,
the prefixes are built with the same left-to-right association, and the
compaction and scatter place the same values. The launch counters show
the engine's contract (fused = 1 segmented + ≤1 plain; staged ≤ S+1 plain)
and equal the reference's counts for one step.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import cascade, features, lear, stage, strategies  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

Q, D, F, T = 2, 32, 12, 40


def _strategies(kind, sentinels):
    """The same exit policy per stage in both packages (ERT or LEAR)."""
    if kind == "ert":
        ks = [12, 6, 3][: len(sentinels)]
        return (
            [functools.partial(_ert, ref_strategies, k) for k in ks],
            [functools.partial(_ert, strategies, k) for k in ks],
        )
    ref_clfs = [
        ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4)
        for i in range(len(sentinels))
    ]
    return (
        [_lear(ref_features, ref_lear.LearClassifier(c, s), use_kernel=True)
         for c, s in zip(ref_clfs, sentinels)],
        [_lear(features, lear.LearClassifier(to_port(c), s), use_kernel=True)
         for c, s in zip(ref_clfs, sentinels)],
    )


def _ert(pkg, k_s, partial, mask, features=None):
    return pkg.ert_continue(partial, mask, k_s)


def _lear(pkg_features, clf, **kernel):
    # Both packages score the classifier through their kernel only when asked.
    def strategy(partial, mask, features=None):
        aug = pkg_features.augment_features(features, partial, mask)
        return clf.continue_mask(aug, mask, 0.5, **kernel)
    return strategy


def _inputs(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(D // 2, D + 1, size=(Q, 1))
    return X, mask


def _run_both(sentinels, mode, capacities, kind, seed=0):
    ref_ens = ref_ensemble.random_ensemble(seed, n_trees=T, depth=4, n_features=F)
    ref_strats, port_strats = _strategies(kind, sentinels)
    X, mask = _inputs(seed)
    ref_ops.reset_launch_counts()
    want = ref_cascade.CascadeRanker(ref_ens, sentinels[0], ref_strats[0]).rank_progressive(
        jnp.asarray(X), jnp.asarray(mask),
        ref_stage.EngineConfig.trees(sentinels, ref_strats, capacities=capacities, mode=mode),
        features=jnp.asarray(X),
    )
    ref_counts = ref_ops.launch_counts()
    ops.reset_launch_counts()
    got = cascade.CascadeRanker(to_port(ref_ens), sentinels[0], port_strats[0]).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        stage.EngineConfig.trees(sentinels, port_strats, capacities=capacities, mode=mode),
        features=torch.as_tensor(X),
    )
    return got, want, ops.launch_counts(), ref_counts


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("capacities", [None, 8])
@pytest.mark.parametrize("sentinels,kind", [
    ((10,), "lear"), ((8, 28), "ert"), ((8, 28), "lear"), ((5, 19, 33), "lear"),
    ((6, T), "ert"),
])
def test_rank_progressive_matches_reference(sentinels, kind, mode, capacities):
    got, want, counts, ref_counts = _run_both(sentinels, mode, capacities, kind)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.continue_mask.numpy(), np.asarray(want.continue_mask))
    assert len(got.stage_masks) == len(want.stage_masks) == len(sentinels)
    for g, w in zip(got.stage_masks, want.stage_masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.partials.numpy(), np.asarray(want.partials))
    assert int(got.overflow) == int(want.overflow)
    assert float(got.speedup) == float(want.speedup)
    assert counts == ref_counts
    if capacities is not None and kind == "ert" and (
        mode == "staged" or sentinels[-1] < T
    ):
        assert int(got.overflow) > 0      # the small capacity really overflows


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_launch_contract(mode):
    """Fused: 1 segmented head + 1 tail launch; staged: S+1 plain launches
    (ERT strategies launch no classifier)."""
    sentinels = (5, 19, 33)
    got, _, counts, _ = _run_both(sentinels, mode, None, "ert")
    S = len(sentinels)
    if mode == "fused":
        assert counts == {"plain": 1, "segmented": 1, "gated": 0}
    else:
        assert counts == {"plain": S + 1, "segmented": 0, "gated": 0}


def test_rank_and_rank_compacted_match_reference():
    ref_ens = ref_ensemble.random_ensemble(3, n_trees=T, depth=4, n_features=F)
    X, mask = _inputs(3)
    ref_r = ref_cascade.CascadeRanker(ref_ens, 10, lambda p, m: ref_strategies.ert_continue(p, m, 8))
    port_r = cascade.CascadeRanker(to_port(ref_ens), 10, lambda p, m: strategies.ert_continue(p, m, 8))
    Xt, mt, Xj, mj = torch.as_tensor(X), torch.as_tensor(mask), jnp.asarray(X), jnp.asarray(mask)

    got, want = port_r.rank(Xt, mt), ref_r.rank(Xj, mj)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.continue_mask.numpy(), np.asarray(want.continue_mask))
    assert got.speedup == pytest.approx(want.speedup, rel=1e-6)

    for compaction in ("cumsum", "argsort"):
        for cap in (4, 64):
            got = port_r.rank_compacted(Xt, mt, cap, compaction)
            want = ref_r.rank_compacted(Xj, mj, cap, compaction)
            np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
            assert int(got.overflow) == int(want.overflow)


def test_unported_options_raise():
    # Query exit and the dense stage are ported (tests/test_torch_query_exit.py,
    # tests/test_torch_hybrid.py); an engine-side "auto" is not: the port
    # picks the mode on the host.
    qe = strategies.QueryExitConfig()
    assert stage.EngineConfig(stages=(stage.TreeStage(5),), query_exit=qe).query_exit == qe
    dense = stage.DenseStage(scorer=lambda x: x[:, 0], policy=lambda s, m: m)
    cfg = stage.EngineConfig(stages=(dense, stage.TreeStage(5)))
    assert cfg.dense is dense and cfg.sentinels == (5,) and cfg.n_stages == 2
    with pytest.raises(ValueError, match="_pick_mode"):
        stage.EngineConfig.trees((5, 9), mode="auto")
    with pytest.raises(ValueError, match="_pick_mode"):
        stage.EngineConfig(stages=(dense, stage.TreeStage(5), stage.TreeStage(9)), mode="auto")


@pytest.mark.parametrize("ref_use_kernel", [False, True])
def test_lear_classifier_matches_reference(ref_use_kernel):
    """``use_kernel`` picks the same path in both packages (the kernel, or
    the bitvector scorer, the default of a bare call); each is held to the
    reference's. The two sigmoids may differ by an ulp, so probabilities
    hold at rtol 1e-6 and the continue masks must be equal on this seed."""
    ref_forest = ref_ensemble.random_ensemble(7, n_trees=10, depth=5, n_features=F + 4)
    ref_clf = ref_lear.LearClassifier(ref_forest, 10)
    port_clf = lear.LearClassifier.from_numpy(ref_arrays(ref_forest), 10, "cpu")
    X, mask = _inputs(7)
    partial = np.random.default_rng(8).normal(size=(Q, D)).astype(np.float32)
    aug_j = ref_features.augment_features(jnp.asarray(X), jnp.asarray(partial), jnp.asarray(mask))
    aug_t = features.augment_features(
        torch.as_tensor(X), torch.as_tensor(partial), torch.as_tensor(mask)
    )
    ops.reset_launch_counts()
    np.testing.assert_allclose(
        port_clf.prob_continue(aug_t, use_kernel=ref_use_kernel).numpy(),
        np.asarray(ref_clf.prob_continue(aug_j, use_kernel=ref_use_kernel)),
        rtol=1e-6,
    )
    assert ops.launch_counts()["plain"] == int(ref_use_kernel)
    np.testing.assert_array_equal(
        port_clf.continue_mask(aug_t, torch.as_tensor(mask), 0.5, ref_use_kernel).numpy(),
        np.asarray(ref_clf.continue_mask(aug_j, jnp.asarray(mask), 0.5, ref_use_kernel)),
    )
