"""Port parity: the training half of LEAR (``repro_torch.core.lear``).

The reference trains its classifier on partial and full scores summed from
``score_bitvector``'s per-tree values; the port scores the ranker through
its segmented kernel path instead (one launch, ``seg₀ + base`` and
``seg₀ + seg₁ + base``). So the reference side here is the reference's own
``build_continue_labels``, ``instance_weights``, ``augment_features`` and
``train_gbdt``, fed the partial and full scores of the reference's
``forest_score_segments_pallas`` in interpret mode — bit-equal inputs to
the port's. Then:

- labels, weights, augmented features and sentinel scores are bit-exact;
- on a dyadic fixture (four of eight documents per query continue, so
  ``f_q`` is 1/2 and every weight a power of two) the classifier's first
  tree is bit-exact — its logistic gradients at score 0 are dyadic — and
  the later rounds (``sigmoid`` of nonzero scores) meet the tie rule;
- on general data every round meets the tie rule of ``tests/torch_parity.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lear as ref_lear  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest import gbdt as ref_gbdt  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import lear  # noqa: E402
from repro_torch.forest import binning, gbdt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import check_training_tie_rule, to_port, tree_bins  # noqa: E402

SENTINEL = 13


def _ranker(seed, F, T=40):
    return ref_ensemble.random_ensemble(seed, n_trees=T, depth=4, n_features=F)


def _ref_training_set(X, rel, mask, ranker, sentinel, k):
    """The reference's steps 1-4, scored by its segmented Pallas kernel."""
    Q, D, F = X.shape
    pf = ref_ops.padded_forest(ranker, boundaries=(sentinel, ranker.n_trees))
    seg = ref_ops.forest_score_segments(pf, jnp.asarray(X.reshape(Q * D, F)), interpret=True)
    partial = (seg[:, 0] + ranker.base_score).reshape(Q, D)
    full = (seg[:, 0] + seg[:, 1] + ranker.base_score).reshape(Q, D)
    mask_j, rel_j = jnp.asarray(mask), jnp.asarray(rel)
    cont = ref_lear.build_continue_labels(full, rel_j, mask_j, k=k)
    w = ref_lear.instance_weights(cont, rel_j, mask_j)
    X_aug = ref_lear.augment_features(jnp.asarray(X), partial, mask_j)
    flat = lambda a: np.array(a).reshape(Q * D, *a.shape[2:])
    return (
        flat(X_aug), flat(cont).astype(np.float32), flat(w), flat(partial), flat(full),
    )


def _problem(seed, Q=12, D=24, F=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    rel = rng.integers(0, 5, size=(Q, D)).astype(np.int32)
    mask = rng.random((Q, D)) < 0.85
    mask[:, 0] = True
    return X, rel, mask


def _dyadic_problem(seed, Q=16, D=8, F=10):
    """Four relevant documents per query of eight and k = 15 > D: all four
    continue, so f_q = 1/2 for both classes and w = 2^(r+1)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    rel = np.zeros((Q, D), np.int32)
    for q in range(Q):
        rel[q, rng.permutation(D)[:4]] = rng.integers(1, 4, size=4)
    return X, rel, np.ones((Q, D), dtype=bool)


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_and_weights_bit_exact(seed):
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(6, 30)).astype(np.float32)
    full[:, 5] = full[:, 6]  # a tie: ranked by index in both
    rel = rng.integers(0, 5, size=(6, 30)).astype(np.int32)
    mask = rng.random((6, 30)) < 0.7
    mask[2] = False          # an empty query
    t = torch.as_tensor
    cont = lear.build_continue_labels(t(full), t(rel), t(mask), k=7)
    ref_cont = ref_lear.build_continue_labels(
        jnp.asarray(full), jnp.asarray(rel), jnp.asarray(mask), k=7
    )
    assert np.array_equal(cont.numpy(), np.asarray(ref_cont))
    w = lear.instance_weights(cont, t(rel), t(mask))
    ref_w = ref_lear.instance_weights(ref_cont, jnp.asarray(rel), jnp.asarray(mask))
    assert w.dtype == torch.float32 and np.array_equal(w.numpy(), np.asarray(ref_w))


@pytest.mark.parametrize("sentinel", [SENTINEL, 40])
def test_training_set_bit_exact(sentinel):
    """Sentinel scores (one segmented launch; sentinel = T gives one
    segment), labels, weights and augmented features equal the reference's."""
    X, rel, mask = _problem(3)
    ranker = _ranker(3, X.shape[-1])
    port_ranker = to_port(ranker)
    flat = torch.as_tensor(X.reshape(-1, X.shape[-1]))
    if sentinel == ranker.n_trees:
        ops.reset_launch_counts()
        X_aug, cont, w = lear.continue_training_set(X, rel, mask, port_ranker, sentinel, k=15)
        assert ops.launch_counts()["segmented"] == 1
        partial, full = lear.sentinel_scores(port_ranker, flat, sentinel)
        assert torch.equal(partial, full)
        return
    ops.reset_launch_counts()
    X_aug, cont, w = lear.continue_training_set(X, rel, mask, port_ranker, sentinel, k=15)
    assert ops.launch_counts() == {"plain": 0, "segmented": 1, "gated": 0}
    want = _ref_training_set(X, rel, mask, ranker, sentinel, 15)
    for got, ref, name in zip((X_aug, cont, w), want, ("X_aug", "labels", "weights")):
        assert np.array_equal(got.numpy(), ref), name
    partial, full = lear.sentinel_scores(port_ranker, flat, sentinel)
    assert np.array_equal(partial.numpy(), want[3]) and np.array_equal(full.numpy(), want[4])


def _train_both(X, rel, mask, seed, n_trees, n_bins):
    ranker = _ranker(seed, X.shape[-1])
    kw = dict(n_trees=n_trees, depth=3, learning_rate=0.2, n_bins=n_bins)
    clf = lear.train_lear(
        X, rel, mask, to_port(ranker), SENTINEL, k=15, params=gbdt.GBDTParams(**kw)
    )
    X_aug, y, w, _, _ = _ref_training_set(X, rel, mask, ranker, SENTINEL, 15)
    preds = []
    want = ref_gbdt.train_gbdt(X_aug, y, ref_gbdt.GBDTParams(**kw), objective="logistic",
                               weights=w, callback=lambda t, pr: preds.append(pr))
    grads, prev = [], np.zeros_like(y)
    for pr in preds:
        g, h = ref_gbdt.grad_hess_logistic(jnp.asarray(prev), jnp.asarray(y), jnp.asarray(w))
        grads.append((np.asarray(g), np.asarray(h)))
        prev = pr
    edges = binning.quantile_bins(X_aug, n_bins)
    Xb = binning.apply_bins(torch.as_tensor(X_aug), torch.as_tensor(edges)).numpy()

    def trees(feature, threshold, leaf_value):
        feature = np.asarray(feature)
        return feature, tree_bins(feature, threshold, edges), np.asarray(leaf_value)

    f = clf.forest
    got = trees(f.feature.numpy(), f.threshold.numpy(), f.leaf_value.numpy())
    return clf, got, trees(want.feature, want.threshold, want.leaf_value), Xb, grads, kw, want


@pytest.mark.parametrize("seed", [0, 1])
def test_train_lear_dyadic_first_tree_bit_exact(seed):
    X, rel, mask = _dyadic_problem(seed)
    clf, got, want, Xb, grads, kw, _ = _train_both(X, rel, mask, seed, n_trees=3, n_bins=32)
    assert isinstance(clf, lear.LearClassifier) and clf.sentinel == SENTINEL and clf.n_trees == 3
    assert {float(v) for v in np.unique(grads[0][1])} <= {0.5, 1.0, 2.0, 4.0}
    for a, b, name in zip(got, want, ("feature", "bin", "leaf_value")):
        assert np.array_equal(a[0], b[0]), name
    check_training_tie_rule(Xb, grads, got, want, gbdt.GBDTParams(**kw))


@pytest.mark.parametrize("seed", [2, 3])
def test_train_lear_general_tie_rule(seed):
    X, rel, mask = _problem(seed)
    clf, got, want, Xb, grads, kw, ref_forest = _train_both(
        X, rel, mask, seed, n_trees=4, n_bins=32
    )
    rounds = check_training_tie_rule(Xb, grads, got, want, gbdt.GBDTParams(**kw))
    if rounds == len(grads):
        # Same trees: the classifier's P(Continue) serves like the reference's.
        Q, D, F = X.shape
        x_aug = np.concatenate([X, np.zeros((Q, D, 4), np.float32)], axis=-1)
        x_aug[..., F:] = np.random.default_rng(seed).normal(size=(Q, D, 4))
        ref_clf = ref_lear.LearClassifier(forest=ref_forest, sentinel=SENTINEL)
        np.testing.assert_allclose(
            clf.prob_continue(torch.as_tensor(x_aug), use_kernel=True).numpy(),
            np.asarray(ref_clf.prob_continue(jnp.asarray(x_aug), use_kernel=True)),
            rtol=1e-6, atol=1e-6,
        )
