"""Port parity: λ-MART lambdas, the histogram GBDT and its ensembles.

- ``lambda_grad_hess`` agrees with the reference within 1e-5;
- on a **dyadic fixture** (gradients and hessians small multiples of 1/8,
  so every histogram and leaf sum is exact in any order) ``_fit_tree`` and
  the boosting loops are bit-exact with the reference: features, bins and
  leaf values. ``train_gbdt`` stays dyadic for many rounds on a fixture
  whose leaves come out pure (``reg_lambda`` 0, learning rate 0.5);
  λ-MART's and the logistic loss's later gradients go through ``log2`` and
  ``sigmoid``, so there only the first round is dyadic;
- on general data the trainings meet the tie rule of
  ``tests/torch_parity.py`` (torch and XLA add the histogram in different
  orders, so a split whose gain ties within rounding may go either way);
- a port-trained forest handed to the reference (``to_numpy`` →
  ``from_complete_arrays``) scores bit-exactly with the reference's own;
  ``from_arrays`` and ``concat_ensembles`` equal the reference's, and
  ``score_level`` and ``partial_scores`` agree with it within the
  reference scorers' 1e-5 (they sum over trees in torch's order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.forest import binning as ref_binning  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest import gbdt as ref_gbdt  # noqa: E402
from repro.forest import lambdamart as ref_lambdamart  # noqa: E402
from repro.forest import scoring as ref_scoring  # noqa: E402
from repro_torch.forest import binning, ensemble, gbdt, lambdamart, scoring  # noqa: E402
from torch_parity import (  # noqa: E402
    check_training_tie_rule,
    check_tree_tie_rule,
    ref_arrays,
    to_port,
    tree_bins,
)


def _params(**kw):
    return gbdt.GBDTParams(**kw), ref_gbdt.GBDTParams(**kw)


def _same_tree(got, want):
    for a, b, name in zip(got, want, ("feature", "bin", "leaf_value", "leaf index")):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.array_equal(a, np.asarray(b)), name


def _trees(ens, edges):
    """(feature, bin, leaf_value) numpy arrays of a port or reference ensemble."""
    if isinstance(ens, ensemble.TreeEnsemble):
        feat, thr, leaf = (getattr(ens, k).numpy() for k in ("feature", "threshold", "leaf_value"))
    else:
        feat, thr, leaf = (
            np.asarray(getattr(ens, k)) for k in ("feature", "threshold", "leaf_value")
        )
    return feat, tree_bins(feat, thr, edges), leaf


# --- lambdas ---------------------------------------------------------------


@pytest.mark.parametrize("Q,D,k,chunk", [(70, 24, 10, 64), (5, 16, 3, 2), (64, 12, 12, 64)])
def test_lambda_grad_hess_within_1e5(Q, D, k, chunk):
    rng = np.random.default_rng(Q + D)
    s = rng.normal(size=(Q, D)).astype(np.float32)
    s[:, 3] = s[:, 4]  # tied scores: ranked by index in both
    lab = rng.integers(0, 5, size=(Q, D)).astype(np.float32)
    mask = rng.random((Q, D)) < 0.8
    mask[0] = False    # an empty query: zero ideal DCG
    g, h = lambdamart.lambda_grad_hess(
        torch.as_tensor(s), torch.as_tensor(lab), torch.as_tensor(mask), k=k, chunk=chunk
    )
    g_ref, h_ref = ref_lambdamart.lambda_grad_hess(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(mask), k=k, chunk=chunk
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)


def test_ideal_dcg_equal():
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 5, size=(9, 20)).astype(np.float32)
    mask = rng.random((9, 20)) < 0.5
    got = lambdamart._ideal_dcg(torch.as_tensor(lab), torch.as_tensor(mask), 10)
    want = [
        ref_lambdamart._ideal_dcg(jnp.asarray(lq), jnp.asarray(mq), 10) for lq, mq in zip(lab, mask)
    ]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- one tree ----------------------------------------------------------------


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 5000), (2, 1)])
def test_card_segment_sums_equal_the_cpu_scatter(seed, size):
    """The card's scatter (rows sorted by destination, segment sums) adds
    in the CPU's order, row order within a destination: bit-equal, empty
    destinations 0 (run here on CPU tensors)."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, size, size=30_000))
    idx[::5] = 0  # a long run
    vals = torch.as_tensor(rng.normal(size=(30_000, 2)).astype(np.float32))
    got = gbdt._segment_sum_sorted(idx, vals, size + 7)
    assert torch.equal(got, gbdt._scatter_sum(idx, vals, size + 7))
    assert not got[size:].any()


def _dyadic(seed, N, F, n_bins):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, size=(N, F)).astype(np.int32)
    Xb[:, 1] = 0                               # a feature with one bin: never valid
    g = (rng.integers(-16, 17, size=N) / 8).astype(np.float32)
    h = (rng.integers(0, 9, size=N) / 8).astype(np.float32)
    return Xb, g, h


@pytest.mark.parametrize("depth,n_bins,N", [(1, 16, 64), (3, 16, 300), (4, 256, 800), (4, 8, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_tree_dyadic_bit_exact(depth, n_bins, N, seed):
    """Every sum is exact, so splits (first-max ties included), dead nodes
    (N = 40 at depth 4 leaves nodes without a valid split) and leaves are
    bit-equal."""
    Xb, g, h = _dyadic(seed, N, 10, n_bins)
    p, p_ref = _params(depth=depth, n_bins=n_bins, learning_rate=0.25)
    got = gbdt._fit_tree(torch.as_tensor(Xb), torch.as_tensor(g), torch.as_tensor(h), p)
    want = ref_gbdt._fit_tree(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h), p_ref)
    _same_tree(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_tree_general_tie_rule(seed):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, 32, size=(900, 12)).astype(np.int32)
    g = rng.normal(size=900).astype(np.float32)
    h = rng.uniform(0.01, 1.0, size=900).astype(np.float32)
    p, p_ref = _params(depth=4, n_bins=32)
    got = gbdt._fit_tree(torch.as_tensor(Xb), torch.as_tensor(g), torch.as_tensor(h), p)
    want = ref_gbdt._fit_tree(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h), p_ref)
    check_tree_tie_rule(
        Xb, g, h, [a.numpy() for a in got[:3]], [np.asarray(a) for a in want[:3]], p
    )


# --- boosting loops ----------------------------------------------------------


def _pure_leaf_fixture():
    """y is a step function of feature 0 with 8 levels (multiples of 1/8):
    a depth-3 tree isolates them, every leaf is pure, and with
    ``reg_lambda`` 0 and learning rate 0.5 every leaf value, prediction and
    residual stays a short dyadic number in every round."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(512, 6)).astype(np.float32)
    level = np.digitize(X[:, 0], np.quantile(X[:, 0], np.linspace(0, 1, 9)[1:-1]))
    y = (level / 8.0 - 0.5).astype(np.float32)
    return X, y


def test_train_gbdt_dyadic_bit_exact():
    X, y = _pure_leaf_fixture()
    kw = dict(n_trees=6, depth=3, learning_rate=0.5, reg_lambda=0.0, n_bins=64)
    p, p_ref = _params(**kw)
    seen = []
    got = gbdt.train_gbdt(X, y, p, device="cpu", callback=lambda t, pr: seen.append((t, pr)))
    want = ref_gbdt.train_gbdt(X, y, p_ref)
    for k in ("feature", "threshold", "leaf_value", "left", "right"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    assert [t for t, _ in seen] == list(range(6)) and seen[-1][1].shape == (512,)
    # The fixture really is exact: the residuals halve each round.
    assert np.abs(seen[-1][1] - y).max() == np.abs(y).max() / 2 ** 6


@pytest.mark.parametrize("objective", ["l2", "logistic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_gbdt_general_tie_rule(objective, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    if objective == "l2":
        y = (np.sin(X[:, 0]) + 0.1 * X[:, 2]).astype(np.float32)
    w = np.where(y > 0, 2.0, 1.0).astype(np.float32)
    kw = dict(n_trees=5, depth=3, learning_rate=0.3, n_bins=32)
    p, p_ref = _params(**kw)
    preds = []
    got = gbdt.train_gbdt(X, y, p, objective, weights=w, device="cpu")
    want = ref_gbdt.train_gbdt(X, y, p_ref, objective, weights=w,
                               callback=lambda t, pr: preds.append(pr))
    edges = binning.quantile_bins(X, 32)
    Xb = binning.apply_bins(torch.as_tensor(X), torch.as_tensor(edges)).numpy()
    grads, prev = [], np.zeros(600, np.float32)
    for pr in preds:
        g, h = ref_gbdt.OBJECTIVES[objective](jnp.asarray(prev), jnp.asarray(y), jnp.asarray(w))
        grads.append((np.asarray(g), np.asarray(h)))
        prev = pr
    check_training_tie_rule(Xb, grads, _trees(got, edges), _trees(want, edges), p)


def _ranking_data(seed, Q=40, D=20, F=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    util = X[..., 0] + 0.7 * X[..., 1] + 0.2 * rng.normal(size=(Q, D))
    labels = np.clip(np.digitize(util, [-0.5, 0.5, 1.2, 1.8]), 0, 4).astype(np.float32)
    mask = np.ones((Q, D), dtype=bool)
    mask[:, 15:] = rng.random((Q, D - 15)) > 0.5
    return X, labels, mask


def _lambda_grads(preds, labels, mask, k):
    """The reference's (g, h) for each round, from the predictions before it."""
    grads, prev = [], np.zeros(labels.shape, np.float32)
    for pr in preds:
        g, h = ref_lambdamart.lambda_grad_hess(
            jnp.asarray(prev), jnp.asarray(labels), jnp.asarray(mask), k=k
        )
        flat_w = mask.reshape(-1).astype(np.float32)
        grads.append((np.asarray(g).reshape(-1) * flat_w, np.asarray(h).reshape(-1) * flat_w))
        prev = pr
    return grads


@pytest.mark.parametrize("seed", [0, 1])
def test_train_lambdamart_general_tie_rule(seed):
    X, labels, mask = _ranking_data(seed)
    kw = dict(n_trees=6, depth=4, learning_rate=0.2, n_bins=32)
    p, p_ref = _params(**kw)
    preds = []
    got = gbdt.train_lambdamart(X, labels, mask, p, k=10, device="cpu")
    want = ref_gbdt.train_lambdamart(X, labels, mask, p_ref, k=10,
                                     callback=lambda t, pr: preds.append(pr))
    flat = X.reshape(-1, X.shape[-1])
    edges = binning.quantile_bins(flat[mask.reshape(-1)], 32)
    Xb = binning.apply_bins(torch.as_tensor(flat), torch.as_tensor(edges)).numpy()
    grads = _lambda_grads(preds, labels, mask, 10)
    check_training_tie_rule(Xb, grads, _trees(got, edges), _trees(want, edges), p)


def test_train_lambdamart_dyadic_first_round_bit_exact():
    """With k = 1, one relevant document per query (listed first) and
    all scores 0, the first round's lambdas are ±1/2 and 1/4: dyadic. Its
    tree is bit-exact; later rounds (``sigmoid`` of nonzero scores) meet
    the tie rule."""
    rng = np.random.default_rng(3)
    Q, D, F = 30, 16, 6
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    labels = np.zeros((Q, D), np.float32)
    labels[:, 0] = 1.0
    mask = np.ones((Q, D), dtype=bool)
    mask[:, 12:] = rng.random((Q, 4)) < 0.5
    kw = dict(n_trees=3, depth=3, learning_rate=0.25, n_bins=16)
    p, p_ref = _params(**kw)
    preds = []
    got = gbdt.train_lambdamart(X, labels, mask, p, k=1, device="cpu")
    want = ref_gbdt.train_lambdamart(X, labels, mask, p_ref, k=1,
                                     callback=lambda t, pr: preds.append(pr))
    grads = _lambda_grads(preds, labels, mask, 1)
    assert set(np.unique(grads[0][0])) <= {-7.5, -7.0, -6.5, -6.0, -5.5, 0.0, 0.5}
    for k in ("feature", "threshold", "leaf_value"):
        assert np.array_equal(getattr(got, k).numpy()[0], np.asarray(getattr(want, k))[0]), k
    flat = X.reshape(-1, F)
    edges = binning.quantile_bins(flat[mask.reshape(-1)], 16)
    Xb = binning.apply_bins(torch.as_tensor(flat), torch.as_tensor(edges)).numpy()
    check_training_tie_rule(Xb, grads, _trees(got, edges), _trees(want, edges), p)


def test_lambdamart_improves_ndcg_like_the_reference_test():
    """The reference's quality bar (``tests/test_forest.py``), on the port."""
    from repro_torch.metrics.ranking import mean_ndcg

    X, labels, mask = _ranking_data(7, Q=60, D=24, F=6)
    p, _ = _params(n_trees=30, depth=4, learning_rate=0.2)
    ens = gbdt.train_lambdamart(X, labels, mask, p, k=10, device="cpu")
    scores = scoring.score_bitvector(ens, torch.as_tensor(X.reshape(-1, 6))).reshape(60, 24)
    t = lambda a: torch.as_tensor(a)
    ndcg = float(mean_ndcg(scores, t(labels), t(mask), k=10))
    rand = float(mean_ndcg(t(np.random.default_rng(0).normal(size=(60, 24)).astype(np.float32)),
                           t(labels), t(mask), k=10))
    assert ndcg > rand + 0.15, (ndcg, rand)


# --- ensembles -----------------------------------------------------------------


def test_to_numpy_feeds_the_reference():
    """A port-trained forest, handed over by ``to_numpy``, builds the same
    reference ensemble and scores bit-exactly with the reference's own."""
    X, y = _pure_leaf_fixture()
    kw = dict(n_trees=4, depth=3, learning_rate=0.5, reg_lambda=0.0, n_bins=64)
    p, p_ref = _params(**kw)
    arrays = gbdt.train_gbdt(X, y, p, device="cpu").to_numpy()
    own = ref_gbdt.train_gbdt(X, y, p_ref)
    handed = ref_ensemble.from_complete_arrays(
        arrays["feature"], arrays["threshold"], arrays["leaf_value"], float(arrays["base_score"])
    )
    for k, v in ref_arrays(handed).items():
        assert v.dtype == arrays[k].dtype and np.array_equal(v, arrays[k]), k
    xj = jnp.asarray(X)
    assert np.array_equal(np.asarray(ref_scoring.score_bitvector(handed, xj)),
                          np.asarray(ref_scoring.score_bitvector(own, xj)))
    # And back: from_numpy(to_numpy(e)) is e.
    back = ensemble.from_numpy(arrays, "cpu")
    assert np.array_equal(back.mask.numpy(), to_port(own).mask.numpy())


def test_from_arrays_irregular_tree_matches_reference():
    feats = [np.array([0, 1, 2]), np.array([1])]
    thrs = [np.array([0.0, -1.0, 0.5], np.float32), np.array([0.25], np.float32)]
    lefts = [np.array([1, -1, -2]), np.array([-2])]
    rights = [np.array([-3, 2, -4]), np.array([-1])]
    leaf_vals = [np.array([1.0, 2.0, 3.0, 4.0], np.float32), np.array([5.0, 6.0], np.float32)]
    got = ensemble.from_arrays(feats, thrs, lefts, rights, leaf_vals, 0.5, device="cpu")
    want = ref_ensemble.from_arrays(feats, thrs, lefts, rights, leaf_vals, 0.5)
    for k, v in got.to_numpy().items():
        assert np.array_equal(v, np.asarray(getattr(want, k))), k
    X = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        scoring.score_bitvector(got, torch.as_tensor(X)).numpy(),
        scoring.score_numpy_oracle(got, X),
    )


def test_concat_level_and_partial_scores_match_reference():
    a = ref_ensemble.random_ensemble(1, n_trees=9, depth=4, n_features=7)
    b = ref_ensemble.random_ensemble(2, n_trees=5, depth=4, n_features=7)
    both = ref_ensemble.concat_ensembles([a, b])
    got = ensemble.concat_ensembles([to_port(a), to_port(b)])
    for k, v in got.to_numpy().items():
        assert np.array_equal(v, np.asarray(getattr(both, k))), k
    X = np.random.default_rng(1).normal(size=(40, 7)).astype(np.float32)
    xt, xj = torch.as_tensor(X), jnp.asarray(X)
    # Plain sums over the tree axis: torch and XLA order them differently,
    # so the reference scorers' own tolerance (tests/test_forest.py).
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    close(scoring.score_level(got, xt), ref_scoring.score_level(both, xj))
    head, tail = scoring.partial_scores(got, xt, sentinel=6)
    ref_head, ref_tail = ref_scoring.partial_scores(both, xj, sentinel=6)
    close(head, ref_head)
    close(tail, ref_tail)
    np.testing.assert_allclose(
        scoring.score_level(got, xt).numpy(), scoring.score_numpy_oracle(got, X),
        rtol=1e-5, atol=1e-5,
    )
