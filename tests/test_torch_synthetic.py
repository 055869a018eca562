"""Port parity: the synthetic LETOR data, its splits, quantile binning and
the classification metrics.

The generator and the edges are numpy in both packages, and binning only
compares values, so every array must be bit-equal to the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.forest import binning as ref_binning  # noqa: E402
from repro.metrics import classification as ref_classification  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.forest import binning  # noqa: E402
from repro_torch.metrics import classification  # noqa: E402


def _same_dataset(a, b):
    assert a.name == b.name
    for field in ("X", "labels", "mask"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert np.array_equal(x, y), field


@pytest.mark.parametrize("kw", [
    dict(preset="msn1", n_queries=12, max_docs=64, seed=0),
    dict(preset="msn1", n_queries=7, seed=3),
    dict(preset="istella", n_queries=5, docs_scale=0.1, seed=1),
    dict(preset="msn1", n_queries=9, max_docs=32, n_features=24, seed=11),
])
def test_make_letor_dataset_bit_exact(kw):
    _same_dataset(synthetic.make_letor_dataset(**kw), ref_synthetic.make_letor_dataset(**kw))


def test_presets_equal():
    assert synthetic.PRESETS.keys() == ref_synthetic.PRESETS.keys()
    for name, p in synthetic.PRESETS.items():
        r = ref_synthetic.PRESETS[name]
        assert (p.n_features, p.mean_docs, p.label_probs) == (
            r.n_features, r.mean_docs, r.label_probs
        )


@pytest.mark.parametrize("n_queries", [20, 37])
def test_splits_and_select_bit_exact(n_queries):
    kw = dict(n_queries=n_queries, max_docs=16, n_features=8, seed=n_queries)
    port = synthetic.make_letor_dataset(**kw).splits()
    ref = ref_synthetic.make_letor_dataset(**kw).splits()
    assert list(port) == list(ref) == ["train", "classifier", "tune", "test"]
    for name in port:
        _same_dataset(port[name], ref[name])
    idx = np.array([3, 0, 5])
    data = synthetic.make_letor_dataset(**kw)
    _same_dataset(data.select(idx), ref_synthetic.make_letor_dataset(**kw).select(idx))
    assert data.n_queries == n_queries


def _binning_data(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(700, 6)).astype(np.float32)
    X[:, 2] = rng.integers(0, 3, size=700)      # low cardinality: +inf padded edges
    X[:, 4] = 1.5                               # constant feature
    X[::7, 5] = np.round(X[::7, 5], 1)           # repeated values
    return X


@pytest.mark.parametrize("n_bins", [4, 32, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantile_and_apply_bins_bit_exact(n_bins, seed):
    X = _binning_data(seed)
    edges = binning.quantile_bins(X, n_bins)
    ref_edges = ref_binning.quantile_bins(X, n_bins)
    assert edges.dtype == ref_edges.dtype and np.array_equal(edges, ref_edges)
    # Bin the data and the edges themselves (x == edge goes left) and ±inf.
    probe = np.concatenate([X, edges.T[:, :6] if n_bins > 6 else X[:1]], axis=0)
    probe = np.concatenate([probe, np.full((1, 6), np.inf, np.float32),
                            np.full((1, 6), -np.inf, np.float32)])
    got = binning.apply_bins(torch.as_tensor(probe), torch.as_tensor(edges))
    want = np.asarray(ref_binning.apply_bins(jnp.asarray(probe), jnp.asarray(edges)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_bin_to_threshold_equal():
    X = _binning_data(2)
    edges = binning.quantile_bins(X, 16)
    rng = np.random.default_rng(0)
    feat = rng.integers(0, 6, size=(5, 7))
    b = rng.integers(0, 16, size=(5, 7))  # 15 = the dead node's all-left bin
    got = binning.bin_to_threshold(edges, feat, b)
    assert np.array_equal(got, ref_binning.bin_to_threshold(edges, feat, b))
    assert np.isinf(got[b == 15]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precision_recall_equal(seed):
    rng = np.random.default_rng(seed)
    pred = rng.random((6, 20)) < 0.4
    true = rng.random((6, 20)) < 0.3
    mask = rng.random((6, 20)) < 0.8
    if seed == 2:
        pred[:] = False  # no predicted Continue: the max(…, 1) guard
    got = classification.precision_recall(
        torch.as_tensor(pred), torch.as_tensor(true), torch.as_tensor(mask)
    )
    want = ref_classification.precision_recall(
        jnp.asarray(pred), jnp.asarray(true), jnp.asarray(mask)
    )
    assert got == want
