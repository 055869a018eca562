"""Port parity: learned tree reordering (``repro_torch.forest.reorder``).

- per-tree contributions are bit-exact with the reference's (same exit
  leaves, same leaf values), chunked by rows or not, and the pairwise tree
  sum of them equals the reference's ``_pairwise_tree_sum``;
- greedy and variance orders, prefix residuals and learned orders (with
  the deterministic stride over ``max_docs``) are equal;
- the reordered ensemble scores within the reference's own tolerance of
  1e-4 (``tests/test_reorder.py``) of the reference's reordered ensemble.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest import reorder as ref_reorder  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.forest import reorder  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import to_port  # noqa: E402


def _fixture(seed=3, B=200, T=64, F=16):
    ens = ref_ensemble.random_ensemble(seed, n_trees=T, depth=5, n_features=F)
    rng = np.random.default_rng(seed)
    Xv = rng.standard_normal((B, F)).astype(np.float32)
    X = rng.standard_normal((80, F)).astype(np.float32)
    return ens, Xv, X


@pytest.mark.parametrize("chunk_rows", [7, 64, 512])
def test_contributions_bit_exact_any_chunking(chunk_rows):
    ens, Xv, _ = _fixture()
    got = reorder.per_tree_contributions(to_port(ens), torch.as_tensor(Xv), chunk_rows=chunk_rows)
    want = np.asarray(ref_reorder.per_tree_contributions(ens, jnp.asarray(Xv)))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    full = reorder.full_from_contributions(to_port(ens), got)
    assert np.array_equal(
        full.numpy(), np.asarray(ref_reorder.full_from_contributions(ens, jnp.asarray(want)))
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_orders_and_prefix_residual_equal(seed):
    ens, Xv, _ = _fixture(seed)
    contrib = reorder.per_tree_contributions(to_port(ens), torch.as_tensor(Xv)).numpy()
    for fn in ("greedy_order", "variance_order"):
        got, want = getattr(reorder, fn)(contrib), getattr(ref_reorder, fn)(contrib)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    order = reorder.greedy_order(contrib)
    assert np.array_equal(
        reorder.prefix_residual(contrib, order), ref_reorder.prefix_residual(contrib, order)
    )


@pytest.mark.parametrize("method,max_docs", [
    ("greedy", 4096), ("greedy", 37), ("variance", 50), ("identity", None),
])
def test_learn_order_and_reordered_ensemble(method, max_docs):
    ens, Xv, X = _fixture()
    port = to_port(ens)
    port_ens, order = reorder.reordered_ensemble(port, torch.as_tensor(Xv), method, max_docs)
    ref_ens, ref_order = ref_reorder.reordered_ensemble(ens, jnp.asarray(Xv), method, max_docs)
    assert np.array_equal(order, ref_order)
    for k, v in port_ens.to_numpy().items():
        assert np.array_equal(v, np.asarray(getattr(ref_ens, k))), k
    assert port_ens is not port and len(port_ens._padded_cache) == 0
    got = ops.forest_score(port_ens, torch.as_tensor(X)).numpy()
    want = np.asarray(ref_ops.forest_score(ref_ens, jnp.asarray(X), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_reorder_trees_scores_like_the_original():
    ens, _, X = _fixture()
    perm = np.random.default_rng(0).permutation(ens.n_trees)
    permuted = reorder.reorder_trees(to_port(ens), perm)
    np.testing.assert_allclose(
        ops.forest_score(permuted, torch.as_tensor(X)).numpy(),
        np.asarray(ref_ops.forest_score(ens, jnp.asarray(X), interpret=True)),
        rtol=1e-4, atol=1e-4,
    )
    same = reorder.reorder_trees(to_port(ens), np.arange(ens.n_trees))
    assert torch.equal(ops.forest_score(same, torch.as_tensor(X)),
                       ops.forest_score(to_port(ens), torch.as_tensor(X)))


@pytest.mark.parametrize("order", [np.arange(5), np.array([0] * 64), np.arange(1, 65)])
def test_reorder_rejects_non_permutations(order):
    ens, _, _ = _fixture()
    with pytest.raises(ValueError):
        reorder.reorder_trees(to_port(ens), order)
    with pytest.raises(ValueError):
        reorder.learn_order(to_port(ens), torch.zeros(4, 16), method="random")
