"""Port parity: the plain versions of both forest kernels vs the Pallas kernels.

The port's kernels take their plain PyTorch version for CPU tensors; that
version copies the Pallas kernel's tree-block layout (per-segment no-op
padding, ``block_t = min(16, next_pow2(T))``) and its order of summation
(contiguous-halves pairs inside a block, blocks added in order from 0,
``base_score`` last). It picks the same integer exit leaf, so on finite
inputs it is **bit-exact** with ``repro.kernels.ops.forest_score_range`` /
``forest_score_segments`` run in interpret mode, for every ``leaf_gather``
(whose variants move the same values). Against the numpy traversal oracle
the sums are reordered, so that holds at 1e-5 only (ROADMAP C2).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest import scoring as ref_scoring  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.forest.scoring import score_bitvector, score_numpy_oracle  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import mask_lanes, to_port  # noqa: E402

LEAF_GATHERS = ("onehot", "select", "mxu", "auto")


def _pair(ref, boundaries, leaf_gather, block_t=16):
    port_pf = ops.padded_forest(
        to_port(ref), boundaries=boundaries, block_t=block_t, leaf_gather=leaf_gather
    )
    ref_pf = ref_ops.padded_forest(
        ref, boundaries=boundaries, block_t=block_t, leaf_gather=leaf_gather
    )
    return port_pf, ref_pf


def _assert_same_buffers(port_pf, ref_pf):
    for k in ("feature", "threshold", "leaf_value", "base_score"):
        np.testing.assert_array_equal(
            getattr(port_pf, k).numpy(), np.asarray(getattr(ref_pf, k)), err_msg=k
        )
    lo, hi = mask_lanes(port_pf.mask)
    np.testing.assert_array_equal(lo, np.asarray(ref_pf.mask_lo))
    np.testing.assert_array_equal(hi, np.asarray(ref_pf.mask_hi))
    for k in ("boundaries", "seg_block_starts", "seg_blocks", "block_t",
              "leaf_gather", "leaf_layout"):
        assert getattr(port_pf, k) == getattr(ref_pf, k), k


@pytest.mark.parametrize("depth", [3, 6])
@pytest.mark.parametrize("leaf_gather", LEAF_GATHERS)
def test_range_and_segments_bitexact_vs_pallas(depth, leaf_gather):
    """Every segment range (``seg_lo > 0`` included) and every segmented
    launch over unaligned boundaries (5, 21, T), ragged B = 50."""
    T = 37
    ref = ref_ensemble.random_ensemble(depth, n_trees=T, depth=depth, n_features=21)
    X = np.random.default_rng(depth).normal(size=(50, 21)).astype(np.float32)
    port_pf, ref_pf = _pair(ref, (5, 21, T), leaf_gather)
    _assert_same_buffers(port_pf, ref_pf)
    xt, xj = torch.as_tensor(X), jnp.asarray(X)
    for lo, hi in itertools.combinations(range(4), 2):
        got = ops.forest_score_range(port_pf, xt, lo, hi).numpy()
        want = np.asarray(ref_ops.forest_score_range(ref_pf, xj, lo, hi, interpret=True))
        assert np.array_equal(got, want), (lo, hi, np.abs(got - want).max())
    for S in (1, 2, 3):
        got = ops.forest_score_segments(port_pf, xt, S).numpy()
        want = np.asarray(ref_ops.forest_score_segments(ref_pf, xj, S, interpret=True))
        assert np.array_equal(got, want), S


@pytest.mark.parametrize("n_docs,n_trees,block_t", [
    (8, 1, 16), (33, 7, 16), (96, 48, 1), (96, 48, 4), (40, 36, 12),
])
def test_block_layouts_bitexact_vs_pallas(n_docs, n_trees, block_t):
    """Tree-block sizes 1..16 and a non-power-of-two block (12, whose
    pairwise sum carries an odd element)."""
    ref = ref_ensemble.random_ensemble(1, n_trees=n_trees, depth=5, n_features=24)
    X = np.random.default_rng(n_docs).normal(size=(n_docs, 24)).astype(np.float32)
    port_pf, ref_pf = _pair(ref, None, "auto", block_t=block_t)
    _assert_same_buffers(port_pf, ref_pf)
    got = ops.forest_score_range(port_pf, torch.as_tensor(X)).numpy()
    want = np.asarray(ref_ops.forest_score_range(ref_pf, jnp.asarray(X), interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("leaf_gather", ["onehot", "select", "mxu"])
def test_ragged_leaf_counts_bitexact_vs_pallas(leaf_gather):
    """A native leaf axis that is not a power of two (select pads it)."""
    rng = np.random.default_rng(4)
    ref = ref_ensemble.from_arrays(
        features=[np.array([0, 2]), np.array([1]), np.array([3, 0, 1])],
        thresholds=[rng.normal(size=2), rng.normal(size=1), rng.normal(size=3)],
        lefts=[np.array([1, -1]), np.array([-1]), np.array([1, 2, -1])],
        rights=[np.array([-2, -3]), np.array([-2]), np.array([-4, -3, -2])],
        leaf_values=[rng.normal(size=3), rng.normal(size=2), rng.normal(size=4)],
        base_score=0.5, n_leaves=5,
    )
    X = rng.normal(size=(30, 4)).astype(np.float32)
    port_pf, ref_pf = _pair(ref, None, leaf_gather)
    _assert_same_buffers(port_pf, ref_pf)
    got = ops.forest_score_range(port_pf, torch.as_tensor(X)).numpy()
    want = np.asarray(ref_ops.forest_score_range(ref_pf, jnp.asarray(X), interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_docs,n_trees,depth,n_features", [
    (8, 1, 1, 3), (64, 16, 4, 16), (100, 30, 6, 24), (33, 7, 3, 5),
])
def test_forest_score_matches_traversal_oracle(n_docs, n_trees, depth, n_features):
    ref = ref_ensemble.random_ensemble(0, n_trees, depth, n_features)
    port = to_port(ref)
    X = np.random.default_rng(n_docs + n_trees).normal(
        size=(n_docs, n_features)).astype(np.float32)
    got = ops.forest_score(port, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, score_numpy_oracle(port, X), rtol=1e-5, atol=1e-5)


def test_nonfinite_features_follow_the_oracle_not_pallas():
    """ROADMAP C1: the Pallas kernel gathers features by a one-hot matmul,
    so one NaN or inf feature turns every node of the document into
    ``inf·0 = NaN``. The port gathers for real, as ``kernels/ref.py`` and
    ``score_bitvector`` do: a NaN fails exactly the tests that read it and
    ±inf compares as itself. So non-finite inputs are held to the
    reference's ``score_bitvector``, not to its kernel."""
    ref = ref_ensemble.random_ensemble(0, n_trees=32, depth=3, n_features=16)
    X = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    X[0, 3] = np.nan
    X[1, 5] = np.inf
    X[2, :] = -np.inf
    X[3, 7] = np.nan
    X[3, 8] = -np.inf
    port = to_port(ref)
    got = ops.forest_score(port, torch.as_tensor(X)).numpy()
    want = np.asarray(ref_scoring.score_bitvector(ref, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        score_bitvector(port, torch.as_tensor(X)).numpy(), want, rtol=1e-5, atol=1e-5
    )
    assert np.isfinite(got).all()


def test_ctz64_covers_every_bit():
    bits = torch.arange(64, dtype=torch.int64)
    m = torch.ones(64, dtype=torch.int64) << bits          # bit 63: negative
    assert torch.equal(fs.ctz64(m), bits)
    assert torch.equal(fs.ctz64(m | (m << 1)), bits)       # higher bits ignored
    assert torch.equal(fs.ctz64(torch.full((3,), -1)), torch.zeros(3, dtype=torch.int64))


def test_dispatch_counters_and_cpu_path_is_not_a_launch():
    """``plain``/``segmented`` count dispatches on every device (the
    engine's launch contract); the per-kernel CUDA counters move only
    where a kernel is launched, never on the CPU path."""
    port = to_port(ref_ensemble.random_ensemble(2, n_trees=40, depth=3, n_features=6))
    pf = ops.padded_forest(port, boundaries=(10, 25, 40))
    x = torch.randn(20, 6, generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    build.reset_kernel_launches()
    ops.forest_score_range(pf, x, 1)
    ops.forest_score_segments(pf, x, 2)
    ops.forest_score_range(pf, x, 2, count_as="gated")
    assert ops.launch_counts() == {"plain": 1, "segmented": 1, "gated": 1}
    assert build.kernel_launches() == {
        "forest_score": 0, "forest_score_segments": 0, "sentinel_features": 0,
    }


def test_padded_cache_is_lru_bounded():
    port = to_port(ref_ensemble.random_ensemble(2, n_trees=40, depth=3, n_features=6))
    first = ops.padded_forest(port, boundaries=(1, 40))
    assert ops.padded_forest(port, boundaries=(1, 40)) is first
    for s in range(2, 3 + ops.PADDED_CACHE_MAX):
        ops.padded_forest(port, boundaries=(s, 40))
    assert len(port._padded_cache) == ops.PADDED_CACHE_MAX
    assert ops.padded_forest(port, boundaries=(1, 40)) is not first


def test_wrappers_reject_bad_inputs():
    port = to_port(ref_ensemble.random_ensemble(2, n_trees=20, depth=3, n_features=6))
    pf = ops.padded_forest(port, leaf_gather="onehot")
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        fs.forest_score_kernel(x.double(), *tables, block_t=pf.block_t)
    with pytest.raises(ValueError):
        fs.forest_score_kernel(x, *tables, block_t=pf.block_t, n_tree_blocks=9)
    with pytest.raises(ValueError):
        fs.forest_score_segments_kernel(
            x, *tables, seg_block_starts=(1,), n_tree_blocks=2, block_t=pf.block_t
        )
    with pytest.raises(ValueError):  # select needs a power-of-two leaf axis
        fs.forest_score_kernel(
            x, pf.feature, pf.threshold, pf.mask, pf.leaf_value[:, :7].contiguous(),
            block_t=pf.block_t, leaf_gather="select",
        )
