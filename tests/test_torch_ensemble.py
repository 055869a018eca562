"""Port parity: the ensemble layout, the weight converter and the oracles.

The same trees go to both packages through numpy: the port's
``from_numpy`` must carry every field over exactly (the two uint32 mask
lanes become one int64 pattern and split back unchanged), its numpy-only
``random_ensemble`` must draw the reference's trees for the same seed, and
its scorers must agree with the reference's (``score_bitvector`` sums the
trees in one reduction whose order may differ, hence 1e-5 as in
``tests/test_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest import scoring as ref_scoring  # noqa: E402
from repro_torch.forest import ensemble as port_ensemble  # noqa: E402
from repro_torch.forest import scoring as port_scoring  # noqa: E402
from torch_parity import mask_lanes, ref_arrays, to_port  # noqa: E402

PORT_FIELDS = ("feature", "threshold", "left", "right", "leaf_value", "base_score")


def _assert_same_trees(port, ref):
    arr = ref_arrays(ref)
    for k in PORT_FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), arr[k], err_msg=k)
    lo, hi = mask_lanes(port.mask)
    np.testing.assert_array_equal(lo, arr["mask_lo"])
    np.testing.assert_array_equal(hi, arr["mask_hi"])


@pytest.mark.parametrize("depth", [1, 3, 6])
def test_converter_round_trip(depth):
    ref = ref_ensemble.random_ensemble(depth, n_trees=9, depth=depth, n_features=7)
    port = to_port(ref)
    _assert_same_trees(port, ref)
    assert port.mask.dtype == torch.int64
    assert (port.n_trees, port.n_nodes, port.n_leaves, port.depth) == (
        ref.n_trees, ref.n_nodes, ref.n_leaves, ref.depth
    )


def test_converter_carries_ragged_trees_and_base_score():
    """Non-complete trees (``from_arrays``: ragged leaf counts, padded
    nodes with all-ones masks) and a nonzero base score."""
    rng = np.random.default_rng(0)
    left = [np.array([1, -1]), np.array([-1])]
    right = [np.array([-2, -3]), np.array([-2])]
    ref = ref_ensemble.from_arrays(
        features=[np.array([0, 2]), np.array([1])],
        thresholds=[rng.normal(size=2), rng.normal(size=1)],
        lefts=left, rights=right,
        leaf_values=[rng.normal(size=3), rng.normal(size=2)],
        base_score=0.25,
    )
    _assert_same_trees(to_port(ref), ref)


@pytest.mark.parametrize("seed,n_trees,depth,n_features", [
    (0, 24, 4, 16), (3, 37, 6, 21), (11, 5, 2, 3),
])
def test_random_ensemble_matches_reference(seed, n_trees, depth, n_features):
    ref = ref_ensemble.random_ensemble(seed, n_trees, depth, n_features)
    port = port_ensemble.random_ensemble(seed, n_trees, depth, n_features, device="cpu")
    _assert_same_trees(port, ref)


def test_from_complete_arrays_matches_reference():
    rng = np.random.default_rng(5)
    feature = rng.integers(0, 9, size=(6, 15))
    threshold = rng.normal(size=(6, 15))
    leaves = rng.normal(size=(6, 16))
    ref = ref_ensemble.from_complete_arrays(feature, threshold, leaves, -0.5)
    port = port_ensemble.from_complete_arrays(
        feature, threshold, leaves, -0.5, device="cpu"
    )
    _assert_same_trees(port, ref)


@pytest.mark.parametrize("start,stop", [(0, 10), (10, 37), (5, 21)])
def test_slice_trees_matches_reference(start, stop):
    ref = ref_ensemble.from_complete_arrays(
        *(np.random.default_rng(1).normal(size=s) for s in ((37, 7), (37, 7), (37, 8))),
        base_score=0.75,
    )
    _assert_same_trees(
        port_ensemble.slice_trees(to_port(ref), start, stop),
        ref_ensemble.slice_trees(ref, start, stop),
    )


@pytest.mark.parametrize("n_docs,n_trees,depth,n_features", [
    (8, 1, 1, 3), (64, 16, 4, 16), (100, 30, 6, 24), (33, 7, 3, 5),
])
def test_scorers_match_reference(n_docs, n_trees, depth, n_features):
    rng = np.random.default_rng(n_docs + n_trees)
    ref = ref_ensemble.random_ensemble(2, n_trees, depth, n_features)
    port = to_port(ref)
    X = rng.normal(size=(n_docs, n_features)).astype(np.float32)

    oracle = ref_scoring.score_numpy_oracle(ref, X)
    np.testing.assert_array_equal(port_scoring.score_numpy_oracle(port, X), oracle)

    got, per_tree = port_scoring.score_bitvector(port, torch.as_tensor(X), True)
    want, want_per_tree = ref_scoring.score_bitvector(ref, jnp.asarray(X), True)
    np.testing.assert_array_equal(per_tree.numpy(), np.asarray(want_per_tree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        port_scoring.exit_leaves_bitvector(port, torch.as_tensor(X)).numpy(),
        np.asarray(ref_scoring.exit_leaves_bitvector(ref, jnp.asarray(X))),
    )


def test_entry_points_need_a_device_choice_without_a_card():
    """With no card, ``device=None`` (the card) raises instead of running
    on the CPU; ``device="cpu"`` is the explicit CPU request."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ensemble.random_ensemble(0, 4, 2, 3)
    assert port_ensemble.random_ensemble(0, 4, 2, 3, device="cpu").device.type == "cpu"
