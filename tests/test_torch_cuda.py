"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with sm_90a and nvcc; elsewhere each one
skips (the decision is taken inside the test, never at import). Run them on
the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain versions are held to the JAX reference by the CPU tests
(``tests/test_torch_kernels.py``); here every kernel launch must equal its
plain version exactly (same integer leaf choice, same f32 add order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.forest.ensemble import random_ensemble  # noqa: E402
from repro_torch.forest.scoring import score_bitvector  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _x(rng, B, F, dev):
    return torch.as_tensor(rng.normal(size=(B, F)).astype(np.float32), device=dev)


def _both(pf, x, seg_lo, seg_hi):
    kw = dict(
        block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[seg_lo],
        n_tree_blocks=sum(pf.seg_blocks[seg_lo:seg_hi]),
    )
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    got = fs.forest_score_kernel(x, *tables, leaf_gather=pf.leaf_gather, **kw)
    return got, fs.forest_score_plain(x, *tables, **kw)


@pytest.mark.parametrize("n_trees,depth,block_t", [
    (1, 1, 16), (3, 2, 16), (7, 3, 4), (37, 6, 16), (64, 6, 32), (50, 5, 8),
    (33, 4, 1), (20, 6, 2),
])
@pytest.mark.parametrize("B", [1, 7, 129, 300])
def test_range_kernel_equals_plain(dev, n_trees, depth, block_t, B):
    rng = np.random.default_rng(n_trees * 1000 + B)
    ens = random_ensemble(n_trees, n_trees, depth, 19, device=dev)
    bounds = tuple(sorted({max(1, n_trees // 3), n_trees}))
    pf = ops.padded_forest(ens, boundaries=bounds, block_t=block_t)
    x = _x(rng, B, 19, dev)
    for lo in range(pf.n_segments):
        for hi in range(lo + 1, pf.n_segments + 1):
            got, want = _both(pf, x, lo, hi)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lo, hi)


@pytest.mark.parametrize("sentinels", [(16,), (5, 21), (5, 19, 33), (3, 9, 17, 30)])
@pytest.mark.parametrize("leaf_gather", ["onehot", "select", "mxu"])
def test_segments_kernel_equals_plain(dev, sentinels, leaf_gather):
    rng = np.random.default_rng(len(sentinels))
    ens = random_ensemble(5, 37, 5, 23, device=dev)
    pf = ops.padded_forest(ens, boundaries=(*sentinels, 37), leaf_gather=leaf_gather)
    x = _x(rng, 517, 23, dev)
    S = len(sentinels)
    kw = dict(
        seg_block_starts=pf.seg_block_starts[:S],
        n_tree_blocks=pf.seg_block_starts[S - 1] + pf.seg_blocks[S - 1],
        block_t=pf.block_t,
    )
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    got = fs.forest_score_segments_kernel(x, *tables, leaf_gather=leaf_gather, **kw)
    want = fs.forest_score_segments_plain(x, *tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_nonfinite_features_follow_the_oracle(dev):
    """NaN fails every test it meets; ±inf compares as itself (true
    gather, unlike the Pallas kernel's one-hot matmul — ROADMAP C1)."""
    rng = np.random.default_rng(9)
    ens = random_ensemble(4, 32, 3, 16, device=dev)
    x = _x(rng, 64, 16, dev)
    x[0, 3] = float("nan")
    x[1, 5] = float("inf")
    x[2, :] = -float("inf")
    got = ops.forest_score(ens, x)
    want = score_bitvector(ens, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_launch_counter_counts_kernel_launches_only(dev):
    ens = random_ensemble(1, 20, 4, 8, device=dev)
    x = _x(np.random.default_rng(1), 40, 8, dev)
    fs.reset_kernel_launches()
    ops.forest_score(ens, x)
    ops.forest_score(ens.to("cpu"), x.cpu())  # plain path: not a launch
    assert fs.kernel_launches() == {"forest_score": 1, "forest_score_segments": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ens = random_ensemble(1, 20, 4, 8, device=dev)
    pf = ops.padded_forest(ens)
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    x = _x(np.random.default_rng(2), 16, 8, dev)
    with pytest.raises(ValueError):
        fs.forest_score_kernel(x.cpu(), *tables, block_t=pf.block_t)
    with pytest.raises(ValueError):
        fs.forest_score_kernel(x.double(), *tables, block_t=pf.block_t)
    with pytest.raises(ValueError):
        fs.forest_score_kernel(x.t().contiguous().t(), *tables, block_t=pf.block_t)
