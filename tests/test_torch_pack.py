"""The CUDA kernels' packed tables and launch checks, held on the CPU.

The kernels read one 16-byte record per node, ``{feature, threshold,
mask}``, and leaf rows padded to a multiple of 4, built once per buffer set
by ``padded_forest``. Here the records are held field for field to the
port's separate buffers and to the JAX reference's (``mask_lo`` /
``mask_hi``), padded trees and nodes included; the wrapper's limits
(``block_t``, segments, and F against a stand-in for the library's
limit) are held where they need no card; and the build key is held to
move with every file under ``csrc/`` and the flags.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import to_port  # noqa: E402


def _ragged():
    rng = np.random.default_rng(4)
    return ref_ensemble.from_arrays(
        features=[np.array([0, 2]), np.array([1]), np.array([3, 0, 1])],
        thresholds=[rng.normal(size=2), rng.normal(size=1), rng.normal(size=3)],
        lefts=[np.array([1, -1]), np.array([-1]), np.array([1, 2, -1])],
        rights=[np.array([-2, -3]), np.array([-2]), np.array([-4, -3, -2])],
        leaf_values=[rng.normal(size=3), rng.normal(size=2), rng.normal(size=4)],
        base_score=0.5, n_leaves=5,
    )


@pytest.mark.parametrize("make,boundaries,leaf_gather,block_t", [
    (lambda: ref_ensemble.random_ensemble(3, n_trees=37, depth=6, n_features=11),
     (5, 21, 37), "select", 16),
    (lambda: ref_ensemble.random_ensemble(5, n_trees=20, depth=3, n_features=7),
     None, "onehot", 8),
    (lambda: ref_ensemble.random_ensemble(6, n_trees=9, depth=5, n_features=4),
     (1, 9), "mxu", 4),
    (_ragged, None, "onehot", 16),
    (_ragged, (2, 3), "select", 1),
])
def test_packed_records_equal_the_separate_buffers(make, boundaries, leaf_gather, block_t):
    ref = make()
    pf = ops.padded_forest(
        to_port(ref), boundaries=boundaries, block_t=block_t, leaf_gather=leaf_gather
    )
    ref_pf = ref_ops.padded_forest(
        ref, boundaries=boundaries, block_t=block_t, leaf_gather=leaf_gather
    )
    T, N = pf.feature.shape
    assert pf.nodes.shape == (T, N, 4) and pf.nodes.dtype == torch.int32
    assert pf.nodes.is_contiguous() and pf.nodes.element_size() * 4 == fs.NODE_BYTES
    words = pf.nodes.numpy()
    np.testing.assert_array_equal(words[..., 0], pf.feature.numpy())
    np.testing.assert_array_equal(words[..., 1].view(np.float32), pf.threshold.numpy())
    lo, hi = words[..., 2].view(np.uint32), words[..., 3].view(np.uint32)
    np.testing.assert_array_equal(lo, np.asarray(ref_pf.mask_lo))
    np.testing.assert_array_equal(hi, np.asarray(ref_pf.mask_hi))
    joined = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    np.testing.assert_array_equal(joined.view(np.int64), pf.mask.numpy())
    np.testing.assert_array_equal(words[..., 0], np.asarray(ref_pf.feature))
    np.testing.assert_array_equal(
        words[..., 1].view(np.float32), np.asarray(ref_pf.threshold)
    )
    # Padded trees and padded nodes are in the records too: +inf never fails.
    assert np.isinf(words[..., 1].view(np.float32)).any() == bool(
        np.isinf(pf.threshold.numpy()).any()
    )

    L = pf.leaf_value.shape[1]
    leaves = pf.leaves.numpy()
    assert leaves.shape == (T, L + (-L) % 4) and leaves.shape[1] % 4 == 0
    np.testing.assert_array_equal(leaves[:, :L], pf.leaf_value.numpy())
    np.testing.assert_array_equal(leaves[:, L:], 0.0)
    assert pf.packed == (pf.nodes, pf.leaves)


def test_padded_records_are_no_op_nodes():
    """Tree and node padding packs as threshold +inf, an all-ones mask."""
    ref = ref_ensemble.random_ensemble(2, n_trees=5, depth=2, n_features=3)
    pf = ops.padded_forest(to_port(ref), block_t=8, leaf_gather="onehot")
    words = pf.nodes.numpy()
    pad_tree = words[5:]                       # trees 5..7 pad the block of 8
    assert pad_tree.shape[0] == 3
    assert np.isposinf(pad_tree[..., 1].view(np.float32)).all()
    assert (pad_tree[..., 2] == -1).all() and (pad_tree[..., 3] == -1).all()
    pad_node = words[:5, 3]                    # 3 real nodes padded to 4
    assert np.isposinf(pad_node[:, 1].view(np.float32)).all()
    assert (pad_node[:, 2:] == -1).all()


@pytest.fixture
def f_limit(monkeypatch):
    """The library's F limit, stood in for by ``7·N + L + block_t``: the
    shapes it was asked for are recorded."""
    asked = []

    def stub(n, l, bt, device=None):
        asked.append((n, l, bt))
        return 7 * n + l + bt

    monkeypatch.setattr(fs, "cuda_max_features", stub)
    return asked


@pytest.mark.parametrize("N,L,block_t", [(64, 64, 16), (32, 32, 16), (2, 3, 1), (128, 128, 32)])
def test_widest_x_the_kernels_take(f_limit, N, L, block_t):
    """F up to the library's limit passes; one more and 0 raise; the check
    asks for these tables' shapes."""
    f = 7 * N + L + block_t
    fs.check_cuda_shapes(f, N, L, block_t)
    with pytest.raises(ValueError, match=rf"F={f + 1} features outside \[1, {f}\]"):
        fs.check_cuda_shapes(f + 1, N, L, block_t)
    with pytest.raises(ValueError, match="features"):
        fs.check_cuda_shapes(0, N, L, block_t)
    assert set(f_limit) == {(N, L, block_t)}


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    """On the CPU the wrappers run the plain version, whatever the CUDA
    limits: neither the library nor its F limit is consulted."""
    def no_library():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(fs, "library", no_library)
    ens = to_port(ref_ensemble.random_ensemble(9, n_trees=12, depth=3, n_features=3000))
    pf = ops.padded_forest(ens, boundaries=(4, 12), block_t=4)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 3000)).astype(np.float32))
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    got = fs.forest_score_kernel(x, *tables, block_t=4, tree_block_offset=0, n_tree_blocks=3)
    want = fs.forest_score_plain(x, *tables, block_t=4, tree_block_offset=0, n_tree_blocks=3)
    assert torch.equal(got, want)
    seg = fs.forest_score_segments_kernel(
        x, *tables, seg_block_starts=pf.seg_block_starts, n_tree_blocks=3, block_t=4
    )
    assert seg.shape == (5, 2)


@pytest.mark.parametrize("block_t", [0, 3, 12, 64])
def test_block_t_without_an_instantiation_raises(f_limit, block_t):
    with pytest.raises(ValueError, match="block_t"):
        fs.check_cuda_shapes(8, 16, 16, block_t)


def test_every_instantiated_block_t_is_accepted(f_limit):
    for block_t in fs.CUDA_BLOCK_TS:
        fs.check_cuda_shapes(8, 16, 16, block_t)


@pytest.mark.parametrize("n_seg,ok", [(1, True), (16, True), (17, False), (0, False)])
def test_segment_count_limit(f_limit, n_seg, ok):
    if ok:
        fs.check_cuda_shapes(8, 16, 16, 16, n_seg)
    else:
        with pytest.raises(ValueError, match="segments"):
            fs.check_cuda_shapes(8, 16, 16, 16, n_seg)


def test_pack_on_the_fly_equals_the_cached_copy():
    ref = ref_ensemble.random_ensemble(8, n_trees=30, depth=4, n_features=9)
    pf = ops.padded_forest(to_port(ref), boundaries=(10, 30))
    assert torch.equal(fs.pack_nodes(pf.feature, pf.threshold, pf.mask), pf.nodes)
    assert torch.equal(fs.pack_leaves(pf.leaf_value), pf.leaves)


def test_build_key_moves_with_every_source_and_flag(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (csrc / "k.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (csrc / "notes.txt").write_text("not a source")
    assert build.library_path("k") == second
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build.library_path("k") != second
