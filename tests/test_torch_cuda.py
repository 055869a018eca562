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
from torch_parity import check_tree_tie_rule  # noqa: E402

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


# ---------------------------------------------------------------------------
# The launch decomposition: document tiles x chunks of tree blocks, the
# trees of a block split across warps, the per-block partials and the last
# CTA's in-order sum. GRID_PLAN forces the warps on documents (the tile
# width), the warps on trees and the chunk (tree blocks per CTA); 0 is the
# launcher's own choice.
# ---------------------------------------------------------------------------

PLANS = [(0, 0, 0), (1, 1, 5), (4, 1, 2), (2, 2, 1), (1, 4, 3), (4, 2, 0)]


def _tables(pf):
    return pf.feature, pf.threshold, pf.mask, pf.leaf_value


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("n_blocks", [1, 63, 67])
@pytest.mark.parametrize("B", [1, 31, 33, 513, 1000])
def test_range_kernel_decompositions(dev, monkeypatch, B, n_blocks, plan):
    """B around the tile widths (32·warps) and not a multiple of any tile;
    n_blocks that the forced chunks 5, 2 and 3 do not divide; tree blocks
    split across 1, 2 and 4 warps."""
    monkeypatch.setattr(fs, "GRID_PLAN", plan)
    block_t = 4
    ens = random_ensemble(B + n_blocks, n_blocks * block_t, 4, 13, device=dev)
    pf = ops.padded_forest(ens, block_t=block_t)
    x = _x(np.random.default_rng(B), B, 13, dev)
    kw = dict(block_t=block_t, tree_block_offset=0, n_tree_blocks=n_blocks)
    got = fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    want = fs.forest_score_plain(x, *_tables(pf), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("offset,n", [(1, 66), (5, 60), (66, 1), (30, 7)])
def test_range_kernel_with_a_tree_block_offset(dev, monkeypatch, offset, n, plan):
    monkeypatch.setattr(fs, "GRID_PLAN", plan)
    ens = random_ensemble(11, 67 * 4, 5, 17, device=dev)
    pf = ops.padded_forest(ens, block_t=4)
    x = _x(np.random.default_rng(offset), 300, 17, dev)
    kw = dict(block_t=4, tree_block_offset=offset, n_tree_blocks=n)
    got = fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    want = fs.forest_score_plain(x, *_tables(pf), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _seg_starts(S, n_blocks, chunk, where, rng):
    """S ascending starts from 0: on chunk edges (multiples of ``chunk``)
    or strictly inside chunks."""
    if where == "edge":
        pool = np.arange(chunk, n_blocks, chunk)
    else:
        pool = np.array([j for j in range(1, n_blocks) if j % chunk])
    return (0, *sorted(int(j) for j in rng.choice(pool, S - 1, replace=False)))


@pytest.mark.parametrize("where", ["edge", "inside"])
@pytest.mark.parametrize("S", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("plan", [(0, 0, 0), (1, 1, 4), (4, 2, 3), (2, 1, 0)])
def test_segments_kernel_decompositions(dev, monkeypatch, S, where, plan):
    """Segment starts on a chunk edge and inside a chunk, S = 1..16; each
    column also equals the range kernel launched over the same blocks."""
    monkeypatch.setattr(fs, "GRID_PLAN", plan)
    chunk = plan[2] or 4
    n_blocks = 70
    rng = np.random.default_rng(S * 7 + len(where))
    ens = random_ensemble(S, n_blocks * 2, 4, 21, device=dev)
    pf = ops.padded_forest(ens, block_t=2)
    starts = _seg_starts(S, n_blocks, chunk, where, rng)
    x = _x(rng, 517, 21, dev)
    kw = dict(seg_block_starts=starts, n_tree_blocks=n_blocks, block_t=2)
    got = fs.forest_score_segments_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    want = fs.forest_score_segments_plain(x, *_tables(pf), **kw)
    ends = (*starts[1:], n_blocks)
    cols = [
        fs.forest_score_kernel(
            x, *_tables(pf), packed=pf.packed, block_t=2,
            tree_block_offset=lo, n_tree_blocks=hi - lo,
        )
        for lo, hi in zip(starts, ends)
    ]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, torch.stack(cols, dim=1))


@pytest.mark.parametrize("block_t", fs.CUDA_BLOCK_TS)
@pytest.mark.parametrize("plan", [(0, 0, 0), (1, 1, 3), (2, 0, 2)])
def test_every_block_t_instantiation(dev, monkeypatch, block_t, plan):
    """Both kernels at every block_t the library instantiates."""
    monkeypatch.setattr(fs, "GRID_PLAN", plan)
    n_trees = 9 * block_t
    ens = random_ensemble(block_t, n_trees, 6, 19, device=dev)
    pf = ops.padded_forest(
        ens, boundaries=(2 * block_t, 5 * block_t + 1, n_trees), block_t=block_t
    )
    x = _x(np.random.default_rng(block_t), 200, 19, dev)
    got, want = _both(pf, x, 0, pf.n_segments)
    S = pf.n_segments
    kw = dict(
        seg_block_starts=pf.seg_block_starts, n_tree_blocks=sum(pf.seg_blocks),
        block_t=block_t,
    )
    got_s = fs.forest_score_segments_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    want_s = fs.forest_score_segments_plain(x, *_tables(pf), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got_s.shape == (200, S) and torch.equal(got_s, want_s)


def test_widest_x_the_wrapper_accepts_and_one_more(dev):
    N_trees, depth, block_t = 40, 6, 16
    ens = random_ensemble(3, N_trees, depth, 8, device=dev)
    pf = ops.padded_forest(ens, block_t=block_t)
    N, L = pf.feature.shape[1], pf.leaf_value.shape[1]
    f_max = fs.cuda_max_features(N, L, block_t)
    rng = np.random.default_rng(0)
    for F in (f_max, f_max + 1):
        # Trees test features spread over the whole row, the last one included.
        wide = random_ensemble(5, N_trees, depth, F, device=dev)
        wpf = ops.padded_forest(wide, block_t=block_t)
        x = _x(rng, 100, F, dev)
        kw = dict(block_t=block_t, tree_block_offset=0, n_tree_blocks=wpf.seg_blocks[0])
        if F == f_max:
            got = fs.forest_score_kernel(x, *_tables(wpf), packed=wpf.packed, **kw)
            want = fs.forest_score_plain(x, *_tables(wpf), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        else:
            with pytest.raises(ValueError, match="features"):
                fs.forest_score_kernel(x, *_tables(wpf), packed=wpf.packed, **kw)


def test_unpacked_call_and_repeated_launches_agree(dev):
    """A call without ``packed`` packs on the fly; back-to-back launches on
    one stream and a launch on a side stream reuse the arrival counters."""
    ens = random_ensemble(2, 300, 6, 30, device=dev)
    pf = ops.padded_forest(ens, boundaries=(50, 300))
    x = _x(np.random.default_rng(3), 700, 30, dev)
    kw = dict(block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[1],
              n_tree_blocks=pf.seg_blocks[1])
    want = fs.forest_score_plain(x, *_tables(pf), **kw)
    outs = [fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw) for _ in range(5)]
    outs.append(fs.forest_score_kernel(x, *_tables(pf), **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, want)


def test_wrapper_rejects_a_block_t_without_an_instantiation(dev):
    ens = random_ensemble(1, 24, 3, 8, device=dev)
    pf = ops.padded_forest(ens, block_t=12)   # the plain version takes 12
    x = _x(np.random.default_rng(4), 16, 8, dev)
    with pytest.raises(ValueError, match="block_t"):
        fs.forest_score_kernel(x, *_tables(pf), block_t=12)


def test_launch_plan_fills_the_card_at_the_tail_sizes(dev):
    """At the serving tail's sizes the launcher's grid covers every SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (512, 1024, 2048):
        plan = fs.launch_plan(B, 136, 64, 64, 16, 63)
        assert plan["tiles"] * plan["chunks"] >= sms, (B, plan)
        assert plan["tiles"] * plan["tile"] >= B


def test_lear_msn1_shapes_fit_the_widest_tile(dev, monkeypatch):
    """The serving path's tables leave room for the 4-warp document tile
    (with 2 tree warps) at its F: the ranker's (N 64, F 136) and the
    classifier's (N 32, F 140)."""
    monkeypatch.setattr(fs, "GRID_PLAN", (4, 2, 0))
    for N, L, F in ((64, 64, 136), (32, 32, 140)):
        assert fs.cuda_max_features(N, L, 16) >= F
        fs.check_cuda_shapes(F, N, L, 16)
        plan = fs.launch_plan(2048, F, N, L, 16, 63)
        assert (plan["warps_d"], plan["warps_t"]) == (4, 2) and plan["ctas_per_sm"] >= 1


# ---------------------------------------------------------------------------
# The gated tail: the kernel reads the survivor count (n_valid) on the
# device; rows at or past it are 0, rows below it equal the ungated launch.
# ---------------------------------------------------------------------------


def _tail(dev, B, seed=7):
    ens = random_ensemble(seed, 300, 6, 136, device=dev)
    pf = ops.padded_forest(ens, boundaries=(50, 300))
    x = _x(np.random.default_rng(B), B, 136, dev)
    kw = dict(block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[1],
              n_tree_blocks=pf.seg_blocks[1])
    return pf, x, kw


@pytest.mark.parametrize("plan", [(0, 0, 0), (1, 1, 5), (4, 2, 1), (2, 2, 1000)])
@pytest.mark.parametrize("B", [33, 1024, 2048])
def test_gated_kernel_equals_plain(dev, monkeypatch, B, plan):
    """Counts 0, 1, 31, 33, B−1 and B, under one-chunk grids (every block
    in one CTA) and many-chunk grids (the last CTA's in-order sum)."""
    monkeypatch.setattr(fs, "GRID_PLAN", plan)
    pf, x, kw = _tail(dev, B)
    ungated = fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    for count in sorted({0, 1, 31, 33, B - 1, B}):
        n = torch.tensor(count, dtype=torch.int32, device=dev)
        got = fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, n_valid=n, **kw)
        want = fs.forest_score_plain(x, *_tables(pf), n_valid=n, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), count
        assert torch.equal(got[:count], ungated[:count]), count
        assert not got[count:].any(), count


def test_gated_launch_counts_once_even_with_no_survivors(dev):
    pf, x, _ = _tail(dev, 64)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    fs.reset_kernel_launches()
    out = ops.forest_score_range(pf, x, seg_lo=1, count_as="gated", n_valid=zero)
    torch.cuda.synchronize()
    assert not out.any()
    assert ops.launch_counts() == {"plain": 0, "segmented": 0, "gated": 1}
    assert fs.kernel_launches() == {"forest_score": 1, "forest_score_segments": 0}


def test_gated_launch_on_a_side_stream(dev):
    """The compaction writes the count on a side stream and the gated launch
    reads it there, in stream order, with no host read between."""
    from repro_torch.core.compaction import compact_indices_cumsum

    pf, x, kw = _tail(dev, 1024)
    alive = torch.as_tensor(np.random.default_rng(2).random(1024) < 0.3, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sel, n_cont = compact_indices_cumsum(alive, 512)
        n = n_cont.to(torch.int32)
        got = ops.forest_score_range(pf, x[sel], seg_lo=1, count_as="gated", n_valid=n)
    torch.cuda.synchronize()
    want = fs.forest_score_plain(x[sel], *_tables(pf), n_valid=n, **kw)
    assert torch.equal(got, want)
    assert int(n) == int(alive.sum()) and got[int(n):].eq(0).all()


def test_plans_count_new_shapes_only(dev):
    """A new B makes one plan, which the gated launch shares (the gate
    changes no plan); the same B again makes none, whatever the count."""
    pf, x, kw = _tail(dev, 777)
    before = fs.first_touches()["plans"]
    fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    assert fs.first_touches()["plans"] == before + 1
    for count in (100, 0, 777):
        n = torch.tensor(count, dtype=torch.int32, device=dev)
        fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, n_valid=n, **kw)
    fs.forest_score_kernel(x, *_tables(pf), packed=pf.packed, **kw)
    torch.cuda.synchronize()
    assert fs.first_touches()["plans"] == before + 1


def test_engine_with_query_exit_equals_the_cpu(dev):
    """The engine's gated tail on the card against the same engine on the
    CPU (plain versions): scores, masks and exited queries equal."""
    from repro_torch.core.cascade import CascadeRanker
    from repro_torch.core.stage import EngineConfig
    from repro_torch.core.strategies import QueryExitConfig, ept_continue

    rng = np.random.default_rng(12)
    X = rng.normal(size=(8, 64, 20)).astype(np.float32)
    mask = rng.random((8, 64)) < 0.9
    outs = {}
    for d in (dev, torch.device("cpu")):
        ens = random_ensemble(12, 120, 5, 20, device=d)
        for margin in (0.1, 0.0):
            cfg = EngineConfig.trees(
                (10, 30), mode="fused", query_exit=QueryExitConfig(k=3, margin=margin)
            )
            r = CascadeRanker(ens, 10, ept_continue).rank_progressive(
                torch.as_tensor(X, device=d), torch.as_tensor(mask, device=d), cfg,
                k_s=5, p=0.5,
            )
            outs[(d.type, margin)] = (r.scores.cpu(), r.query_exited.cpu())
    for margin in (0.1, 0.0):
        assert torch.equal(outs[("cuda", margin)][0], outs[("cpu", margin)][0])
        assert torch.equal(outs[("cuda", margin)][1], outs[("cpu", margin)][1])


# -- the hybrid cascade on the card --------------------------------------------


def _hybrid_service(d, params, sentinels, mode, keep=0.35):
    import functools

    from repro_torch.core.lear import LearClassifier
    from repro_torch.core.stage import DenseStage
    from repro_torch.core.strategies import dense_keep_fraction
    from repro_torch.models.dense_scorer import dense_params_from_numpy
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    ens = random_ensemble(21, 200, 5, 24, device=d)
    clfs = [
        LearClassifier(random_ensemble(22 + i, 10, 4, 28, device=d), s)
        for i, s in enumerate(sentinels)
    ]
    dense = DenseStage(
        dense_params_from_numpy(params, d),
        functools.partial(dense_keep_fraction, keep_frac=keep),
    )
    return RankingService(
        ens, clfs[0],
        ServiceConfig(
            threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0, dense_stage=dense
        ),
        extra_classifiers=clfs[1:], device=d,
    )


def _dense_params(F=24, seed=3):
    from repro_torch.models.dense_scorer import init_dense_scorer

    return init_dense_scorer(torch.Generator().manual_seed(seed), F, device="cpu").to_numpy()


@pytest.mark.parametrize("sentinels,mode", [((20,), "fused"), ((20, 60), "fused"),
                                            ((20, 60), "staged")])
def test_hybrid_engine_on_the_card_equals_the_cpu(dev, sentinels, mode):
    """The boundary rule: dense scores within 1e-5; documents within that
    tolerance of their query's keep boundary excepted (the count is
    printed, none expected), every score within 1e-5 and the top-k equal."""
    from repro_torch.core.strategies import dense_keep_fraction
    from torch_parity import keep_boundary_docs

    params = _dense_params()
    card = _hybrid_service(dev, params, sentinels, mode)
    cpu = _hybrid_service(torch.device("cpu"), params, sentinels, mode)
    rng = np.random.default_rng(30)
    n_boundary = 0
    for _ in range(3):
        X = rng.normal(size=(8, 128, 24)).astype(np.float32)
        mask = np.arange(128)[None, :] < rng.integers(32, 129, size=8)[:, None]
        top, scores = card.rank_batch(X, mask)
        top_c, scores_c = cpu.rank_batch(X, mask)
        flat = torch.as_tensor(X.reshape(-1, 24))
        with torch.no_grad():
            d_cpu = cpu.dense_stage.scorer(flat).reshape(8, 128)
            d_card = card.dense_stage.scorer(flat.to(dev)).reshape(8, 128).cpu()
        np.testing.assert_allclose(d_card.numpy()[mask], d_cpu.numpy()[mask], rtol=1e-5, atol=1e-5)
        keep = dense_keep_fraction(d_cpu, torch.as_tensor(mask), 0.35).numpy()
        boundary = keep_boundary_docs(d_cpu.numpy(), keep, mask, 1e-5)
        n_boundary += int(boundary.sum())
        ok = mask & ~boundary
        np.testing.assert_allclose(scores[ok], scores_c[ok], rtol=1e-5, atol=1e-5)
        if not boundary.any():
            np.testing.assert_array_equal(top, top_c)
    print(f"[hybrid card vs cpu] {sentinels} {mode}: boundary documents {n_boundary}")
    assert card.stats.overflow_docs == cpu.stats.overflow_docs
    assert card.stats.trees_traversed == cpu.stats.trees_traversed or n_boundary


@pytest.mark.parametrize("cap", [64, 512, 1024])
@pytest.mark.parametrize("n_cont", [1, 37, "cap"])
def test_kernels_on_a_dense_compacted_block_with_padding_rows(dev, cap, n_cont):
    """Both kernels on a block as the hybrid gives it: ``cap`` rows of which
    the first ``n_cont`` are survivors and the rest padding that points at
    row 0 (``compact_indices_cumsum``), bit-exact with the plain versions."""
    from repro_torch.core.compaction import compact_indices_cumsum

    n_cont = cap if n_cont == "cap" else n_cont
    rng = np.random.default_rng(cap + n_cont)
    ens = random_ensemble(31, 120, 6, 40, device=dev)
    pf = ops.padded_forest(ens, boundaries=(20, 50, 120))
    x = _x(rng, 2048, 40, dev)
    keep = torch.zeros(2048, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(rng.choice(2048, n_cont, replace=False), device=dev)] = True
    sel, n = compact_indices_cumsum(keep, cap)
    assert int(n) == n_cont
    rows = x[sel]
    for lo, hi in ((0, 1), (1, 2), (2, 3)):
        got, want = _both(pf, rows, lo, hi)
        assert torch.equal(got, want), (lo, hi)
    seg_kw = dict(seg_block_starts=pf.seg_block_starts[:2],
                  n_tree_blocks=pf.seg_block_starts[1] + pf.seg_blocks[1], block_t=pf.block_t)
    got = fs.forest_score_segments_kernel(
        rows, *_tables(pf), leaf_gather=pf.leaf_gather, packed=pf.packed, **seg_kw
    )
    assert torch.equal(got, fs.forest_score_segments_plain(rows, *_tables(pf), **seg_kw))


def test_dense_scorer_row_count_invariance_probe(dev):
    """Records, without asserting it, whether the same 256 rows get
    bit-equal dense scores inside GEMMs of M = 256, 2048 and 8192 rows
    (cuBLAS may pick another kernel, with another K split, per M). Each
    must agree with the CPU within 1e-5."""
    from repro_torch.models.dense_scorer import dense_params_from_numpy

    params = _dense_params(F=136, seed=4)
    card = dense_params_from_numpy(params, dev)
    cpu = dense_params_from_numpy(params, "cpu")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8192, 136)).astype(np.float32)
    with torch.no_grad():
        want = cpu(torch.as_tensor(x[:256])).numpy()
        outs = {M: card(torch.as_tensor(x[:M], device=dev))[:256].cpu().numpy()
                for M in (256, 2048, 8192)}
    for M, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    diffs = {M: float(np.abs(outs[M] - outs[256]).max()) for M in outs}
    print(f"[row-count invariance] max |s(M) - s(256)| over 256 rows: {diffs}; "
          f"bit-equal: { {M: d == 0.0 for M, d in diffs.items()} }")


def test_hybrid_batched_equals_single_query_per_bucket_shape(dev):
    """The tier's batched ≡ single-query contract, per bucket shape: a query
    served in a full (Q, D) batch and alone in a (Q, D) block of padding
    queries scores its documents through GEMMs of the same M and must be
    bit-exact; alone at (1, D) (another M) it is printed, not asserted."""
    params = _dense_params()
    svc = _hybrid_service(dev, params, (20, 60), "fused")
    rng = np.random.default_rng(40)
    alone_equal = True
    for Qb, Db in ((2, 32), (4, 64), (8, 128)):
        X = rng.normal(size=(Qb, Db, 24)).astype(np.float32)
        mask = np.arange(Db)[None, :] < rng.integers(Db // 2, Db + 1, size=Qb)[:, None]
        for s in (svc.bucket_state(Qb, Db), svc.bucket_state(1, Db)):
            s.peaks = [Qb * Db] * svc.n_stages
        _, scores = svc.rank_batch(X, mask)
        for q in range(Qb):
            Xq = np.zeros_like(X)
            mq = np.zeros_like(mask)
            Xq[q], mq[q] = X[q], mask[q]
            _, sq = svc.rank_batch(Xq, mq)
            np.testing.assert_array_equal(sq[q][mask[q]], scores[q][mask[q]])
            _, s1 = svc.rank_batch(X[q:q + 1], mask[q:q + 1])
            alone_equal &= bool(np.array_equal(s1[0][mask[q]], scores[q][mask[q]]))
            np.testing.assert_allclose(s1[0][mask[q]], scores[q][mask[q]], rtol=1e-5, atol=1e-5)
    print(f"[hybrid batched vs alone at (1, D)] bit-equal: {alone_equal}")


def test_the_port_leaves_tf32_off(dev):
    """fp32 matmuls stay full fp32: the port never turns TF32 on (it would
    move dense scores by ~1e-3 and flip gate decisions)."""
    params = _dense_params()
    svc = _hybrid_service(dev, params, (20,), "fused")
    svc.rank_batch(np.zeros((2, 32, 24), np.float32), np.ones((2, 32), bool))
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


# --- The training pipeline on the card -----------------------------------------


def _train_trees(ens):
    return tuple(getattr(ens, k).cpu() for k in ("feature", "threshold", "leaf_value"))


def test_fit_tree_is_deterministic_on_the_card(dev):
    """The histogram and leaf sums are segment sums over rows sorted by
    destination, without atomics: two fits of one tree are bit-equal (at a
    width where float atomics would reorder the sums), the histogram equals
    the CPU's, and the tree meets the tie rule against the CPU's."""
    from repro_torch.forest import gbdt

    rng = np.random.default_rng(0)
    N, F = 40_000, 64
    Xb = torch.as_tensor(rng.integers(0, 256, size=(N, F)).astype(np.int32), device=dev)
    g = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.uniform(0.01, 1, size=N).astype(np.float32), device=dev)
    p = gbdt.GBDTParams(depth=6)
    first = gbdt._fit_tree(Xb, g, h, p)
    for _ in range(3):
        again = gbdt._fit_tree(Xb, g, h, p)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    # The card's scatter adds in the CPU's order: equal histograms. The
    # 256-bin cumulative sums scan in other orders on the two devices, so
    # the trees meet the tie rule (ROADMAP C4).
    idx = (torch.arange(F, device=dev) * 256)[None, :] + Xb.long()
    vals = torch.stack([g, h], 1)[:, None, :].expand(N, F, 2).reshape(-1, 2)
    hist = gbdt._scatter_sum(idx.reshape(-1), vals, F * 256)
    assert torch.equal(hist.cpu(), gbdt._scatter_sum(idx.reshape(-1).cpu(), vals.cpu(), F * 256))
    on_cpu = gbdt._fit_tree(Xb.cpu(), g.cpu(), h.cpu(), p)
    check_tree_tie_rule(
        Xb.cpu().numpy(), g.cpu().numpy(), h.cpu().numpy(),
        [a.cpu().numpy() for a in first[:3]], [a.numpy() for a in on_cpu[:3]], p,
    )


def test_lambdamart_and_lear_are_deterministic_on_the_card(dev):
    from repro_torch.core import lear
    from repro_torch.data import make_letor_dataset
    from repro_torch.forest import gbdt

    data = make_letor_dataset("msn1", n_queries=80, max_docs=128, seed=1).splits()
    tr, cl = data["train"], data["classifier"]
    p = gbdt.GBDTParams(n_trees=12, depth=6)
    rankers = [gbdt.train_lambdamart(tr.X, tr.labels, tr.mask, p, device=dev) for _ in range(2)]
    for a, b in zip(_train_trees(rankers[0]), _train_trees(rankers[1])):
        assert torch.equal(a, b)
    clfs = [lear.train_lear(cl.X, cl.labels, cl.mask, rankers[0], sentinel=5) for _ in range(2)]
    for a, b in zip(_train_trees(clfs[0].forest), _train_trees(clfs[1].forest)):
        assert torch.equal(a, b)
    assert clfs[0].forest.device == rankers[0].device


def test_segments_kernel_at_the_classifier_split_width(dev):
    """``train_lear``'s launch at lear-msn1 width: B = 51,200 rows (200
    queries × 256), 1,047 depth-6 trees, boundary (50,): equal to its plain
    version."""
    ens = random_ensemble(0, 1047, 6, 136, device=dev)
    pf = ops.padded_forest(ens, boundaries=(50, 1047))
    x = _x(np.random.default_rng(51), 51_200, 136, dev)
    kw = dict(seg_block_starts=pf.seg_block_starts, block_t=pf.block_t,
              n_tree_blocks=pf.seg_block_starts[1] + pf.seg_blocks[1])
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    got = fs.forest_score_segments_kernel(x, *tables, leaf_gather=pf.leaf_gather,
                                          packed=pf.packed, **kw)
    want = fs.forest_score_segments_plain(x, *tables, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0


def test_contributions_chunked_equal_unchunked_on_the_card(dev):
    from repro_torch.forest import reorder

    ens = random_ensemble(2, 300, 6, 136, device=dev)
    x = _x(np.random.default_rng(2), 1500, 136, dev)
    whole = reorder.per_tree_contributions(ens, x, chunk_rows=1500)
    for chunk in (1, 97, 512):
        assert torch.equal(reorder.per_tree_contributions(ens, x, chunk_rows=chunk), whole)
    assert torch.equal(whole.cpu(), reorder.per_tree_contributions(ens.to("cpu"), x.cpu()))


# ---------------------------------------------------------------------------
# The model cells on the card.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [{}, {"capacity_frac": 0.3},
                                   {"capacity_frac": 0.4, "sentinel2": 12}])
def test_forest_cell_kernel_route_equals_plain_route(dev, extra):
    """The forest cell's step through the kernel and through its plain
    version on the card: equal scores and verdicts; three (four) launches."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    cfg = dataclasses.replace(get_smoke_config("lear-msn1"), **extra)
    cell = make_cell(cfg, ShapeSpec("q", "serve", batch=40))
    params = cell.init_state(5, device=dev)
    inputs = as_tensors(synthesize_inputs(cell, seed=2), dev)
    fs.reset_kernel_launches()
    scores, cont = cell.step(params, inputs)
    torch.cuda.synchronize()
    assert fs.kernel_launches()["forest_score"] == (4 if "sentinel2" in extra else 3)

    def plain(x, feature, threshold, mask, leaf, *, leaf_gather, packed, **kw):
        return fs.forest_score_plain(x, feature, threshold, mask, leaf, **kw)

    with mock.patch.object(ops, "forest_score_kernel", plain):
        p_scores, p_cont = cell.step(params, inputs)
    assert torch.equal(scores, p_scores) and torch.equal(cont, p_cont)


def test_rowwise_sparse_update_on_the_card_equals_the_cpu(dev):
    from repro_torch.train import optimizer

    rows = optimizer.ROWWISE_MIN_ROWS
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.normal(size=(rows, 16)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, rows, size=500))
    vals = torch.as_tensor(rng.normal(size=(500, 16)).astype(np.float32))
    opt = optimizer.adagrad_rowwise(0.1)
    out = {}
    for d in ("cpu", dev):
        p = {"t": table.clone().to(d)}          # the update is in place
        g = torch.sparse_coo_tensor(idx[None].to(d), vals.to(d), (rows, 16),
                                    check_invariants=True)
        p, s = opt.update({"t": g}, opt.init(p), p)
        out[str(d)] = (p["t"].cpu(), s["acc"]["t"].cpu())
    (pc, ac), (pg, ag) = out.values()
    np.testing.assert_allclose(pg.numpy(), pc.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ag.numpy(), ac.numpy(), rtol=1e-6, atol=0)
    untouched = np.setdiff1d(np.arange(rows), idx.numpy())
    assert torch.equal(pg[untouched], table[untouched])


@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm", "din", "bert4rec"])
def test_recsys_train_step_on_the_card_equals_the_cpu(dev, arch):
    """One train step on the card against the CPU port: loss and global norm
    at 1e-5, every gradient at 1e-5, and the card's update on the CPU's
    gradients equal to the CPU's step in every entry of the parameters and
    the optimizer state at 1e-6 (a first Adam/Adagrad step on a near-zero
    gradient is a sign, so the update is held on identical gradients)."""
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import trainer
    from repro_torch.utils import tree_items, tree_map

    cell = make_cell(get_smoke_config(arch), ShapeSpec("t", "train", batch=64))
    raw = synthesize_inputs(cell, seed=1)
    own = trainer._grads

    def run(device, inject=None):
        """A fresh state (seed 0) stepped once on ``device``; the gradients
        it used, on the host."""
        state = tree_map(lambda _, v: v.to(device) if isinstance(v, torch.Tensor) else v,
                         cell.init_state(0, device="cpu"))
        seen = {}

        def grads(loss_fn, params, b):
            loss, g = own(loss_fn, params, b)
            if inject is not None:
                g = {k: inject[k].to(device) for k in g}
            seen.update({k: v.cpu() for k, v in g.items()})
            return loss, g

        with mock.patch.object(trainer, "_grads", grads):
            state, m = cell.step(state, as_tensors(raw, device))
        return dict(tree_items(state)), m, seen

    def dense(g):
        return (g.coalesce().to_dense() if g.is_sparse else g).numpy()

    cpu, m_cpu, g_cpu = run("cpu")
    _, m_card, g_card = run(dev)
    np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_card["grad_norm"]), float(m_cpu["grad_norm"]), rtol=1e-5)
    assert set(g_card) == set(g_cpu)
    for k in g_cpu:
        assert g_card[k].is_sparse == g_cpu[k].is_sparse, k
        np.testing.assert_allclose(dense(g_card[k]), dense(g_cpu[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    card, m_inj, _ = run(dev, inject=g_cpu)
    np.testing.assert_allclose(float(m_inj["grad_norm"]), float(m_cpu["grad_norm"]), rtol=1e-6)
    assert set(card) == set(cpu)
    for k, v in cpu.items():
        np.testing.assert_allclose(card[k].cpu().numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The LM serving path: the card against the CPU port, at smoke size.
# ---------------------------------------------------------------------------

LM_ARCHS = ["qwen2.5-14b", "minitron-4b", "qwen3-4b", "deepseek-moe-16b",
            "llama4-maverick-400b-a17b"]


def _lm_run(cfg, params, prompt, steps, device, calls, feed=None):
    """Prefill then ``steps`` decode steps on ``device``, fed ``feed`` (else
    its own greedy tokens); (logits per step, final caches, tokens fed)."""
    from lm_parity import record_port
    from repro_torch.models import transformer as tfm

    p = {k: v.to(device) for k, v in params.items()}
    B, S = prompt.shape
    feed, logits = list(feed or []), []
    with record_port(calls):
        lg, caches = tfm.prefill(cfg, p, prompt.to(device), S + steps)
        logits.append(lg.cpu())
        for i in range(steps):
            if len(feed) == i:
                feed.append(torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None])
            lg, caches = tfm.decode_step(cfg, p, feed[i].to(device), caches, S + i)
            logits.append(lg.cpu())
    return logits, {n: {k: t.cpu() for k, t in c.items()} for n, c in caches.items()}, feed


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_on_the_card_equal_the_cpu(dev, arch, monkeypatch):
    """bfloat16 smoke configs: the card within the tolerances of
    tests/lm_parity.py of the CPU port, the CPU fed the card's greedy
    tokens; sequences re-routed at a near tie set aside. bf16 GEMMs
    accumulate in float32 throughout, as the reference's and the CPU's do
    (``chip_smoke.py`` sets the same)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        False)
    from lm_parity import BF16_LOGIT_TOL, hold, hold_caches, set_aside
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config(arch)
    params = tfm.init(cfg, 0, device="cpu")
    B, S, steps = 4, 16, 6
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32)
    card_calls, cpu_calls = [], []
    card_lg, card_c, feed = _lm_run(cfg, params, prompt, steps, dev, card_calls)
    cpu_lg, cpu_c, _ = _lm_run(cfg, params, prompt, steps, "cpu", cpu_calls, feed)
    aside = set()
    for i in range(steps + 1):
        set_aside(card_calls, cpu_calls, B, aside, 0, (i + 1) * cfg.n_moe_layers)
        rows = [b for b in range(B) if b not in aside]
        hold(cpu_lg[i], card_lg[i], rows, "bfloat16", f"logits step {i}")
        for b in rows:
            want, got = int(card_lg[i][b].argmax()), int(cpu_lg[i][b].argmax())
            assert want == got or card_lg[i][b, want] - card_lg[i][b, got] <= BF16_LOGIT_TOL
    hold_caches(cpu_c, card_c, [b for b in range(B) if b not in aside], "bfloat16", "final")
    assert len(aside) < B


def test_lm_decode_writes_the_cache_in_place_on_the_card(dev):
    """decode_step returns the caches it was given, changed at ``pos`` only."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config("deepseek-moe-16b")
    params = tfm.init(cfg, 0, device=dev)
    caches = tfm.make_decode_caches(cfg, 2, 32, dev)
    for c in caches.values():
        for t in c.values():
            t.normal_(generator=torch.Generator(device=dev).manual_seed(1))
    before = {n: {k: t.clone() for k, t in c.items()} for n, c in caches.items()}
    ptrs = {(n, k): t.data_ptr() for n, c in caches.items() for k, t in c.items()}
    token = torch.tensor([[5], [7]], dtype=torch.int32, device=dev)
    logits, out = tfm.decode_step(cfg, params, token, caches, 9)
    assert torch.isfinite(logits).all()
    for n, c in out.items():
        for k, t in c.items():
            assert t is caches[n][k] and t.data_ptr() == ptrs[(n, k)]
            changed = (t != before[n][k]).flatten(3).any(-1).any(0).any(0)   # per position
            assert changed.nonzero().flatten().tolist() == [9], (n, k)


def test_lm_moe_prefill_rerun_is_bit_equal_on_the_card(dev):
    """Each token sums its experts in a fixed order (no float atomics), so
    the same MoE prefill twice gives the same bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm

    for arch in ("deepseek-moe-16b", "llama4-maverick-400b-a17b"):
        cfg = get_smoke_config(arch)
        params = tfm.init(cfg, 0, device=dev)
        tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 64)),
                                 dtype=torch.int32, device=dev)
        (la, ca), (lb, cb) = (tfm.prefill(cfg, params, tokens, 64) for _ in range(2))
        assert torch.equal(la, lb)
        assert all(torch.equal(ca[n][k], cb[n][k]) for n in ca for k in "kv")


# ---------------------------------------------------------------------------
# LM training and NequIP on the card.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_lm_train_step_on_the_card_equals_the_cpu(dev, arch):
    """One bfloat16 train step of the smoke config (2 microbatches) on the
    card against the CPU port from the same parameters and batch: loss and
    grad norm, every gradient within 1/16 of its leaf's max (the bfloat16
    tolerance of ``tests/test_torch_lm_train.py``), MoE routes differing
    only at near ties (the CPU replays the card's); then the card's step
    on the CPU's gradients against the CPU's step: every parameter within
    one bfloat16 unit, every optimizer entry within 1e-6 of its max."""
    from lm_parity import record_routes, replay_routes, rerouted
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.utils import tree_items

    cfg = get_smoke_config(arch)
    B, S = 4, 64
    cell = make_cell(cfg, ShapeSpec(name="t", kind="train", seq_len=S, global_batch=B, microbatch=2))
    opt = get_optimizer(cfg.optimizer)
    params = tfm.init(cfg, 0, device="cpu")
    rng = np.random.default_rng(8)
    raw = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    grads = {"card": {}, "cpu": {}}
    real = trainer._grads

    def recording(side):
        def fn(loss_fn, p, b):
            loss, g = real(loss_fn, p, b)
            for k, v in g.items():   # summed over the microbatches, as the step does
                grads[side][k] = grads[side].get(k, 0) + v.float().cpu()
            return loss, g
        return fn

    routes, own = [], []
    trainer._grads = recording("card")
    try:
        with record_routes(routes, passes=2):
            card_state, card_m = cell.step(
                trainer.init_state({k: v.to(dev) for k, v in params.items()}, opt),
                {k: torch.as_tensor(v, device=dev) for k, v in raw.items()})
        trainer._grads = recording("cpu")
        with replay_routes(routes, own, passes=2):
            cpu_state, cpu_m = cell.step(trainer.init_state(params, opt),
                                         {k: torch.as_tensor(v) for k, v in raw.items()})
    finally:
        trainer._grads = real
    for a, b in zip(routes, own, strict=True):
        assert not any(rerouted(a, b, B).values())
    assert abs(float(card_m["loss"]) - float(cpu_m["loss"])) <= 0.01
    assert abs(float(card_m["grad_norm"]) / float(cpu_m["grad_norm"]) - 1) <= 1 / 16
    for k, g in grads["cpu"].items():
        assert (grads["card"][k] - g).abs().max() <= g.abs().max() / 16, k

    def on_cpu_grads(loss_fn, p, b):
        loss, _ = real(loss_fn, p, b)
        return loss, {k: (grads["cpu"][k] / 2).to(v.dtype).to(dev) for k, v in p.items()}

    trainer._grads = on_cpu_grads
    try:
        inj_state, _ = cell.step(
            trainer.init_state({k: v.to(dev) for k, v in params.items()}, opt),
            {k: torch.as_tensor(v, device=dev) for k, v in raw.items()})
    finally:
        trainer._grads = real
    # Same CPU gradients on the CPU, through the same step.
    trainer._grads = lambda loss_fn, p, b: (real(loss_fn, p, b)[0], {
        k: (grads["cpu"][k] / 2).to(v.dtype) for k, v in p.items()})
    try:
        want_state, _ = cell.step(trainer.init_state(params, opt),
                                  {k: torch.as_tensor(v) for k, v in raw.items()})
    finally:
        trainer._grads = real
    got = dict(tree_items(inj_state))
    for k, w in tree_items(want_state):
        g = got[k].cpu()
        if k.startswith("params/"):
            ulp = torch.exp2(torch.floor(torch.log2(w.float().abs().clamp_min(2.0 ** -126))) - 7)
            assert ((g.float() - w.float()).abs() <= ulp).all(), k
        else:
            scale = float(w.double().abs().max()) or 1.0
            assert float((g.double() - w.double()).abs().max()) <= 1e-6 * scale, k
    assert torch.isfinite(card_state.params["lm_head"]).all()


def test_nequip_molecule_step_on_the_card_equals_the_cpu(dev):
    """The smoke NequIP on a batch of molecules with ghost padding
    (``tests/nequip_parity.py``): energies, forces, loss and every
    gradient on the card within 1e-4 of the CPU port's (relative to each
    tensor's max), finite, and a rerun on the card bit-equal (the segment
    sums add in sorted order, no float atomics)."""
    import functools

    from nequip_parity import molecule_batch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import nequip
    from repro_torch.train import trainer

    cfg = get_smoke_config("nequip")
    raw = molecule_batch(8, 30, 64, 512, 1024, cfg.n_species, seed=9)
    params = nequip.init(cfg, 0, device="cpu")

    def terms(device):
        p = {k: v.to(device) for k, v in params.items()}
        b = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
        e = nequip.forward_energy(cfg, p, b["positions"], b["species"], b["edge_src"],
                                  b["edge_dst"], b["graph_id"], 8)
        f = nequip.forces(cfg, p, b)
        loss, g = trainer._grads(functools.partial(nequip.loss_fn, cfg, with_forces=True), p, b)
        return {"energy": e.detach(), "forces": f, "loss": loss, **g}

    card, again, cpu = terms(dev), terms(dev), terms("cpu")
    for k, want in cpu.items():
        got = card[k].cpu()
        assert torch.isfinite(got).all(), k
        assert (got - want).abs().max() <= 1e-4 * want.abs().max().clamp_min(1e-30), k
        assert torch.equal(card[k], again[k]), k


def test_bf16_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A bfloat16 train state on the card saves through the port's
    checkpoint (the reference's ``<V2`` bytes) and restores into a card
    template bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint, trainer
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.utils import tree_items, tree_map

    cfg = get_smoke_config("qwen3-4b")
    state = trainer.init_state(tfm.init(cfg, 3, device=dev), get_optimizer("adamw"))
    checkpoint.save_checkpoint(str(tmp_path), 7, state, extra={"step": 7})
    template = tree_map(lambda _, t: torch.zeros_like(t), state)
    restored, extra = checkpoint.restore_checkpoint(str(tmp_path), template)
    assert extra == {"step": 7}
    want = dict(tree_items(state))
    for k, t in tree_items(restored):
        assert t.device.type == "cuda" and t.dtype == want[k].dtype, k
        assert torch.equal(t, want[k]), k
    assert want["params/embed"].dtype == torch.bfloat16


def test_bf16_embedding_gradient_on_the_card_against_the_cpu(dev):
    """ROADMAP C11: ``F.embedding``'s backward on the card sums a repeated
    token's bfloat16 rows in its own order and precision (neither the
    CPU's one rounding per add, which is the reference's, nor one float32
    sum rounded once); held to the CPU's within the bfloat16 gradient
    tolerance of ``tests/test_torch_lm_train.py`` (1/16 of the max), the
    gap printed."""
    from lm_parity import bf16_sums, embedding_case, embedding_grad

    table, tokens, up = embedding_case()
    got = embedding_grad(table, tokens, up, dev)
    seq, once = bf16_sums(tokens, up, table.shape[0])
    assert torch.equal(embedding_grad(table, tokens, up, "cpu"), seq)
    scale = float(seq.float().abs().max())
    gap = float((got.float() - seq.float()).abs().max()) / scale
    gap_once = float((got.float() - once.float()).abs().max()) / scale
    print(f"bfloat16 embedding gradient, card against the CPU's adds: {gap:.4g} of the max; "
          f"against one float32 sum: {gap_once:.4g}")
    assert gap <= 1 / 16


# ---------------------------------------------------------------------------
# The host-read guard and the shape-checked lane on the card.
# ---------------------------------------------------------------------------

SYNCING = {
    "item": lambda x, m: x.sum().item(),
    "bool_mask_index": lambda x, m: x[m],
    "nonzero": lambda x, m: torch.nonzero(m),
    "repeat_interleave": lambda x, m: torch.repeat_interleave(m.long()),
    "cpu": lambda x, m: x.cpu(),
    "blocking_h2d": lambda x, m: torch.as_tensor(np.ones(4, np.float32), device=x.device),
}


@pytest.mark.parametrize("name", sorted(SYNCING))
def test_guard_negative_controls_on_the_card(dev, name):
    from repro_torch.utils import count_host_transfers

    x = torch.randn(1000, device=dev)
    m = x > 0
    SYNCING[name](x, m)  # warm
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with count_host_transfers() as counts:
        SYNCING[name](x, m)
    assert counts.implicit_syncs >= 1 and counts.sync_warnings >= 1, counts
    assert counts.explicit_gets == 0
    assert torch.cuda.get_sync_debug_mode() == before


def test_guard_sees_device_get_and_async_copies_on_the_card(dev):
    from repro_torch.serve.placement import single_device
    from repro_torch.utils import count_host_transfers, device_get

    x = torch.randn(1000, device=dev)
    X = np.ones((2, 8, 4), np.float32)
    mask = np.ones((2, 8), bool)
    single_device().put(X, mask, x.device)
    with count_host_transfers() as counts:
        host = device_get(x * 2)
        Xd, md = single_device().put(X, mask, x.device)  # pinned, asynchronous
        torch.sort(x, descending=True, stable=True)
        torch.repeat_interleave(torch.ones(4, dtype=torch.long, device=dev), output_size=4)
    assert isinstance(host, np.ndarray)
    assert (counts.explicit_gets, counts.implicit_syncs) == (1, 0), counts
    assert counts.sync_warnings >= 1  # the read itself: a blocking copy
    torch.cuda.synchronize()
    assert Xd.device == x.device and bool(md.all()) and float(Xd.sum()) == X.sum()


@pytest.mark.parametrize("sentinels,mode,qe", [
    ((20,), "auto", False), ((20, 60), "fused", False), ((20, 60), "staged", True),
])
def test_rank_batch_reads_once_under_the_sync_debug_mode(dev, sentinels, mode, qe):
    from repro_torch.core.lear import LearClassifier
    from repro_torch.core.strategies import QueryExitConfig
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig
    from repro_torch.utils import count_host_transfers

    def service(d):
        ens = random_ensemble(31, 200, 5, 24, device=d)
        clfs = [LearClassifier(random_ensemble(32 + i, 10, 4, 28, device=d), s)
                for i, s in enumerate(sentinels)]
        return RankingService(
            ens, clfs[0],
            ServiceConfig(threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0,
                          query_exit=QueryExitConfig(k=5, margin=1.0) if qe else None),
            extra_classifiers=clfs[1:], device=d,
        )

    svc, cpu = service(dev), service("cpu")
    rng = np.random.default_rng(12)
    batches = [(rng.normal(size=(4, 64, 24)).astype(np.float32),
                np.arange(64)[None] < rng.integers(16, 65, size=(4, 1))) for _ in range(5)]
    for X, mask in batches[:2]:
        svc.rank_batch(X, mask)
        cpu.rank_batch(X, mask)
    fs.reset_kernel_launches()
    with count_host_transfers() as counts:
        outs = [svc.rank_batch(X, mask) for X, mask in batches[2:]]
    assert (counts.explicit_gets, counts.implicit_syncs) == (3, 0), counts
    assert sum(fs.kernel_launches().values()) > 0
    for (X, mask), (top, scores) in zip(batches[2:], outs):
        _, want = cpu.rank_batch(X, mask)
        np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-5)


def test_shape_checked_wrappers_on_card_tensors(dev):
    from repro_torch.typecheck import shape_checked

    ens = random_ensemble(41, 64, 5, 19, device=dev)
    pf = ops.padded_forest(ens, boundaries=(16, 64))
    x = _x(np.random.default_rng(41), 300, 19, dev)
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    plain = shape_checked(fs.forest_score_kernel)
    seg = shape_checked(fs.forest_score_segments_kernel)
    kw = dict(block_t=pf.block_t, packed=pf.packed)
    assert torch.equal(plain(x, *tables, **kw), fs.forest_score_kernel(x, *tables, **kw))
    skw = dict(seg_block_starts=pf.seg_block_starts, n_tree_blocks=sum(pf.seg_blocks), **kw)
    got = seg(x, *tables, **skw)
    assert got.shape == (300, 2) and torch.equal(got, fs.forest_score_segments_kernel(x, *tables, **skw))
    with pytest.raises(TypeError, match="feature"):
        plain(x, pf.feature.float(), *tables[1:], **kw)
    with pytest.raises(TypeError, match="`x`"):
        plain(x[0], *tables, **kw)
    with pytest.raises(TypeError, match="threshold"):
        plain(x, pf.feature, pf.threshold[:, :4].contiguous(), *tables[2:], **kw)


# ---------------------------------------------------------------------------
# Several cards: placement, the local NCCL mesh and the roofline's compute term.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,gate", [("fused", None), ("staged", None), ("staged", -3.0)])
def test_data_parallel_on_one_card_is_bit_equal(dev, mode, gate):
    """Two shards on cuda:0 against the one-shard batch: scores, top-k and
    stats equal in every batch, the cold first one included; every shard
    makes the batch's launches; one host read a batch and no implicit sync
    once warm. ``gate=-3.0`` keeps nearly every document, which overflows
    the first batch's cold-start capacities (half the batch)."""
    from repro_torch.core.lear import LearClassifier
    from repro_torch.serve.placement import data_parallel
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig
    from repro_torch.utils import count_host_transfers

    def service():
        ens = random_ensemble(51, 200, 5, 24, device=dev)
        clfs = [LearClassifier(random_ensemble(52 + i, 10, 4, 28, device=dev), s)
                for i, s in enumerate((20, 60))]
        svc = RankingService(
            ens, clfs[0], ServiceConfig(threshold=0.4, execution_mode=mode,
                                        launch_overhead_trees=512.0),
            extra_classifiers=clfs[1:], device=dev,
        )
        if gate is not None:
            svc.stage_strategies = [lambda p, m, features=None: m & (features[..., 0] > gate)] * 2
        return svc

    single, split = service(), service()
    pl = data_parallel(devices=[dev] * 2)
    rng = np.random.default_rng(53)
    batches = [(rng.normal(size=(8, 64, 24)).astype(np.float32),
                np.arange(64)[None] < rng.integers(16, 65, size=(8, 1))) for _ in range(4)]
    outs = [single.rank_batch(X, mask) for X, mask in batches[:2]]
    got = [split.rank_batch(X, mask, placement=pl) for X, mask in batches[:2]]
    fs.reset_kernel_launches()
    outs += [single.rank_batch(X, mask) for X, mask in batches[2:]]
    one = dict(fs.kernel_launches())
    fs.reset_kernel_launches()
    with count_host_transfers() as counts:
        got += [split.rank_batch(X, mask, placement=pl) for X, mask in batches[2:]]
    assert (counts.explicit_gets, counts.implicit_syncs) == (2, 0), counts
    assert dict(fs.kernel_launches()) == {k: 2 * n for k, n in one.items()} and sum(one.values())
    for (t_s, s_s), (t_p, s_p) in zip(outs, got):
        np.testing.assert_array_equal(s_p, s_s)
        np.testing.assert_array_equal(t_p, t_s)
    assert split.stats.overflow_docs == single.stats.overflow_docs
    assert split.stats.docs_continued == single.stats.docs_continued
    if gate is not None:
        assert single.stats.overflow_docs > 0


def test_local_nccl_mesh_remesh_and_all_reduce(dev):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import remesh

    mesh = make_local_mesh(dev)
    assert mesh.device_type == "cuda" and mesh.shape == (1, 1)
    tree = {"w": torch.randn(64, 32).to(torch.bfloat16), "b": np.arange(32, dtype=np.float32)}
    out = remesh(tree, {"w": ("embed", "ff"), "b": (None,)}, single_pod_rules(), mesh)
    assert tuple(out["w"].placements) == (Shard(0), Shard(1))
    assert tuple(out["b"].placements) == (Replicate(), Replicate())
    assert out["w"].to_local().device.type == "cuda"
    assert torch.equal(out["w"].full_tensor().cpu(), tree["w"])
    assert torch.equal(out["b"].full_tensor().cpu(), torch.as_tensor(tree["b"]))
    t = torch.arange(8, dtype=torch.float32, device=dev)
    dist.all_reduce(t, group=mesh.get_group("data"))   # one rank: NCCL, the sum is itself
    torch.cuda.synchronize()
    assert torch.equal(t.cpu(), torch.arange(8, dtype=torch.float32))
    assert dist.get_backend(mesh.get_group("data")) in ("nccl", "cpu:gloo,cuda:nccl")


def test_roofline_compute_term_is_below_a_timed_gemm(dev):
    from repro_torch.launch import op_analysis, roofline
    from repro_torch.utils import device_ms

    n = 8192
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    tr, _ = op_analysis.trace(torch.mm, a.to("meta"), b.to("meta"))
    r = roofline.roofline(op_analysis.analyze(tr), chips=1)
    assert r.flops_by_dtype == {"bfloat16": 2 * n**3}
    ms = device_ms(lambda: torch.mm(a, b), reps=20)
    print(f"bf16 GEMM {n}^3: {ms:.4f} ms against a compute term of {r.compute_s * 1e3:.4f} ms "
          f"({r.compute_s * 1e3 / ms:.1%} of peak)")
    assert ms / 1e3 >= r.compute_s


# ---------------------------------------------------------------------------
# The train step on the (1, 1) mesh, the sparse-row reduction and the
# whole-batch masked count (chip_smoke.py's [parallel_train] at smoke size).
# ---------------------------------------------------------------------------

_PT_SHAPES = {
    "recsys": dict(kind="train", batch=64, microbatch=16),
    "nequip": dict(kind="train", n_nodes=10, n_edges=20, graph_batch=8),
    "lm": dict(kind="train", seq_len=64, global_batch=4, microbatch=2),
}


def _pt_cell(arch: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec, TransformerConfig
    from repro_torch.models.api import make_cell

    cfg = get_smoke_config(arch)
    kind = ("lm" if isinstance(cfg, TransformerConfig) else "nequip" if arch == "nequip"
            else "recsys")
    return make_cell(cfg, ShapeSpec(name="t", **_PT_SHAPES[kind])), kind == "lm"


@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm", "din", "bert4rec", "nequip",
                                  "qwen3-4b", "deepseek-moe-16b"])
def test_train_steps_on_the_local_mesh_equal_the_steps_without_rules(dev, arch):
    """Two steps under single_pod_rules on make_local_mesh(cuda) (an LM's
    state placed as DTensors by remesh) bit-equal to two without rules."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding_rules, single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh
    from repro_torch.utils import tree_items

    cell, lm = _pt_cell(arch)
    batch = as_tensors(synthesize_inputs(cell, seed=4), dev)
    mesh, rules = make_local_mesh(dev), single_pod_rules()

    def run(state, ruled):
        seen = []
        for _ in range(2):
            if ruled:
                with sharding_rules(rules, mesh):
                    state, m = cell.step(state, batch)
            else:
                state, m = cell.step(state, batch)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        return state, seen

    want, plain = run(cell.init_state(0, dev), False)
    state = cell.init_state(0, dev)
    if lm:
        state = remesh(state, cell.state_logical(), rules, mesh)
    got, ruled = run(state, True)
    assert ruled == plain
    want = dict(tree_items(want))
    for k, t in tree_items(got):
        if lm:
            assert isinstance(t, DTensor), k
            t = t.to_local()
        assert torch.equal(t, want[k]), k


@pytest.mark.parametrize("n", [2, 8])
def test_sparse_row_reduction_on_the_card(dev, n):
    """DLRM-RM2 smoke (tables as row-wise tables): ``n`` shares' coalesced
    gradients reduced by reduce_sparse_rows within 1e-6 of the whole
    batch's, and bit-equal across two runs."""
    import functools

    from repro_torch.models import recsys
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import trainer

    cell, _ = _pt_cell("dlrm-rm2")
    params = cell.init_state(0, dev).params
    batch = as_tensors(synthesize_inputs(cell, seed=5), dev)
    loss_fn = functools.partial(recsys.loss_fn, cell.cfg, sparse_grad=True)

    def grads(b):
        return {k: g.coalesce() for k, g in trainer._grads(loss_fn, params, b)[1].items()
                if g.is_sparse}

    whole = grads(batch)
    assert whole
    B = batch["label"].shape[0]
    runs = [
        {k: trainer.reduce_sparse_rows(
            [p[k] for p in [grads({kk: v[r * B // n:(r + 1) * B // n] for kk, v in batch.items()})
                            for r in range(n)]], n) for k in whole}
        for _ in range(2)
    ]
    for k, want in whole.items():
        got = runs[0][k]
        assert torch.equal(got.indices(), want.indices()), k
        scale = float(want.values().abs().max())
        assert float((got.values() - want.values()).abs().max()) <= 1e-6 * scale, k
        assert torch.equal(got.values(), runs[1][k].values()), k


def test_bert4rec_split_count_on_the_card(dev):
    """An uneven mask in two shares: each share divides by the whole
    batch's count and is weighted by 2; their mean is the one-process loss
    within 1e-6."""
    from repro_torch.models import recsys
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    cell, _ = _pt_cell("bert4rec")
    params = cell.init_state(0, dev).params
    raw = synthesize_inputs(cell, seed=6)
    B, S = raw["mask_pos"].shape
    raw["mask_pos"][:] = 0.0
    raw["mask_pos"][: B // 2] = 1.0
    raw["mask_pos"][B // 2:, S // 2] = 1.0
    batch = as_tensors(raw, dev)
    total = batch["mask_pos"].sum()
    own = recsys.batch_total
    with torch.no_grad():
        whole = float(recsys.bert4rec_masked_loss(cell.cfg, params, batch))
        try:
            recsys.batch_total = lambda x: (total, 2)
            split = [float(recsys.bert4rec_masked_loss(
                cell.cfg, params, {k: v[r * B // 2:(r + 1) * B // 2] for k, v in batch.items()}))
                for r in range(2)]
        finally:
            recsys.batch_total = own
    assert abs(sum(split) / 2 - whole) <= 1e-6 * abs(whole)
