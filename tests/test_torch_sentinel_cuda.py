"""The sentinel-features kernel against the plain path, on the card.

Needs an NVIDIA card with sm_90a and nvcc; elsewhere each test skips (the
decision is taken inside the fixture). Run with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sentinel_cuda.py

Every output must equal :func:`augment_features_plain` on the same card bit
for bit (compared as int32 words, so a sign of zero counts too), and its
ranks those of both plain compares.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import features  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sentinel_features as sf  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(Q, D, F, seed, dev, quantum=0.25):
    """Features N(0, 1); partials rounded to ``quantum`` so that ties are
    common; real slots a random prefix with random holes. Query 0 is all
    masked, query 1 all real, and query 2's first document is real with a
    partial of exactly NEG."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    partial = (np.round(rng.normal(size=(Q, D)) / quantum) * quantum).astype(np.float32)
    n_real = rng.integers(0, D + 1, size=(Q, 1))
    mask = (np.arange(D)[None, :] < n_real) & (rng.random(size=(Q, D)) < 0.9)
    mask[0] = False
    if Q > 1:
        mask[1] = True
    if Q > 2:
        mask[2, 0] = True
        partial[2, 0] = features.NEG
    return (torch.as_tensor(X, device=dev), torch.as_tensor(partial, device=dev),
            torch.as_tensor(mask, device=dev))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _hold(X, partial, mask):
    """The kernel equals the plain path bit for bit; its ranks equal both
    plain compares' on the real documents."""
    F = X.shape[-1]
    build.reset_kernel_launches()
    got = sf.sentinel_features_kernel(X, partial, mask)
    want = features.augment_features_plain(X, partial, mask)
    torch.cuda.synchronize()
    assert build.kernel_launches() == {"forest_score": 0, "forest_score_segments": 0,
                                       "sentinel_features": 1}
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), (got - want).abs().max()
    direct = features.query_ranks_direct(partial, mask)
    assert torch.equal(direct, features.query_ranks_blocked(partial, mask))
    ranks = torch.where(mask, direct.float(), torch.zeros_like(direct, dtype=torch.float32))
    assert torch.equal(got[..., F + 1], ranks)


@pytest.mark.parametrize("F", [0, 7, 136, 220])
@pytest.mark.parametrize("D", [1, 31, 64, 128, 255, 256, 257, 512, 1000])
def test_kernel_equals_plain(dev, D, F):
    _hold(*_inputs(67, D, F, seed=D * 1000 + F, dev=dev))


@pytest.mark.parametrize("Q,D", [(600, 1), (700, 2), (1030, 5), (300, 100), (4, 2100), (3, 4500)])
def test_kernel_equals_plain_past_one_group_or_chunk(dev, Q, D):
    """Many queries to a CTA (full groups and a ragged last one), and lists
    longer than the kernel's staged chunk of scores and of counts."""
    _hold(*_inputs(Q, D, 12, seed=Q + D, dev=dev))


@pytest.mark.parametrize("F", [136, 220])
def test_unaligned_features_take_the_scalar_copy(dev, F):
    """X at a 4-byte offset from 16-byte alignment: the same bits."""
    X, partial, mask = _inputs(9, 256, F, seed=F, dev=dev)
    buf = torch.empty(X.numel() + 1, device=dev)
    shifted = buf[1:].view(X.shape)
    shifted.copy_(X)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    _hold(shifted, partial, mask)


@pytest.mark.parametrize("quantum", [1.0, 1e-3])
def test_ties_and_distinct_scores_at_the_cells_shapes(dev, quantum):
    """The msn1 and istella shapes (Q 4,096 cut to 512): every other score
    tied, and nearly none."""
    for D, F in ((256, 136), (512, 220)):
        _hold(*_inputs(512, D, F, seed=D, dev=dev, quantum=quantum))


def test_augment_features_launches_the_kernel_and_marks_its_span(dev):
    """augment_features on a CUDA tensor is one launch, a strided partial
    made contiguous; it tags no span (the service opens ``engine.features``
    with its ``method``)."""
    from repro_torch import tracing

    X, partial, mask = _inputs(5, 40, 8, seed=3, dev=dev)
    cols = torch.randn(5, 40, 2, device=dev)
    part_view = cols[..., 0]                  # a strided partial is made contiguous
    part_view.copy_(partial)
    build.reset_kernel_launches()
    with tracing.recording():
        with tracing.span("engine.features", stage=0):
            got = features.augment_features(X, part_view, mask)
    torch.cuda.synchronize()
    assert build.kernel_launches() == {"forest_score": 0, "forest_score_segments": 0,
                                       "sentinel_features": 1}
    assert torch.equal(_bits(got), _bits(features.augment_features_plain(X, partial, mask)))
    (rec,) = [r for r in tracing.drain().records if r.name == "engine.features"]
    assert rec.attrs == {"stage": 0}


def _service(dev, sentinels, mode, F, T, depth):
    from repro_torch.core.lear import LearClassifier
    from repro_torch.forest.ensemble import random_ensemble
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    clfs = [LearClassifier(random_ensemble(10 + i, 6, 3, F + 4, device=dev), s)
            for i, s in enumerate(sentinels)]
    return RankingService(
        random_ensemble(0, T, depth, F, device=dev), clfs[0],
        ServiceConfig(threshold=0.5, execution_mode=mode, launch_overhead_trees=0.0),
        extra_classifiers=clfs[1:], device=dev,
    )


def _serve_recorded(dev, sentinels, mode, X, mask, T, depth):
    """One request on a fresh service, recording → (answers, records,
    service); then the same request with the plain features on the same
    card, whose answers must be the same bit for bit."""
    from repro_torch import tracing

    F = X.shape[-1]
    svc = _service(dev, sentinels, mode, F, T, depth)
    build.reset_kernel_launches()
    with tracing.recording():
        top, scores = svc.rank_batch(X, mask)
    records = tracing.drain().records
    assert build.kernel_launches()["sentinel_features"] == len(sentinels)

    def plain(X, partial, mask):
        return features.augment_features_plain(X, partial, mask)

    with mock.patch.object(features, "sentinel_features_kernel", plain):
        p_top, p_scores = _service(dev, sentinels, mode, F, T, depth).rank_batch(X, mask)
    np.testing.assert_array_equal(top, p_top)
    assert scores.tobytes() == p_scores.tobytes()
    return records, svc


@pytest.mark.parametrize("sentinels,mode", [((8,), "fused"), ((8, 28), "staged")])
@pytest.mark.parametrize("D", [32, 512])
def test_service_answers_unchanged_by_the_kernel(dev, sentinels, mode, D):
    """A small RankingService on the card: the same answers with the kernel
    as with the plain path on the same card, one launch per stage and
    request, the span marked fused, no engine.ranks span, D² pairs a query."""
    F, Q = 6, 4
    rng = np.random.default_rng(D)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(4, D + 1, size=(Q, 1))
    records, svc = _serve_recorded(dev, sentinels, mode, X, mask, T=40, depth=4)
    assert svc.stats.rank_pairs == len(sentinels) * Q * D * D
    assert [r.attrs for r in records if r.name == "engine.features"] == [
        {"stage": s, "method": "fused"} for s in range(len(sentinels))
    ]
    assert not [r for r in records if r.name == "engine.ranks"]


@pytest.mark.parametrize("sentinels,mode", [((8,), "fused"), ((8, 20), "staged")],
                         ids=["one", "two"])
def test_istella_width_on_the_card(dev, sentinels, mode):
    """istella-bulk's width on the card (512 slots, F = 220, depth-6 trees),
    recording: each stage's features one fused launch with no
    ``engine.ranks`` span, and each forest launch's plan on its span with a
    document tile below 256 rows; the answers those of the plain features."""
    F, D, Q = 220, 512, 12
    rng = np.random.default_rng(220)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(D // 4, D + 1, size=(Q, 1))
    records, svc = _serve_recorded(dev, sentinels, mode, X, mask, T=40, depth=6)
    assert 0 < svc.stats.docs_continued < int(mask.sum())     # some exit, some go on
    assert svc.stats.rank_pairs == len(sentinels) * Q * D * D
    assert [r.attrs for r in records if r.name == "engine.features"] == [
        {"stage": s, "method": "fused"} for s in range(len(sentinels))
    ]
    assert not [r for r in records if r.name == "engine.ranks"]
    launches = [r for r in records if r.name in (
        "engine.head", "engine.middle", "engine.tail", "engine.classifier")]
    assert {r.name for r in launches} >= {"engine.head", "engine.tail", "engine.classifier"}
    for r in launches:
        assert 0 < r.attrs["tile_rows"] < 256, (r.name, r.attrs)
        assert r.attrs["tree_warps"] >= 1 and r.attrs["ctas_per_sm"] >= 1, (r.name, r.attrs)
