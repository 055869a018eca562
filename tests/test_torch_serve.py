"""Port parity: ``RankingService.rank_batch`` end to end against the reference.

The same ranker and LEAR classifiers (random, converted through numpy) serve
the same ragged batches in both packages, in two padded batch shapes, with
a numeric ``launch_overhead_trees``. Responses (top-k indices, scores),
stats and the per-bucket adaptive state (survivor peaks → capacities, EMA)
must be equal. In ``auto`` the port picks the mode on the host with the
reference's own host pick (``_pick_mode``), which the reference's device
pick is held to (``tests/test_mode_pick.py``); the picks must agree batch
by batch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lear as ref_lear  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.core.stage import DenseStage  # noqa: E402
from repro_torch.core.strategies import QueryExitConfig  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.utils import count_host_transfers  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

F = 16
SHAPES = ((2, 64), (4, 32), (2, 64), (4, 32), (2, 64))


def _services(sentinels, mode, loh, threshold=0.5):
    ens = ref_ensemble.random_ensemble(0, n_trees=64, depth=4, n_features=F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4), s
        )
        for i, s in enumerate(sentinels)
    ]
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=threshold, execution_mode=mode, launch_overhead_trees=loh
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(threshold=threshold, execution_mode=mode, launch_overhead_trees=loh),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    return ref, port


def _batch(rng, Q, D):
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(1, D + 1, size=(Q, 1))
    return X, mask


@pytest.mark.parametrize("sentinels,mode,loh", [
    ((8,), "auto", 0.0),
    ((8, 28), "fused", 0.0),
    ((8, 28), "staged", 0.0),
    ((8, 28), "auto", 0.0),
    ((8, 28), "auto", 1e9),
    ((5, 19, 33), "auto", 64.0),
])
def test_rank_batch_matches_reference(sentinels, mode, loh):
    ref, port = _services(sentinels, mode, loh)
    rng = np.random.default_rng(len(sentinels) + int(loh))
    for Q, D in SHAPES:
        X, mask = _batch(rng, Q, D)
        staged_before = ref.stats.batches_staged
        port._active_key = (Q, D)    # the pick rank_batch is about to make
        picked = port._pick_mode(Q * D, port._pick_capacities(Q * D))
        top, scores = port.rank_batch(X, mask)
        want_top, want_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_array_equal(top, np.asarray(want_top))
        np.testing.assert_array_equal(scores, np.asarray(want_scores))
        # The batch ran the mode the reference's device pick chose.
        assert port.stats.batches_staged == ref.stats.batches_staged
        assert (picked == "staged") == (ref.stats.batches_staged > staged_before)
        assert port._pick_mode(Q * D) == ref._pick_mode(Q * D)
    for field in ("batches", "queries", "docs", "docs_continued", "overflow_docs",
                  "trees_traversed", "trees_full_equiv", "batches_fused", "batches_staged"):
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    assert port.stats.continue_rate == ref.stats.continue_rate
    for Q, D in set(SHAPES):
        p, r = port.bucket_state(Q, D), ref.bucket_state(Q, D)
        assert (p.peaks, p.ema) == (r.peaks, r.ema)
        port._active_key = ref._active_key = (Q, D)
        assert port._pick_capacities(Q * D) == ref._pick_capacities(Q * D)
    if mode == "auto" and loh == 0.0 and len(sentinels) > 1:
        assert 0 < port.stats.batches_staged < port.stats.batches


def test_capacity_ratchet_and_overflow_match_reference():
    """A low threshold keeps most documents: the cold-start capacity
    overflows on the first batch and ratchets up, in both packages."""
    ref, port = _services((8, 28), "staged", 0.0, threshold=0.05)
    rng = np.random.default_rng(11)
    for _ in range(3):
        X, mask = _batch(rng, 2, 64)
        mask[:] = True
        port.rank_batch(X, mask)
        ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
    assert port.stats.overflow_docs == ref.stats.overflow_docs > 0
    assert port._pick_capacities(128) == ref._pick_capacities(128)


def test_rank_batch_reads_the_device_once():
    """Between submit and the response the hot path makes no host read
    but the one packed copy, through ``device_get`` (no .item(), bool(),
    int(), float(), .cpu() or numpy read of a tensor besides it)."""
    _, port = _services((8, 28), "fused", 0.0)
    rng = np.random.default_rng(5)
    port.rank_batch(*_batch(rng, 2, 64))
    batch = _batch(rng, 2, 64)
    with count_host_transfers() as counts:
        port.rank_batch(*batch)
    assert (counts.explicit_gets, counts.implicit_syncs) == (1, 0), counts


def test_service_raises_on_unported_options():
    # Query exit and the dense stage are ported (tests/test_torch_query_exit.py,
    # tests/test_torch_hybrid.py); what is not a DenseStage is refused.
    assert ServiceConfig(query_exit=QueryExitConfig()).query_exit == QueryExitConfig()
    dense = DenseStage(scorer=lambda x: x[:, 0], policy=lambda s, m: m)
    assert ServiceConfig(dense_stage=dense).dense_stage is dense
    with pytest.raises(ValueError, match="DenseStage"):
        ServiceConfig(dense_stage=lambda x: x[:, 0])
    with pytest.raises(ValueError):
        ServiceConfig(execution_mode="eager")
