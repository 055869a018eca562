"""Port parity: serving placements — ``local`` and ``data_parallel``.

- ``local()`` (the (1, 1) mesh with the production rules) is bit-equal to
  ``single_device()``: the counterpart of
  ``tests/test_serving_tier.py::test_single_device_placement_is_identity_and_local_mesh_bitexact``;
- ``data_parallel(devices=[cpu] * 8)`` splits the query axis into one
  shard per device and is bit-equal to ``single_device()`` (scores, top-k,
  stats), and within rtol/atol 1e-6 of the reference's single-device
  ``rank_batch``. The reference's own 8-device program is no oracle here:
  under jax 0.9 it fails ("pallas_call requires all mesh axes to be
  Manual", ROADMAP C3);
- a Q that the shard count does not divide is served whole;
- batches whose survivors overflow a capacity (fused, staged, hybrid)
  drop the same documents as the one-program batch: each shard gets the
  slots its earlier shards left;
- every shard makes the single batch's kernel dispatches, the batch is
  read once through ``device_get`` and nothing else reads the host;
- a ``ServingTier`` on a data-parallel placement reports its devices.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro_torch.core import stage, strategies  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import placement  # noqa: E402
from repro_torch.serve.batching import BucketPolicy  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.serve.tier import ServingTier, TierConfig  # noqa: E402
from repro_torch.utils import count_host_transfers  # noqa: E402
from torch_faults import FakeClock  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

F = 12
TOL = 1e-6
CPU8 = ["cpu"] * 8


def _services(sentinels=(8, 28), mode="fused", gate=None, dense=False, threshold=0.4):
    """The reference's and the port's service over the same forests. With
    ``gate`` (a feature-0 cut) the stage decisions are exact; without it the
    LEAR classifiers decide."""
    ens = ref_ensemble.random_ensemble(0, n_trees=64, depth=4, n_features=F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4), s
        )
        for i, s in enumerate(sentinels)
    ]
    ref_ds = port_ds = None
    if dense:   # an exact scorer, so the dense stage is bit-equal in both packages
        ref_ds = ref_stage.DenseStage(
            scorer=lambda x: x[:, 0],
            policy=functools.partial(ref_strategies.dense_keep_fraction, keep_frac=0.8),
        )
        port_ds = stage.DenseStage(
            scorer=lambda x: x[:, 0],
            policy=functools.partial(strategies.dense_keep_fraction, keep_frac=0.8),
        )
    kw = dict(threshold=threshold, execution_mode=mode, launch_overhead_trees=512.0)
    ref = ref_service.RankingService(
        ens, clfs[0], ref_service.ServiceConfig(**kw, dense_stage=ref_ds),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0], ServiceConfig(**kw, dense_stage=port_ds),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    if gate is not None:
        for svc in (ref, port):
            svc.stage_strategies = [
                lambda p, m, features=None: m & (features[..., 0] > gate)
            ] * len(sentinels)
    return ref, port


def _batch(rng, Q=8, D=32):
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(D // 2, D + 1, size=Q)[:, None]
    return X, mask


def _stats(svc):
    s = svc.stats
    return (s.batches, s.queries, s.docs, s.docs_continued, s.overflow_docs,
            s.batches_staged, s.queries_exited, dict(s.capacities))


def test_local_mesh_is_bit_equal_to_single_device():
    X, mask = _batch(np.random.default_rng(4), Q=2)
    sd = placement.single_device()
    Xt, mt = sd.put(X, mask, torch.device("cpu"))
    assert torch.equal(Xt, torch.as_tensor(X)) and sd.n_devices == 1
    pl = placement.local("cpu")
    assert pl.n_devices == 1 and pl.mesh.shape == (1, 1)
    assert pl.mesh.mesh_dim_names == ("data", "model") and pl.n_shards(2) == 1
    (_, a), (_, b) = _services(), _services()
    t_a, s_a = a.rank_batch(X, mask)
    t_b, s_b = b.rank_batch(X, mask, placement=pl)
    np.testing.assert_array_equal(s_a, s_b)
    np.testing.assert_array_equal(t_a, t_b)
    assert _stats(a) == _stats(b)


@pytest.mark.parametrize("Q", [8, 16])
@pytest.mark.parametrize("mode", ["fused", "staged", "auto"])
def test_data_parallel_is_bit_equal_to_single_device_and_near_the_reference(mode, Q):
    """LEAR classifiers gate each stage; two batches, so the second's
    capacities and (auto) mode follow the first's survivors."""
    ref, single = _services(mode=mode)
    _, split = _services(mode=mode)
    pl = placement.data_parallel(devices=CPU8)
    assert pl.n_devices == 8 and pl.n_shards(Q) == 8
    assert [x.shape[0] for x, _ in pl.put_shards(*_batch(np.random.default_rng(0), Q=Q),
                                                 torch.device("cpu"))] == [Q // 8] * 8
    rng = np.random.default_rng(1)
    for _ in range(2):
        X, mask = _batch(rng, Q=Q)
        t_s, s_s = single.rank_batch(X, mask)
        t_p, s_p = split.rank_batch(X, mask, placement=pl)
        np.testing.assert_array_equal(s_p, s_s)
        np.testing.assert_array_equal(t_p, t_s)
        r_top, r_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_allclose(s_p, np.asarray(r_scores), rtol=TOL, atol=TOL)
    assert _stats(split) == _stats(single)
    assert split.stats.trees_traversed == pytest.approx(single.stats.trees_traversed, rel=1e-12)


def test_a_query_count_the_shards_do_not_divide_is_served_whole():
    pl = placement.data_parallel(devices=CPU8)
    (_, single), (_, split) = _services(), _services()
    for Q in (1, 3):
        X, mask = _batch(np.random.default_rng(Q), Q=Q)
        assert pl.n_shards(Q) == 1 and len(pl.put_shards(X, mask, torch.device("cpu"))) == 1
        t_s, s_s = single.rank_batch(X, mask)
        t_p, s_p = split.rank_batch(X, mask, placement=pl)
        np.testing.assert_array_equal(s_p, s_s)
        np.testing.assert_array_equal(t_p, t_s)


@pytest.mark.parametrize("case", ["fused", "staged", "staged_qe", "hybrid_fused",
                                  "hybrid_staged"])
def test_overflow_drops_the_documents_the_whole_batch_drops(case):
    """A gate that keeps ~84% of the documents overflows the cold-start
    capacities (half the batch); the shards must overflow the same
    documents, in the stats and in the scores."""
    mode = case.split("_")[-1] if case != "staged_qe" else "staged"
    dense = case.startswith("hybrid")
    ref, single = _services(mode=mode, gate=-1.0, dense=dense)
    _, split = _services(mode=mode, gate=-1.0, dense=dense)
    if case == "staged_qe":
        for svc in (single, split):
            svc.query_exit = strategies.QueryExitConfig(k=5, margin=2.0)
    pl = placement.data_parallel(devices=CPU8)
    rng = np.random.default_rng(7)
    for _ in range(2):
        X, mask = _batch(rng, Q=16)
        t_s, s_s = single.rank_batch(X, mask)
        t_p, s_p = split.rank_batch(X, mask, placement=pl)
        np.testing.assert_array_equal(s_p, s_s)
        np.testing.assert_array_equal(t_p, t_s)
        if case != "staged_qe":
            r_top, r_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
            np.testing.assert_allclose(s_p, np.asarray(r_scores), rtol=TOL, atol=TOL)
    assert single.stats.overflow_docs > 0
    assert _stats(split) == _stats(single)


def test_every_shard_dispatches_the_batch_and_one_host_read_a_batch():
    (_, single), (_, split) = _services(mode="staged"), _services(mode="staged")
    pl = placement.data_parallel(devices=CPU8)
    X, mask = _batch(np.random.default_rng(3), Q=8)
    single.rank_batch(X, mask)
    split.rank_batch(X, mask, placement=pl)   # capacities and plans as the single one's
    ops.reset_launch_counts()
    single.rank_batch(X, mask)
    one = ops.launch_counts()
    ops.reset_launch_counts()
    with count_host_transfers() as counts:
        for _ in range(2):
            split.rank_batch(X, mask, placement=pl)
    eight = ops.launch_counts()
    assert sum(one.values()) > 0
    assert eight == {k: 2 * 8 * n for k, n in one.items()}
    assert counts.explicit_gets == 2 and counts.implicit_syncs == 0, counts.sites


def test_tier_on_a_data_parallel_placement():
    """Warmup serves every bucket through the placement (Q = 1 whole, Q = 2
    split); two queries flush one full bucket of two shards."""
    _, svc = _services()
    tier = ServingTier(
        svc, F, TierConfig(doc_counts=(32,), persistent_cache=False),
        policy=BucketPolicy(max_queries=2, min_docs=32, max_docs=32),
        placement=placement.data_parallel(devices=["cpu"] * 2), clock=FakeClock(),
    )
    rng = np.random.default_rng(9)
    queries = [rng.normal(size=(n, F)).astype(np.float32) for n in (20, 27)]
    tier.start()
    try:
        assert tier.health()["n_devices"] == 2
        got = [f.result(timeout=60) for f in [tier.submit(q) for q in queries]]
    finally:
        tier.stop()
    assert tier.stats()["batcher"]["flushes_full"] == 1
    _, alone = _services()
    for q, (top, scores) in zip(queries, got, strict=True):
        a_top, a_scores = alone.rank_batch(q[None], np.ones((1, len(q)), bool))
        np.testing.assert_array_equal(scores, a_scores[0])
        np.testing.assert_array_equal(top, a_top[0][: len(top)])
