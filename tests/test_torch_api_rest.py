"""The rest of the reference's public API in the port, each held to the
reference on the same numpy inputs.

- ``TwoStageCascade`` over DLRM-RM2 (smoke config, as
  ``examples/cascade_retrieval.py``): the same cheap scores give the same
  survivors bit for bit (``lax.top_k`` order: descending, ties to the lower
  position — the candidate ids repeat, so ties are real), and their full
  scores agree within 1e-5;
- ``metrics.ranking.ideal_dcg_at_k`` (1e-6), ``TreeEnsemble.astype``
  (bit-equal), ``stage_cost_trees`` and the ``CascadeStage`` protocol;
- ``use_kernel`` on the LEAR classifier and ``use_kernel_classifier`` on
  the service, both ways;
- the three deprecated keyword shims: each warns (``pytest.warns``) and
  builds the config the reference's shim builds, with the same result as
  the config form; and no port caller uses one (the port's serving, tier
  and engine paths run with ``DeprecationWarning`` as an error, standing in
  for ``pytest.ini``'s ``error:repro\\.`` filter, which the port's
  ``repro_torch.`` messages do not match);
- ``serve.calibration``: ``record_path`` merges the report into a JSON file
  and survives a corrupt or unwritable one; ``last_calibration``;
- ``serve.placement.auto`` on one device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.forest.scoring import score_bitvector as ref_score_bitvector  # noqa: E402
from repro.metrics import ranking as ref_ranking  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro.serve import tier as ref_tier  # noqa: E402
from repro_torch.core import features, lear, stage  # noqa: E402
from repro_torch.core.cascade import CascadeRanker  # noqa: E402
from repro_torch.core.strategies import QueryExitConfig, dense_keep_fraction  # noqa: E402
from repro_torch.forest.scoring import score_bitvector  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.metrics import ranking  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.serve import calibration, placement  # noqa: E402
from repro_torch.serve.ranking_service import (  # noqa: E402
    RankingService,
    ServiceConfig,
    TwoStageCascade,
)
from repro_torch.serve.tier import BucketPolicy, ServingTier, TierConfig  # noqa: E402
from repro_torch.serve.warmup import warmup_service  # noqa: E402
from torch_faults import FakeClock, settle  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402

F = 12
SHIM = r"^repro_torch\."


# ---------------------------------------------------------------------------
# TwoStageCascade on DLRM-RM2.
# ---------------------------------------------------------------------------


def _dlrm():
    """The smoke config's reference parameters (numpy draws in the
    reference tree), the port's copy, one user and 4,096 candidate ids."""
    cfg = ref_configs.get_smoke_config("dlrm-rm2")
    shapes = jax.eval_shape(lambda: ref_recsys.dlrm_init(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * (s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1))
        .astype(np.float32),
        shapes,
    )
    params = recsys.recsys_params_from_numpy(cfg, tree, "cpu")
    user = {
        "dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
        "sparse": np.stack(
            [rng.integers(0, v, size=(1, cfg.multi_hot)) for v in cfg.vocab_sizes[:-1]], axis=1
        ).astype(np.int32),
    }
    cand_ids = rng.integers(0, cfg.vocab_sizes[-1], size=4096).astype(np.int32)
    return cfg, tree, params, user, cand_ids


@pytest.mark.parametrize("keep", [0.01, 0.05, 0.2])
def test_two_stage_cascade_matches_the_reference(keep):
    cfg, tree, params, user, cand_ids = _dlrm()
    pcfg = port_configs.get_smoke_config("dlrm-rm2")
    table = np.asarray(tree["tables"][f"t{len(cfg.vocab_sizes) - 1}"])
    bot = np.asarray(ref_recsys._mlp(jnp.asarray(user["dense"]), tree["bot"], jax.nn.relu)[0])

    # The same cheap scores (numpy) in both packages: the survivors must be
    # the same ids in the same order.
    def cheap(ids):
        return table[np.asarray(ids)] @ bot

    ref_full = jax.jit(lambda ids: ref_recsys.dlrm_score_candidates(
        cfg, tree, {**{k: jnp.asarray(v) for k, v in user.items()}, "cand_ids": ids}))
    port_user = {k: torch.as_tensor(v) for k, v in user.items()}
    ref = ref_service.TwoStageCascade(lambda ids: jnp.asarray(cheap(ids)), ref_full, keep)
    port = TwoStageCascade(
        lambda ids: torch.as_tensor(cheap(ids)),
        lambda ids: recsys.dlrm_score_candidates(pcfg, params, {**port_user, "cand_ids": ids}),
        keep,
    )
    want_ids, want_full, want_cheap = (np.asarray(a) for a in ref.score(jnp.asarray(cand_ids)))
    got_ids, got_full, got_cheap = port.score(torch.as_tensor(cand_ids))
    k = max(1, int(len(cand_ids) * keep))
    assert got_ids.shape == (k,) == want_ids.shape
    np.testing.assert_array_equal(got_cheap.numpy(), want_cheap)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(
        got_ids.numpy(), cand_ids[np.argsort(-want_cheap, kind="stable")[:k]]
    )
    np.testing.assert_allclose(got_full.numpy(), want_full, rtol=1e-5, atol=1e-5)
    assert len(np.unique(got_ids.numpy())) < k or keep == 0.01  # ties were ranked

    # Each package's own cheap scorer (the example's: the candidate's
    # embedding · the bottom-MLP vector) agrees within 1e-5.
    port_bot = recsys._mlp(port_user["dense"], params, "bot", torch.relu)[0]
    own = recsys._take(params[f"tables/t{len(cfg.vocab_sizes) - 1}"], torch.as_tensor(cand_ids)) @ port_bot
    np.testing.assert_allclose(own.numpy(), want_cheap, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Small leftovers.
# ---------------------------------------------------------------------------


def test_ideal_dcg_matches_the_reference():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 5, size=(6, 40)).astype(np.int32)
    mask = np.arange(40)[None] < rng.integers(1, 41, size=(6, 1))
    for k in (1, 5, 10, 40):
        want = np.asarray(ref_ranking.ideal_dcg_at_k(jnp.asarray(labels), jnp.asarray(mask), k))
        got = ranking.ideal_dcg_at_k(torch.as_tensor(labels), torch.as_tensor(mask), k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtypes", [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)])
def test_astype_is_bit_equal(dtypes):
    ens = ref_ensemble.random_ensemble(4, n_trees=20, depth=4, n_features=F)
    want = ens.astype(dtypes[0])
    port = to_port(ens)
    got = port.astype(dtypes[1])
    for name in ("threshold", "leaf_value", "base_score"):
        assert getattr(got, name).dtype == dtypes[1]
        np.testing.assert_array_equal(
            getattr(got, name).float().numpy(), np.asarray(getattr(want, name)).astype(np.float32)
        )
    for name in ("feature", "left", "right"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert torch.equal(got.mask, port.mask)


def test_stage_cost_trees_and_the_protocol():
    pairs = [
        (ref_stage.TreeStage(5, classifier_trees=10.0), stage.TreeStage(5, classifier_trees=10.0)),
        (ref_stage.TreeStage(7), stage.TreeStage(7)),
        (ref_stage.DenseStage(scorer=None, policy=None, cost_trees=3.5),
         stage.DenseStage(scorer=lambda x: x[:, 0], policy=lambda s, m: m, cost_trees=3.5)),
        (ref_stage.DenseStage(scorer=None, policy=None),
         stage.DenseStage(scorer=lambda x: x[:, 0], policy=lambda s, m: m)),
    ]
    for want, got in pairs:
        assert got.stage_cost_trees == want.stage_cost_trees
        assert isinstance(got, stage.CascadeStage) and isinstance(want, ref_stage.CascadeStage)
    assert not isinstance(object(), stage.CascadeStage)
    cfg = stage.EngineConfig.trees((5, 9), classifier_trees=(10, 4))
    assert [s.stage_cost_trees for s in cfg.stages] == [10.0, 4.0]
    assert stage.DenseScorer is not None


def _classifier(seed=7):
    ref_forest = ref_ensemble.random_ensemble(seed, n_trees=10, depth=5, n_features=F + 4)
    return ref_lear.LearClassifier(ref_forest, 10), lear.LearClassifier.from_numpy(
        ref_arrays(ref_forest), 10, "cpu")


def test_bare_classifier_call_matches_the_references_bare_call():
    """``use_kernel=False`` (the default in both packages) scores through the
    bitvector scorer. The logits are bit-equal: both sum a row of 10 trees
    left to right. The probabilities may differ by one ulp, because XLA's
    float32 ``exp`` is its own approximation, not torch's."""
    rng = np.random.default_rng(8)
    for seed in range(5):
        ref_clf, port_clf = _classifier(seed)
        X = rng.normal(size=(2, 32, F + 4)).astype(np.float32)
        flat = X.reshape(64, F + 4)
        _, per_tree = score_bitvector(port_clf.forest, torch.as_tensor(flat), return_per_tree=True)
        logits = per_tree[:, 0]
        for t in range(1, per_tree.shape[1]):
            logits = logits + per_tree[:, t]
        np.testing.assert_array_equal(
            (logits + port_clf.forest.base_score).numpy(),
            np.asarray(ref_score_bitvector(ref_clf.forest, jnp.asarray(flat))),
        )
        np.testing.assert_array_max_ulp(
            port_clf.prob_continue(torch.as_tensor(X)).numpy(),
            np.asarray(ref_clf.prob_continue(jnp.asarray(X))),
            maxulp=1,
        )


@pytest.mark.parametrize("use_kernel", [False, True])
def test_use_kernel_both_ways(use_kernel):
    ref_clf, port_clf = _classifier()
    rng = np.random.default_rng(9)
    X = rng.normal(size=(2, 32, F)).astype(np.float32)
    partial = rng.normal(size=(2, 32)).astype(np.float32)
    mask = np.arange(32)[None] < np.array([[32], [20]])
    aug_j = ref_features.augment_features(jnp.asarray(X), jnp.asarray(partial), jnp.asarray(mask))
    aug_t = features.augment_features(torch.as_tensor(X), torch.as_tensor(partial), torch.as_tensor(mask))
    ops.reset_launch_counts()
    got = port_clf.continue_mask(aug_t, torch.as_tensor(mask), 0.5, use_kernel=use_kernel)
    assert ops.launch_counts()["plain"] == int(use_kernel)
    want = ref_clf.continue_mask(aug_j, jnp.asarray(mask), 0.5, use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _services(use_kernel_classifier=True, query_exit=None):
    """The reference's and the port's service over the same forests (the
    port's with ``query_exit`` when given)."""
    ens = ref_ensemble.random_ensemble(0, n_trees=64, depth=4, n_features=F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4), s)
        for i, s in enumerate((8, 28))
    ]
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=0.5, execution_mode="fused", launch_overhead_trees=512.0,
            use_kernel_classifier=use_kernel_classifier,
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [lear.LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(
            threshold=0.5, execution_mode="fused", launch_overhead_trees=512.0,
            use_kernel_classifier=use_kernel_classifier, query_exit=query_exit,
        ),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    return ref, port


def _batch(rng, Q=2, D=64):
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(1, D + 1, size=(Q, 1))
    return X, mask


@pytest.mark.parametrize("use_kernel_classifier", [False, True])
def test_service_use_kernel_classifier(use_kernel_classifier):
    ref, port = _services(use_kernel_classifier)
    assert port.use_kernel_classifier is use_kernel_classifier
    rng = np.random.default_rng(5)
    for _ in range(3):
        X, mask = _batch(rng)
        ops.reset_launch_counts()
        top, scores = port.rank_batch(X, mask)
        # fused, two stages: the tail is one plain launch; each classifier
        # is one more when it runs through the kernel
        assert ops.launch_counts()["plain"] == 1 + 2 * use_kernel_classifier
        want_top, want_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_array_equal(scores, np.asarray(want_scores))
        np.testing.assert_array_equal(top, np.asarray(want_top))


# ---------------------------------------------------------------------------
# The deprecated keyword shims.
# ---------------------------------------------------------------------------


def test_service_keyword_shim():
    ref, port = _services()
    kw = dict(threshold=0.3, execution_mode="staged", launch_overhead_trees=256.0, top_k=5)
    with pytest.warns(DeprecationWarning, match=SHIM):
        shim = RankingService(port.ensemble, port.stage_classifiers[0], device="cpu", **kw,
                              extra_classifiers=port.stage_classifiers[1:])
    with pytest.warns(DeprecationWarning, match=r"^repro\."):
        ref_shim = ref_service.RankingService(ref.ensemble, ref.classifier, **kw)
    assert dataclasses.asdict(shim.config) == dataclasses.asdict(ServiceConfig(**kw))
    assert {f: getattr(shim.config, f) for f in kw} == {f: getattr(ref_shim.config, f) for f in kw}
    config_form = RankingService(
        port.ensemble, port.stage_classifiers[0], ServiceConfig(**kw),
        extra_classifiers=port.stage_classifiers[1:], device="cpu",
    )
    rng = np.random.default_rng(1)
    for _ in range(3):
        X, mask = _batch(rng)
        a, b = shim.rank_batch(X, mask), config_form.rank_batch(X, mask)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.warns(DeprecationWarning, match=SHIM):
        positional = RankingService(port.ensemble, port.stage_classifiers[0], 0.3,
                                    launch_overhead_trees=1.0, device="cpu")
    assert positional.config.threshold == 0.3
    with pytest.raises(TypeError, match="not both"):
        RankingService(port.ensemble, port.stage_classifiers[0], ServiceConfig(), threshold=0.3,
                       device="cpu")


def test_rank_progressive_keyword_shim():
    ref_ens = ref_ensemble.random_ensemble(1, n_trees=40, depth=3, n_features=F)
    ens = to_port(ref_ens)
    strats = [lambda p, m, features=None: m & (p > -0.5), lambda p, m, features=None: m & (p > 0.0)]
    ranker = CascadeRanker(ens, sentinel=8, strategy=strats[0])
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.normal(size=(2, 32, F)).astype(np.float32))
    mask = torch.as_tensor(np.arange(32)[None] < np.array([[32], [17]]))
    want = ranker.rank_progressive(
        X, mask, stage.EngineConfig.trees((8, 20), strats, capacities=(64, 32), mode="staged"))
    with pytest.warns(DeprecationWarning, match=SHIM):
        got = ranker.rank_progressive(X, mask, sentinels=(8, 20), strategies=strats,
                                      capacities=(64, 32), mode="staged")
    with pytest.warns(DeprecationWarning, match=SHIM):
        positional = ranker.rank_progressive(X, mask, [8, 20], capacities=(64, 32),
                                             strategies=strats, mode="staged")
    for r in (got, positional):
        assert r.mode == "staged"
        torch.testing.assert_close(r.scores, want.scores, rtol=0, atol=0)
        torch.testing.assert_close(r.overflow, want.overflow)
    # the reference's shim, given the same keywords, ranks the same
    ref_ranker = ref_cascade.CascadeRanker(ref_ens, sentinel=8, strategy=strats[0])
    with pytest.warns(DeprecationWarning, match=r"^repro\."):
        ref_r = ref_ranker.rank_progressive(
            jnp.asarray(X.numpy()), jnp.asarray(mask.numpy()), sentinels=(8, 20),
            strategies=strats, capacities=(64, 32), mode="staged",
        )
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref_r.scores))
    with pytest.warns(DeprecationWarning, match=SHIM):  # defaults: fused, leaf_gather auto, 16
        default = ranker.rank_progressive(X, mask, sentinels=(8,))
    assert default.mode == "fused"
    with pytest.raises(TypeError, match="not both"):
        ranker.rank_progressive(X, mask, stage.EngineConfig.trees((8,)), mode="staged")
    with pytest.raises(TypeError, match="EngineConfig"):
        ranker.rank_progressive(X, mask)
    with pytest.raises(TypeError, match="EngineConfig"):
        ranker.rank_progressive(X, mask, query_exit=QueryExitConfig())


def test_tier_keyword_shim():
    ref, port = _services()
    with pytest.warns(DeprecationWarning, match=SHIM):
        shim = ServingTier(port, F, doc_counts=(32, 64), warmup=False, persistent_cache=False,
                           policy=BucketPolicy(max_queries=1), clock=FakeClock())
    with pytest.warns(DeprecationWarning, match=r"^repro\."):
        ref_shim = ref_tier.ServingTier(ref, F, doc_counts=(32, 64), warmup=False,
                                        persistent_cache=False)
    assert shim.config == TierConfig(doc_counts=(32, 64), warmup=False, persistent_cache=False)
    assert dataclasses.asdict(shim.config) == dataclasses.asdict(ref_shim.config)
    with pytest.warns(DeprecationWarning, match=SHIM):
        positional = ServingTier(port, F, (32,), clock=FakeClock())
    assert positional.config.doc_counts == (32,)
    with pytest.raises(TypeError, match="not both"):
        ServingTier(port, F, TierConfig(), doc_counts=(32,))
    # the shim's tier serves as the config form's does
    q = np.random.default_rng(4).normal(size=(20, F)).astype(np.float32)
    shim.start()
    try:
        top, scores = shim.rank(q)
    finally:
        shim.stop()
    want_top, want_scores = port.rank_batch(q[None], np.ones((1, 20), bool))
    np.testing.assert_array_equal(scores, want_scores[0][:20])


def test_port_callers_use_no_shim():
    """The port's own serving, tier and engine paths, with every
    DeprecationWarning an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        _, svc = _services(query_exit=QueryExitConfig(k=5, margin=1.0))
        rng = np.random.default_rng(6)
        for mode in ("fused", "staged", "auto"):
            svc.execution_mode = mode
            svc.rank_batch(*_batch(rng))
        dense = stage.DenseStage(
            scorer=lambda x: x[:, 0],
            policy=functools.partial(dense_keep_fraction, keep_frac=0.5),
        )
        hybrid = RankingService(
            svc.ensemble, svc.stage_classifiers[0],
            ServiceConfig(dense_stage=dense, launch_overhead_trees=512.0), device="cpu",
        )
        hybrid.rank_batch(*_batch(rng))
        warmup_service(svc, F, [(1, 32), (2, 32)])
        clock = FakeClock()
        tier = ServingTier(
            svc, F, TierConfig(doc_counts=(32,), persistent_cache=False),
            policy=BucketPolicy(max_queries=2, max_wait_ms=5.0), clock=clock,
        ).start()
        futs = [tier.submit(rng.normal(size=(24, F)).astype(np.float32)) for _ in range(3)]
        clock.advance(0.006)
        _, errors = settle(futs, timeout_s=120)
        tier.stop()
        assert errors == []


# ---------------------------------------------------------------------------
# Calibration and placement.
# ---------------------------------------------------------------------------

REF_PAYLOAD_KEYS = {
    "backend", "probe_docs", "probe_trees", "block_t", "t_small_us", "t_full_us",
    "per_doctree_us", "launch_overhead_trees",
}


def test_record_path_merges_and_survives_a_bad_file(tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({"other": 1}))
    value = calibration.calibrate_launch_overhead_trees("cpu", record_path=str(path))
    doc = json.loads(path.read_text())
    assert doc["other"] == 1
    assert set(doc["launch_calibration"]) == REF_PAYLOAD_KEYS
    assert doc["launch_calibration"]["launch_overhead_trees"] == value
    assert doc["launch_calibration"]["backend"] == "cpu"
    last = calibration.last_calibration()
    assert last is not None and last["launch_overhead_trees"] == value
    # a cached probe records too
    again = tmp_path / "again.json"
    assert calibration.calibrate_launch_overhead_trees("cpu", record_path=str(again)) == value
    assert json.loads(again.read_text())["launch_calibration"]["launch_overhead_trees"] == value
    # a corrupt file, a file holding a list, an unwritable path: never raise
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    assert calibration.calibrate_launch_overhead_trees("cpu", record_path=str(corrupt)) == value
    assert corrupt.read_text() == "{not json"
    listed = tmp_path / "list.json"
    listed.write_text("[1, 2]")
    calibration.calibrate_launch_overhead_trees("cpu", record_path=str(listed))
    assert set(json.loads(listed.read_text())) == {"launch_calibration"}
    calibration.calibrate_launch_overhead_trees(
        "cpu", record_path=str(tmp_path / "missing" / "dir" / "x.json"))


def test_placement_auto_on_one_device(monkeypatch):
    assert torch.cuda.device_count() <= 1
    p = placement.auto()
    assert p == placement.single_device() and p.n_devices == 1
    X, mask = p.put(np.zeros((1, 4, F), np.float32), np.ones((1, 4), bool), torch.device("cpu"))
    assert X.dtype == torch.float32 and mask.dtype == torch.bool
    # Two cards visible: data-parallel over both, the query axis split in two.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    p = placement.auto()
    assert p.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert p.n_devices == 2 and p.n_shards(4) == 2 and p.n_shards(3) == 1
