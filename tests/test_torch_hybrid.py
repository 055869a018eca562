"""Port parity: the hybrid cascade (dense stage-0 gate) against the reference.

- the dense scorer on converted parameters equals ``repro``'s
  ``dense_score`` within 1e-5, and ``dot_interact`` keeps the
  ``np.triu_indices`` order exactly;
- ``dense_keep_fraction``, ``ideal_continue`` and the dense terms of the
  cost model and the accounting are exact;
- with a scorer that is exact in both packages (``x[:, 0]``) the hybrid
  engine is bit-exact with ``repro.core.cascade``, fused and staged, one
  and three tree stages, with and without query exit, with an overflowing
  dense capacity, and its dispatch counts follow the reference's launch
  contract (the dense stage adds none);
- with the real converted MLP it meets the stated rule: dense scores within
  1e-5, keep decisions equal except for documents within tolerance of the
  keep boundary (none on these seeds), scores within 1e-5;
- ``RankingService`` with a dense stage equals the reference service, rungs
  with ``dense_keep_frac`` equal standalone services at those fractions,
  and warmup leaves no first touch, the dense scorer's included.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.metrics import speedup as ref_speedup  # noqa: E402
from repro.models import dense_scorer as ref_dense  # noqa: E402
from repro.serve import degradation as ref_degradation  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro_torch.core import cascade, stage, strategies  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.metrics import speedup  # noqa: E402
from repro_torch.models import dense_scorer  # noqa: E402
from repro_torch.serve.degradation import ExitRung  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.serve.warmup import warmup_service  # noqa: E402
from strategy_harness import expected_launches  # noqa: E402
from torch_parity import keep_boundary_docs, ref_arrays, to_port  # noqa: E402

SENTINELS = (10, 20, 35)
EPT = dict(k_s=5, p=0.5)
Q, D, F, T = 4, 24, 16, 60
KEEP = 0.5
TOL = 1e-5


def _problem(seed):
    ens = ref_ensemble.random_ensemble(seed, n_trees=T, depth=4, n_features=F)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = rng.random((Q, D)) < 0.9
    return ens, X, mask


def _ref_params(seed, n_features, **kw):
    return jax.tree.map(
        np.asarray, ref_dense.init_dense_scorer(jax.random.PRNGKey(seed), n_features, **kw)
    )


def _exact_stages(capacity=None, keep=KEEP):
    """The same exact scorer and policy in both packages."""
    ref = ref_stage.DenseStage(
        scorer=lambda x: x[:, 0],
        policy=functools.partial(ref_strategies.dense_keep_fraction, keep_frac=keep),
        capacity=capacity,
    )
    port = stage.DenseStage(
        scorer=lambda x: x[:, 0],
        policy=functools.partial(strategies.dense_keep_fraction, keep_frac=keep),
        capacity=capacity,
    )
    return ref, port


def _mlp_stages(seed, keep=KEEP):
    params = _ref_params(seed, F)
    ref = ref_stage.DenseStage(
        scorer=ref_dense.make_dense_scorer(jax.tree.map(jnp.asarray, params)),
        policy=functools.partial(ref_strategies.dense_keep_fraction, keep_frac=keep),
    )
    port = stage.DenseStage(
        scorer=dense_scorer.dense_params_from_numpy(params, "cpu"),
        policy=functools.partial(strategies.dense_keep_fraction, keep_frac=keep),
    )
    return ref, port


# -- the dense scorer ---------------------------------------------------------


@pytest.mark.parametrize("B,n_features,n_vec,vec_dim,hidden", [
    (64, 16, 4, 16, 32), (300, 136, 4, 16, 32), (7, 5, 2, 3, 8), (129, 40, 6, 8, 16),
])
def test_dense_score_matches_reference(B, n_features, n_vec, vec_dim, hidden):
    params = _ref_params(B, n_features, n_vec=n_vec, vec_dim=vec_dim, hidden=hidden)
    x = np.random.default_rng(B).normal(size=(B, n_features)).astype(np.float32)
    want = np.asarray(ref_dense.dense_score(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    scorer = dense_scorer.dense_params_from_numpy(params, "cpu")
    with torch.no_grad():
        got = scorer(torch.as_tensor(x)).numpy()
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for k, v in scorer.to_numpy().items():
        np.testing.assert_array_equal(v, params[k])


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_dot_interact_order_is_the_reference_order(n):
    vecs = np.random.default_rng(n).integers(-4, 5, size=(5, n, 3)).astype(np.float32)
    want = np.asarray(ref_dense.dot_interact(jnp.asarray(vecs)))
    got = dense_scorer.dot_interact(torch.as_tensor(vecs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_init_follows_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    scorer = dense_scorer.init_dense_scorer(gen, 136, device="cpu")
    ref = _ref_params(0, 136)
    for name, p in scorer.to_numpy().items():
        assert p.shape == ref[name].shape, name
    params = scorer.to_numpy()
    assert not params["pb"].any() and not params["b1"].any() and not params["b2"].any()
    # normal · fan^-0.5: the variance times the fan is ~1.
    for name, fan in (("proj", 136), ("w1", 4 * 16 + 6), ("w2", 32)):
        assert abs(params[name].var() * fan - 1.0) < 0.5, name


# -- strategies, cost model, accounting ---------------------------------------


@pytest.mark.parametrize("keep_frac", [0.0, 0.1, 0.35, 0.5, 1.0, 1.5])
def test_dense_keep_fraction_matches_reference(keep_frac):
    rng = np.random.default_rng(int(keep_frac * 100))
    partial = rng.normal(size=(6, 33)).astype(np.float32)
    partial[0, :5] = 0.25  # ties
    mask = rng.random((6, 33)) < 0.8
    mask[1] = False        # an empty query
    want = ref_strategies.dense_keep_fraction(jnp.asarray(partial), jnp.asarray(mask), keep_frac)
    got = strategies.dense_keep_fraction(torch.as_tensor(partial), torch.as_tensor(mask), keep_frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_ideal_continue_matches_reference(k):
    rng = np.random.default_rng(k)
    partial = rng.normal(size=(5, 20)).astype(np.float32)
    full = (partial + rng.normal(size=(5, 20))).astype(np.float32)
    labels = rng.integers(0, 5, size=(5, 20)).astype(np.float32)
    mask = rng.random((5, 20)) < 0.85
    args = (partial, full, labels, mask)
    want_m, want_cut = ref_strategies.ideal_continue(*map(jnp.asarray, args), k=k)
    got_m, got_cut = strategies.ideal_continue(*map(torch.as_tensor, args), k=k)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_cut.numpy(), np.asarray(want_cut))


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("sentinels", [(50,), (50, 150), (50, 150, 400)])
def test_cost_model_dense_terms_match_reference(mode, sentinels):
    rng = np.random.default_rng(len(sentinels))
    n_docs, S = 2048, len(sentinels)
    for _ in range(5):
        surv = sorted(rng.uniform(0, n_docs, size=S + 1).tolist(), reverse=True)
        caps = [int(2 ** rng.integers(6, 12)) for _ in range(S + 1)]
        kw = dict(
            launch_overhead_trees=float(rng.uniform(0, 3000)), stage_capacities=caps,
            block_b=256, query_exit_rate=float(rng.uniform()),
            dense_cost_trees=4.0, dense_stage=True,
        )
        want = ref_speedup.progressive_cost_model(n_docs, surv, sentinels, 1047, mode, **kw)
        got = speedup.progressive_cost_model(n_docs, surv, sentinels, 1047, mode, **kw)
        assert got == want
    with pytest.raises(ValueError):
        speedup.progressive_cost_model(n_docs, surv[1:], sentinels, 1047, mode, **kw)


def test_hybrid_accounting_matches_reference():
    rng = np.random.default_rng(5)
    mask = rng.random((Q, D)) < 0.9
    masks = [mask & (rng.random((Q, D)) < f) for f in (0.6, 0.4, 0.2)]
    for k in range(1, 3):
        masks[k] = masks[k] & masks[k - 1]
    sents, costs = (0, 10, 30), (4.0, 10.0, 10.0)
    want = ref_speedup.trees_traversed_progressive(
        jnp.asarray(mask), [jnp.asarray(m) for m in masks], sents, T, costs
    )
    got = speedup.trees_traversed_progressive(
        torch.as_tensor(mask), [torch.as_tensor(m) for m in masks], sents, T, costs
    )
    assert float(got) == float(want)


# -- the engine ---------------------------------------------------------------

QE = {
    "off": (None, None),
    "inf": (ref_strategies.QueryExitConfig(k=3), strategies.QueryExitConfig(k=3)),
    "margin_from0": (
        ref_strategies.QueryExitConfig(k=3, margin=0.05),
        strategies.QueryExitConfig(k=3, margin=0.05),
    ),
    "margin_from1": (
        ref_strategies.QueryExitConfig(k=3, margin=0.05, from_stage=1),
        strategies.QueryExitConfig(k=3, margin=0.05, from_stage=1),
    ),
}


def _run_hybrid(seed, sentinels, mode, qe, stages):
    ens, X, mask = _problem(seed)
    ref_dense_stage, port_dense_stage = stages
    ref_qe, port_qe = QE[qe]
    ref_ops.reset_launch_counts()
    want = ref_cascade.CascadeRanker(
        ens, sentinels[0], ref_strategies.ept_continue
    ).rank_progressive(
        jnp.asarray(X), jnp.asarray(mask),
        ref_stage.EngineConfig.hybrid(ref_dense_stage, sentinels, mode=mode, query_exit=ref_qe),
        **EPT,
    )
    ref_counts = ref_ops.launch_counts()
    ops.reset_launch_counts()
    got = cascade.CascadeRanker(to_port(ens), sentinels[0], strategies.ept_continue).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        stage.EngineConfig.hybrid(port_dense_stage, sentinels, mode=mode, query_exit=port_qe),
        **EPT,
    )
    return got, want, ops.launch_counts(), ref_counts, X, mask


def _assert_same(got, want):
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.continue_mask.numpy(), np.asarray(want.continue_mask))
    assert len(got.stage_masks) == len(want.stage_masks)
    for g, w in zip(got.stage_masks, want.stage_masks, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.partials.numpy(), np.asarray(want.partials))
    assert int(got.overflow) == int(want.overflow)
    assert float(got.speedup) == float(want.speedup)
    if want.query_exited is None:
        assert got.query_exited is None
    else:
        np.testing.assert_array_equal(got.query_exited.numpy(), np.asarray(want.query_exited))


@pytest.mark.parametrize("qe", list(QE))
@pytest.mark.parametrize("sentinels", [(10,), SENTINELS])
@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_hybrid_engine_is_bitexact_with_reference(mode, sentinels, qe):
    got, want, counts, ref_counts, X, mask = _run_hybrid(
        40, sentinels, mode, qe, _exact_stages()
    )
    _assert_same(got, want)
    assert got.partials.shape == (Q, D, len(sentinels) + 1)
    assert counts == ref_counts == expected_launches(
        mode, len(sentinels), has_tail=True, query_exit_on=qe != "off"
    )
    # The gate pruned, and dense-exited documents keep the dense score.
    gate = got.stage_masks[0].numpy()
    assert 0 < gate.sum() < mask.sum()
    dense_exited = mask & ~gate
    np.testing.assert_array_equal(got.scores.numpy()[dense_exited], X[..., 0][dense_exited])


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_hybrid_engine_with_an_overflowing_dense_capacity(mode):
    got, want, *_ = _run_hybrid(41, SENTINELS, mode, "margin_from1", _exact_stages(capacity=8))
    _assert_same(got, want)
    assert int(got.overflow) > 0


def test_hybrid_modes_are_bitexact_with_each_other():
    fused, *_ = _run_hybrid(42, SENTINELS, "fused", "off", _exact_stages())
    staged, *_ = _run_hybrid(42, SENTINELS, "staged", "off", _exact_stages())
    np.testing.assert_array_equal(fused.scores.numpy(), staged.scores.numpy())
    for f, s in zip(fused.stage_masks, staged.stage_masks, strict=True):
        np.testing.assert_array_equal(f.numpy(), s.numpy())


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("seed", [43, 44])
def test_hybrid_engine_with_the_converted_mlp(mode, seed):
    """The tolerance rule: dense scores within 1e-5; keep decisions equal
    except for documents within tolerance of the keep boundary; every
    document with the same decisions scored within 1e-5."""
    got, want, _, _, X, mask = _run_hybrid(seed, SENTINELS, mode, "off", _mlp_stages(seed))
    d_got, d_want = got.partials[..., 0].numpy(), np.asarray(want.partials)[..., 0]
    np.testing.assert_allclose(d_got[mask], d_want[mask], rtol=TOL, atol=TOL)
    gate_got, gate_want = got.stage_masks[0].numpy(), np.asarray(want.stage_masks[0])
    boundary = keep_boundary_docs(d_want, gate_want, mask, TOL)
    assert boundary.sum() == 0  # the expected case on these seeds
    np.testing.assert_array_equal(gate_got[~boundary], gate_want[~boundary])
    same = np.all([g.numpy() == np.asarray(w) for g, w in zip(got.stage_masks, want.stage_masks)], 0)
    assert same.all()
    np.testing.assert_allclose(
        got.scores.numpy()[same], np.asarray(want.scores)[same], rtol=TOL, atol=TOL
    )


def test_engine_config_dense_rules():
    _, dense = _exact_stages()
    tree = stage.TreeStage(10)
    cfg = stage.EngineConfig.hybrid(dense, (10, 20), capacities=(64, 32))
    assert cfg.dense is dense and cfg.n_stages == 3 and cfg.sentinels == (10, 20)
    assert cfg.tree_stages == (tree, stage.TreeStage(20))
    assert cfg.capacities == (32, 64, 32)  # the dense entry takes the last tree entry
    pinned = stage.DenseStage(dense.scorer, dense.policy, capacity=16)
    assert stage.EngineConfig.hybrid(pinned, (10,), capacities=(8,)).capacities == (16, 8)
    assert stage.EngineConfig.trees((10,)).dense is None
    with pytest.raises(ValueError, match="stage 0"):
        stage.EngineConfig(stages=(tree, dense))
    with pytest.raises(ValueError, match="one entry per stage"):
        stage.EngineConfig(stages=(dense, tree), capacities=(8,))
    with pytest.raises(ValueError, match="TreeStage"):
        stage.EngineConfig(stages=(dense,))
    with pytest.raises(ValueError, match="cost_trees"):
        stage.DenseStage(dense.scorer, dense.policy, cost_trees=-1.0)
    with pytest.raises(ValueError, match="capacity"):
        stage.DenseStage(dense.scorer, dense.policy, capacity=0)


# -- the service, its rungs and warmup ------------------------------------------

SERVICE_SENTINELS = (8, 28)


def _services(mode, scorer="exact", keep=0.35, seed=0):
    ens = ref_ensemble.random_ensemble(seed, n_trees=64, depth=4, n_features=F)
    clfs = [
        ref_lear.LearClassifier(
            ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4), s
        )
        for i, s in enumerate(SERVICE_SENTINELS)
    ]
    ref_ds, port_ds = (_exact_stages(keep=keep) if scorer == "exact" else _mlp_stages(7, keep))
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0,
            dense_stage=ref_ds,
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(
            threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0,
            dense_stage=port_ds,
        ),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    return ref, port


def _batch(rng, Qb=3, Db=32):
    X = rng.normal(size=(Qb, Db, F)).astype(np.float32)
    mask = np.arange(Db)[None, :] < rng.integers(Db // 3, Db + 1, size=Qb)[:, None]
    return X, mask


def _stats(svc):
    s = svc.stats
    return (s.batches, s.queries, s.docs, s.docs_continued, s.overflow_docs,
            s.trees_traversed, s.trees_full_equiv, s.batches_staged)


@pytest.mark.parametrize("scorer", ["exact", "mlp"])
@pytest.mark.parametrize("mode", ["fused", "staged", "auto"])
def test_hybrid_service_matches_reference(mode, scorer):
    ref, port = _services(mode, scorer)
    assert port.n_stages == ref.n_stages == 3
    rng = np.random.default_rng(11)
    for _ in range(3):
        X, mask = _batch(rng)
        r_top, r_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        top, scores = port.rank_batch(X, mask)
        if scorer == "exact":
            np.testing.assert_array_equal(scores, np.asarray(r_scores))
            np.testing.assert_array_equal(top, np.asarray(r_top))
        else:
            np.testing.assert_allclose(scores, np.asarray(r_scores), rtol=TOL, atol=TOL)
        assert port._active_state().peaks == ref._stage_peaks
    assert _stats(port) == _stats(ref)


def test_pinned_dense_capacity_overrides_the_ratchet():
    _, port = _services("fused")
    port.dense_stage = stage.DenseStage(
        port.dense_stage.scorer, port.dense_stage.policy, capacity=16
    )
    caps = port._pick_capacities(96)
    assert caps[0] == 16 and len(caps) == 3
    port.rank_batch(*_batch(np.random.default_rng(1)))
    assert next(iter(port.stats.capacities))[0] == 16


def test_service_moves_the_dense_scorer_once():
    _, port = _services("fused", "mlp")
    scorer = port.dense_stage.scorer
    assert isinstance(scorer, dense_scorer.DenseScorer)
    assert next(scorer.parameters()).device.type == "cpu"
    rng = np.random.default_rng(2)
    port.rank_batch(*_batch(rng))
    port.rank_batch(*_batch(rng))
    assert port.dense_stage.scorer is scorer
    assert len(port._stages_cache) == 1


def _ladders(scorer):
    ref, port = _services("fused", scorer)
    ref.install_rungs((
        ref_degradation.ExitRung("dense", dense_keep_frac=0.2),
        ref_degradation.ExitRung("both", threshold=0.7, dense_keep_frac=0.2),
    ))
    port.install_rungs((
        ExitRung("dense", dense_keep_frac=0.2),
        ExitRung("both", threshold=0.7, dense_keep_frac=0.2),
    ))
    return ref, port


@pytest.mark.parametrize("scorer", ["exact", "mlp"])
def test_dense_keep_frac_rungs_match_standalone_services(scorer):
    ref, port = _ladders(scorer)
    rng = np.random.default_rng(9)
    for level, threshold in ((1, 0.4), (2, 0.7)):
        _, alone = _services("fused", scorer, keep=0.2)
        alone.threshold = threshold
        ref.set_rung(level)
        port.set_rung(level)
        assert port.dense_stage is port._rungs[level].dense_stage
        for _ in range(2):
            X, mask = _batch(rng)
            top, scores = port.rank_batch(X, mask)
            a_top, a_scores = alone.rank_batch(X, mask)
            np.testing.assert_array_equal(scores, a_scores)
            np.testing.assert_array_equal(top, a_top)
            r_top, r_scores = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
            if scorer == "exact":
                np.testing.assert_array_equal(scores, np.asarray(r_scores))
            else:
                np.testing.assert_allclose(scores, np.asarray(r_scores), rtol=TOL, atol=TOL)
    port.set_rung(0)
    assert port.dense_stage is port._rungs[0].dense_stage


def test_warmup_leaves_no_first_touch_at_any_rung_dense_included():
    _, port = _ladders("mlp")
    buckets = ((1, 32), (2, 32), (4, 16))
    before = fs.first_touches()
    warmup_service(port, F, buckets)
    # One per row count: (2, 32) and (4, 16) both score 64 rows.
    assert fs.first_touches()["dense"] - before["dense"] == len({q * d for q, d in buckets})
    touched = fs.first_touches()
    rng = np.random.default_rng(4)
    for level in range(port.n_rungs):
        port.set_rung(level)
        for Qb, Db in buckets:
            X, mask = _batch(rng, Qb, Db)
            port.rank_batch(X, mask)
    assert fs.first_touches() == touched
    assert port.stats.overflow_docs == 0
