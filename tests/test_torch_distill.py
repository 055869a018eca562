"""Port parity: AdamW and the dense scorer's distillation against the reference.

- one (and a few) AdamW steps on identical parameters and gradients equal
  ``repro.train.optimizer.adamw``'s within 1e-6;
- ``distill_dense_scorer`` started from the reference's ``jax.random``
  init (carried across by the converter) tracks the reference's run: the
  logged history, the folded parameters and the fit diagnostics within
  1e-4 relative;
- from the port's own init (a seeded ``torch.Generator``) it meets the
  reference test's quality bars (``tests/test_hybrid.py``);
- the teacher's row chunking changes no score, the loop reads the host only
  at logged steps, and the distilled scorer serves in the hybrid engine
  within the tolerance rule against the reference engine.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.models import dense_scorer as ref_dense  # noqa: E402
from repro.train import distill as ref_distill  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro_torch.core import cascade, stage, strategies  # noqa: E402
from repro_torch.models.dense_scorer import DenseScorer, dense_params_from_numpy  # noqa: E402
from repro_torch.train import distill, optimizer  # noqa: E402
from torch_parity import keep_boundary_docs, to_port  # noqa: E402

Q, D, F, T = 4, 24, 16, 60
SENTINELS = (10, 20, 35)


def _problem(seed):
    """The reference hybrid tests' problem (``strategy_harness.make_problem``)."""
    ens = ref_ensemble.random_ensemble(seed, n_trees=T, depth=4, n_features=F)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = rng.random((Q, D)) < 0.9
    return ens, X, mask


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-12), (got, want)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_reference(steps):
    rng = np.random.default_rng(steps)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in (("a", (5, 3)), ("b", (7,)))}
    grads = [
        {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        for _ in range(steps)
    ]
    ref_opt = ref_optimizer.adamw(lr=3e-3, weight_decay=1e-4)
    opt = optimizer.adamw(lr=3e-3, weight_decay=1e-4)
    rp = jax.tree.map(jnp.asarray, params)
    pp = {k: torch.tensor(v) for k, v in params.items()}
    rs, ps = ref_opt.init(rp), opt.init(pp)
    for g in grads:
        rp, rs = ref_opt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps = opt.update({k: torch.tensor(v) for k, v in g.items()}, ps, pp)
    assert int(ps["count"]) == int(rs["count"]) == steps and ps["count"].dtype == torch.int32
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ps["m"][k].numpy(), np.asarray(rs["m"][k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ps["v"][k].numpy(), np.asarray(rs["v"][k]), rtol=1e-6, atol=1e-7)


def test_distill_from_the_reference_init_tracks_the_reference():
    ens, X, mask = _problem(41)
    want = ref_distill.distill_dense_scorer(
        ens, jnp.asarray(X), jnp.asarray(mask), steps=50, lr=3e-3, seed=3, log_every=10
    )
    init = jax.tree.map(np.asarray, ref_dense.init_dense_scorer(jax.random.PRNGKey(3), F))
    got = distill.distill_dense_scorer(
        to_port(ens), X, mask, steps=50, lr=3e-3, log_every=10, init=init
    )
    assert [h["step"] for h in got.history] == [h["step"] for h in want.history]
    for g, w in zip(got.history, want.history, strict=True):
        for key in ("loss", "mse", "rank", "pair_accuracy"):
            _rel_close(g[key], w[key], 1e-4)
    for k, v in got.params.items():
        _rel_close(v.numpy(), want.params[k], 1e-4)
    _rel_close(got.teacher_rmse, want.teacher_rmse, 1e-4)
    _rel_close(got.pair_accuracy, want.pair_accuracy, 1e-4)
    # The folded scorer reads raw features and scores as the reference's.
    with torch.no_grad():
        s = got.scorer(torch.as_tensor(X.reshape(-1, F))).numpy()
    _rel_close(s, np.asarray(want.scorer(jnp.asarray(X.reshape(-1, F)))), 1e-4)


def test_port_init_meets_the_reference_quality_bars():
    ens, X, mask = _problem(41)
    port_ens = to_port(ens)
    out = distill.distill_dense_scorer(port_ens, X, mask, steps=150, lr=3e-3, seed=1, log_every=50)
    t = distill.teacher_scores(port_ens, torch.as_tensor(X)).numpy()[mask]
    assert out.teacher_rmse < 0.5 * t.std(), (out.teacher_rmse, t.std())
    assert out.pair_accuracy > 0.8, out.pair_accuracy
    assert [h["step"] for h in out.history] == [0, 50, 100, 149]
    assert out.history[-1]["loss"] < out.history[0]["loss"]
    assert isinstance(out.scorer, DenseScorer)


def test_teacher_chunks_change_no_score(monkeypatch):
    ens, X, _ = _problem(5)
    port_ens = to_port(ens)
    whole = distill.teacher_scores(port_ens, torch.as_tensor(X))
    monkeypatch.setattr(distill, "_TEACHER_CHUNK_ELEMS", 7 * T * 16)  # 7 rows a chunk
    np.testing.assert_array_equal(distill.teacher_scores(port_ens, torch.as_tensor(X)).numpy(),
                                  whole.numpy())
    ref = np.asarray(ref_distill.teacher_scores(ens, jnp.asarray(X)))
    np.testing.assert_allclose(whole.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_the_loop_reads_the_host_only_at_logged_steps(monkeypatch):
    ens, X, mask = _problem(6)
    port_ens = to_port(ens)
    calls = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _r=real, **k: calls.append(_n) or _r(self, *a, **k),
        )
    out = distill.distill_dense_scorer(port_ens, X, mask, steps=25, log_every=10)
    # Steps 0, 10, 20 and 24, then the final diagnostics: one read each.
    assert len(out.history) == 4
    assert calls.count("cpu") == 5 and calls.count("tolist") == 5
    assert set(calls) == {"cpu", "tolist"}, calls


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_distilled_scorer_in_the_hybrid_engine_follows_the_reference(mode):
    ens, X, mask = _problem(42)
    port_ens = to_port(ens)
    out = distill.distill_dense_scorer(port_ens, X, mask, steps=100, seed=2, log_every=0)
    params = {k: v.numpy() for k, v in out.params.items()}
    keep = functools.partial(strategies.dense_keep_fraction, keep_frac=0.5)
    ref_keep = functools.partial(ref_strategies.dense_keep_fraction, keep_frac=0.5)
    got = cascade.CascadeRanker(port_ens, 10, strategies.ept_continue).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        stage.EngineConfig.hybrid(
            stage.DenseStage(dense_params_from_numpy(params, "cpu"), keep), SENTINELS, mode=mode
        ),
        k_s=5, p=0.5,
    )
    want = ref_cascade.CascadeRanker(ens, 10, ref_strategies.ept_continue).rank_progressive(
        jnp.asarray(X), jnp.asarray(mask),
        ref_stage.EngineConfig.hybrid(
            ref_stage.DenseStage(
                ref_dense.make_dense_scorer(jax.tree.map(jnp.asarray, params)), ref_keep
            ),
            SENTINELS, mode=mode,
        ),
        k_s=5, p=0.5,
    )
    d_want = np.asarray(want.partials)[..., 0]
    np.testing.assert_allclose(got.partials[..., 0].numpy()[mask], d_want[mask],
                               rtol=1e-5, atol=1e-5)
    boundary = keep_boundary_docs(d_want, np.asarray(want.stage_masks[0]), mask, 1e-5)
    assert boundary.sum() == 0
    for g, w in zip(got.stage_masks, want.stage_masks, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-5)
