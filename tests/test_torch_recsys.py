"""The port's RecSys family and config registry against the reference.

The same numpy arrays go to both packages: the reference's parameters
(``repro.models.recsys.INIT`` from a JAX key) cross to the port through
``recsys_params_from_numpy``, the inputs are the reference's
``synthesize_inputs`` of a smoke cell. Forward, candidate scores and the
loss are held to the reference at rtol = atol = 1e-5, and so are the loss's
gradients: float32 GEMMs that sum in another order measured up to about
2e-7 here, well inside it.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as ref_configs  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.models.synth import synthesize_inputs as ref_synth  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

RECSYS = ("dlrm-rm2", "deepfm", "din", "bert4rec")
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------


def test_registry_lists_the_same_archs():
    assert port_configs.list_archs() == ref_configs.list_archs()
    assert port_configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", ref_configs.list_archs())
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_every_config_equals_the_reference(arch, which):
    want = dataclasses.asdict(getattr(ref_configs, which)(arch))
    got = dataclasses.asdict(getattr(port_configs, which)(arch))
    # The port's forest config carries one field of its own: the depth of
    # the classifier its LEAR training grows.
    extra = set(got) - set(want)
    assert extra <= {"classifier_depth"}, extra
    assert {k: got[k] for k in want} == want
    assert type(getattr(port_configs, which)(arch)).__name__ == type(
        getattr(ref_configs, which)(arch)).__name__


# ---------------------------------------------------------------------------
# The four families.
# ---------------------------------------------------------------------------


def _ref_params(cfg, seed=0):
    """Random weights in the reference's parameter tree (its ``INIT``'s
    structure and shapes, drawn with numpy: the reference's own init is
    slow on the CPU and is checked once, below)."""
    shapes = jax.eval_shape(lambda: ref_recsys.INIT[cfg.family](cfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _inputs(cfg, shape, seed=0):
    return ref_synth(ref_make_cell(cfg, shape), seed=seed)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


SERVE = RefShape(name="serve", kind="serve", batch=16)
TRAIN = RefShape(name="train", kind="train", batch=16)
CANDS = RefShape(name="cands", kind="serve", batch=1, n_candidates=700)


def test_converter_round_trip_keeps_the_reference_tree():
    for arch in RECSYS:
        cfg = ref_configs.get_smoke_config(arch)
        tree = _ref_params(cfg)
        params = recsys.recsys_params_from_numpy(cfg, tree, "cpu")
        back = recsys.recsys_params_to_numpy(cfg, params)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_converter_rejects_another_familys_tree():
    dlrm = ref_configs.get_smoke_config("dlrm-rm2")
    din = ref_configs.get_smoke_config("din")
    with pytest.raises(ValueError, match="parameter paths differ"):
        recsys.recsys_params_from_numpy(dlrm, _ref_params(din), "cpu")


@pytest.mark.parametrize("arch", RECSYS)
def test_init_shapes_and_scales_follow_the_reference(arch):
    cfg = port_configs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    got = recsys.INIT[cfg.family](cfg, gen, "cpu")
    ref_cfg = ref_configs.get_smoke_config(arch)
    want = jax.jit(lambda k: ref_recsys.INIT[ref_cfg.family](ref_cfg, k))(jax.random.key(0))
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32, k
        # Same distribution: constants equal, random draws of the same scale.
        if np.all(v == v.flat[0]):
            np.testing.assert_array_equal(got[k].numpy(), v)
        elif v.size >= 64:
            ratio = float(got[k].std()) / float(v.std())
            assert 0.7 < ratio < 1.4, (k, ratio)


@pytest.mark.parametrize("arch", RECSYS)
def test_forward_and_candidates_equal_the_reference(arch):
    cfg = ref_configs.get_smoke_config(arch)
    tree = _ref_params(cfg)
    params = recsys.recsys_params_from_numpy(cfg, tree, "cpu")
    pcfg = port_configs.get_smoke_config(arch)
    for seed in (0, 1):
        batch = _inputs(cfg, SERVE, seed)
        want = jax.jit(partial(ref_recsys.FORWARD[cfg.family], cfg))(tree, _j(batch))
        got = recsys.FORWARD[cfg.family](pcfg, params, _t(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        cands = _inputs(cfg, CANDS, seed)
        want = jax.jit(partial(ref_recsys.SCORE_CANDIDATES[cfg.family], cfg))(tree, _j(cands))
        got = recsys.SCORE_CANDIDATES[cfg.family](pcfg, params, _t(cands))
        assert got.shape == (1024,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_din_candidate_chunks_equal_one_sweep():
    cfg = port_configs.get_smoke_config("din")
    params = recsys.recsys_params_from_numpy(cfg, _ref_params(cfg), "cpu")
    batch = _t(_inputs(ref_configs.get_smoke_config("din"), CANDS))
    whole = recsys.din_score_candidates(cfg, params, batch)
    chunked = recsys.din_score_candidates(cfg, params, batch, chunk=300)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **TOL)


def _flat_grads(tree):
    return dict(tree_items(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("sparse_grad", [False, True])
def test_loss_and_gradients_equal_the_reference(arch, sparse_grad):
    cfg = ref_configs.get_smoke_config(arch)
    tree = _ref_params(cfg)
    pcfg = port_configs.get_smoke_config(arch)
    batch = _inputs(cfg, TRAIN, seed=3)
    want_loss, want_g = jax.jit(jax.value_and_grad(partial(ref_recsys.loss_fn, cfg)))(
        tree, _j(batch)
    )
    params = {
        k: v.requires_grad_()
        for k, v in recsys.recsys_params_from_numpy(pcfg, tree, "cpu").items()
    }
    loss = recsys.loss_fn(pcfg, params, _t(batch), sparse_grad=sparse_grad)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want_g = _flat_grads(want_g)
    for (k, _), g in zip(params.items(), grads):
        # A lookup's table gets sparse rows (BERT4Rec's table is also the
        # tied softmax's weight, so its gradient is dense).
        if sparse_grad and arch != "bert4rec" and k.startswith(("tables/", "table", "first_order", "item_")):
            assert g.is_sparse, k
        dense = g.to_dense() if g.is_sparse else g
        np.testing.assert_allclose(dense.numpy(), want_g[k], err_msg=k, **TOL)


def test_rms_norm_equals_the_reference():
    from repro.models.layers import rms_norm as ref_rms

    from repro_torch.models.layers import rms_norm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.as_tensor(x), torch.as_tensor(s)).numpy(),
        np.asarray(ref_rms(jax.numpy.asarray(x), jax.numpy.asarray(s))), **TOL,
    )


@pytest.mark.parametrize("n", [2, 5, 27])
def test_dot_interaction_is_the_reference_order(n):
    vecs = np.random.default_rng(n).normal(size=(4, n, 8)).astype(np.float32)
    want = np.asarray(ref_recsys._dot_interaction(jax.numpy.asarray(vecs)))
    got = recsys.dot_interact(torch.as_tensor(vecs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
