"""The port's NequIP against the JAX reference, on the CPU.

- ``so3``: the port's numpy copy gives the reference's spherical
  harmonics, Wigner-D matrices, Clebsch–Gordan tensors and paths, bit for
  bit (11 paths at ``l_max = 2``, output widths summing to 35).
- ``bessel_basis``, energies, forces (``−∂E/∂positions``), the loss with
  and without forces, and the gradient of every parameter (through the
  forces' double backward), float32, on batches shaped like the
  ``molecule``, ``full_graph_sm`` and ``minibatch_lg`` cells at smoke
  size, each padded with self-edges on a ghost node
  (``tests/nequip_parity.py``): within ``TOL`` = 1e-4 of each tensor's
  largest entry (the reference's own NequIP tolerance is 2e-4 relative,
  ``tests/test_property.py``; measured here: ~1e-6), and finite. Both
  ``premix_messages`` branches.
- Rotation equivariance of the port, as ``tests/test_property.py`` checks
  the reference, with its tolerances.
- ``sample_neighbors`` (``repro_torch.data``) samples the reference's
  block for the same graph and seed, bit for bit.
- The parameter converters round-trip; the train cells' steps at smoke
  size against the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nequip_parity import molecule_batch  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.data import graph_sampler as ref_sampler  # noqa: E402
from repro.models import nequip as rnq  # noqa: E402
from repro.models import so3 as ref_so3  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import CSRGraph, sample_neighbors  # noqa: E402
from repro_torch.models import nequip as pnq  # noqa: E402
from repro_torch.models import so3  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

TOL = 1e-4


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# so3.
# ---------------------------------------------------------------------------


def test_so3_tables_are_the_references():
    paths = so3.allowed_paths(2)
    assert paths == ref_so3.allowed_paths(2)
    assert len(paths) == 11 and sum(2 * l3 + 1 for *_, l3 in paths) == 35
    for l1, l2, l3 in paths:
        np.testing.assert_array_equal(so3.clebsch_gordan(l1, l2, l3),
                                      ref_so3.clebsch_gordan(l1, l2, l3))
    rng = np.random.default_rng(0)
    v = rng.normal(size=(17, 3))
    R = ref_so3._random_rotation(np.random.default_rng(1))
    np.testing.assert_array_equal(so3._random_rotation(np.random.default_rng(1)), R)
    for l in (0, 1, 2):
        np.testing.assert_array_equal(so3.real_sph_harm(v, l), ref_so3.real_sph_harm(v, l))
        np.testing.assert_array_equal(so3.wigner_d(R, l), ref_so3.wigner_d(R, l))
    with pytest.raises(ValueError, match="triangle"):
        so3.clebsch_gordan(0, 0, 2)


def test_torch_spherical_harmonics_equal_the_numpy_ones():
    v = np.random.default_rng(2).normal(size=(33, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for l in (0, 1, 2):
        np.testing.assert_allclose(pnq._sph(torch.as_tensor(v), l).numpy(),
                                   so3.real_sph_harm(v, l), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Energies, forces, loss and gradients.
# ---------------------------------------------------------------------------


def _configs(premix: bool = False):
    return tuple(dataclasses.replace(m.get_smoke_config("nequip"), premix_messages=premix)
                 for m in (ref_configs, port_configs))


@functools.lru_cache(maxsize=None)
def _params(d_feat: int):
    rcfg, pcfg = _configs()
    ref = jax.tree.map(np.asarray, rnq.init(rcfg, jax.random.key(d_feat), d_feat))
    return ref, pnq.nequip_params_from_numpy(pcfg, ref, "cpu")


def _graph_batch(kind: str, n_species: int) -> dict[str, np.ndarray]:
    """Smoke-size batches shaped like the cells, each with ghost padding:
    ``molecule`` (8 molecules of 30 atoms, 64 edges each, forces),
    ``full_graph_sm`` (one graph, node features, no graph ids) and
    ``minibatch_lg`` (a sampled block of a random graph in 16 graphs, node
    features, forces)."""
    if kind == "molecule":
        return molecule_batch(8, 30, 64, 256, 1024, n_species, seed=11)
    rng = np.random.default_rng(12)
    N, E, n_real, e_real = 256, 1024, 240, 900
    pos = np.zeros((N, 3), np.float32)
    pos[:n_real] = rng.normal(scale=2.0, size=(n_real, 3))
    src = np.full(E, N - 1, np.int32)
    dst = np.full(E, N - 1, np.int32)
    src[:e_real] = rng.integers(0, n_real, e_real)
    dst[:e_real] = rng.integers(0, n_real, e_real)
    batch = {"positions": pos, "species": rng.integers(0, n_species, N).astype(np.int32),
             "edge_src": src, "edge_dst": dst,
             "node_feat": rng.normal(size=(N, 12)).astype(np.float32)}
    if kind == "full_graph_sm":
        batch["energy"] = rng.normal(size=1).astype(np.float32)
        return batch
    batch["graph_id"] = np.sort(rng.integers(0, 16, N)).astype(np.int32)
    batch["energy"] = rng.normal(size=16).astype(np.float32)
    batch["forces"] = rng.normal(scale=0.1, size=(N, 3)).astype(np.float32)
    return batch


def test_bessel_basis_matches_reference():
    d = np.concatenate([[0.0, 1e-7, 1e-6], np.linspace(0.01, 6.0, 61)]).astype(np.float32)
    want = np.asarray(rnq.bessel_basis(jnp.asarray(d), 8, 5.0))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(rnq.bessel_basis(x, 8, 5.0) ** 2))(jnp.asarray(d)))
    t = torch.as_tensor(d).requires_grad_()
    got = pnq.bessel_basis(t, 8, 5.0)
    (got_g,) = torch.autograd.grad((got ** 2).sum(), t)
    assert _rel(got, want) <= TOL and _rel(got_g, want_g) <= TOL
    assert torch.isfinite(got_g).all()


@pytest.mark.parametrize("premix", [False, True])
@pytest.mark.parametrize("kind", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_energy_forces_loss_and_gradients_match_reference(kind, premix):
    rcfg, pcfg = _configs(premix)
    raw = _graph_batch(kind, pcfg.n_species)
    d_feat = raw["node_feat"].shape[1] if "node_feat" in raw else 0
    ref_params, params = _params(d_feat)
    with_forces = "forces" in raw
    n_graphs = raw["energy"].shape[0]
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.as_tensor(v) for k, v in raw.items()}

    def ref_energy(p, pos):
        return rnq.forward_energy(rcfg, p, pos, jb["species"], jb["edge_src"], jb["edge_dst"],
                                  jb.get("graph_id"), n_graphs, jb.get("node_feat"))

    # Jitted: eager JAX is several times slower here.
    want_e = jax.jit(ref_energy)(ref_params, jb["positions"])
    want_f = -jax.jit(jax.grad(lambda pos: ref_energy(ref_params, pos).sum()))(jb["positions"])
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: rnq.loss_fn(rcfg, p, jb, with_forces=with_forces)))(ref_params)
    got_e = pnq.forward_energy(pcfg, params, tb["positions"], tb["species"], tb["edge_src"],
                               tb["edge_dst"], tb.get("graph_id"), n_graphs, tb.get("node_feat"))
    got_f = pnq.forces(pcfg, params, tb)
    got_l, got_g = trainer._grads(functools.partial(pnq.loss_fn, pcfg, with_forces=with_forces),
                                  params, tb)
    errs = {"energy": _rel(got_e, want_e), "forces": _rel(got_f, want_f),
            "loss": _rel(got_l, want_l)}
    want_g = dict(tree_items(want_g))
    assert set(got_g) == set(want_g)
    errs.update({k: _rel(got_g[k], want_g[k]) for k in want_g})
    worst = max(errs, key=errs.get)
    print(f"{kind} premix={premix}: worst {worst} {errs[worst]:.3g}")
    assert errs[worst] <= TOL, (worst, errs[worst])
    for t in (got_e, got_f, got_l, *got_g.values()):
        assert torch.isfinite(t).all()
    # The ghost node (last) gathers every padding self-edge; its force is 0.
    np.testing.assert_array_equal(got_f[-1].numpy(), np.zeros(3, np.float32))


def test_premix_equals_mix_after_aggregate():
    """``premix_messages`` mixes each path per edge before the segment
    sum; by linearity the energies are those of mixing after it."""
    _, a = _configs(False)
    _, b = _configs(True)
    raw = _graph_batch("molecule", a.n_species)
    tb = {k: torch.as_tensor(v) for k, v in raw.items()}
    _, params = _params(0)
    ea, eb = (pnq.forward_energy(c, params, tb["positions"], tb["species"], tb["edge_src"],
                                 tb["edge_dst"], tb["graph_id"], 8) for c in (a, b))
    assert _rel(eb, ea) <= 1e-5


@pytest.mark.parametrize("seed", range(5))
def test_rotation_equivariance(seed):
    """As ``tests/test_property.py`` checks the reference: a random
    rotation leaves the energy (rtol 2e-4, atol 2e-5) and rotates the
    forces (rtol 2e-3, atol 2e-4)."""
    _, cfg = _configs()
    rng = np.random.default_rng(seed)
    N, E = 12, 30
    params = pnq.init(cfg, seed, device="cpu")
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    batch = {"species": torch.as_tensor(rng.integers(0, cfg.n_species, size=N).astype(np.int32)),
             "edge_src": torch.as_tensor(rng.integers(0, N, size=E).astype(np.int32)),
             "edge_dst": torch.as_tensor(rng.integers(0, N, size=E).astype(np.int32)),
             "energy": torch.zeros(1)}
    R = so3._random_rotation(rng).astype(np.float32)

    def energy(p):
        b = dict(batch, positions=torch.as_tensor(p))
        return float(pnq.forward_energy(cfg, params, b["positions"], b["species"], b["edge_src"],
                                        b["edge_dst"])[0]), pnq.forces(cfg, params, b).numpy()

    (e1, f1), (e2, f2) = energy(pos), energy(pos @ R.T)
    np.testing.assert_allclose(e1, e2, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(f1 @ R.T, f2, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# The train cells.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    ShapeSpec("molecule", "train", n_nodes=10, n_edges=20, graph_batch=8),
    ShapeSpec("full_graph_sm", "train", n_nodes=300, n_edges=900, d_feat=12),
    ShapeSpec("minibatch_lg", "train", n_nodes=10_240, n_edges=2_000, d_feat=6, graph_batch=16),
], ids=lambda s: s.name)
def test_train_cell_step_matches_reference(shape):
    """One AdamW step of each kind of NequIP cell (with forces where the
    shape batches graphs) on the synthesized inputs: loss and grad norm
    within ``TOL``, and the port's step on the reference's gradients
    within 1e-6 of the reference's state."""
    rcfg, pcfg = _configs()
    ref_shape = ref_configs.base.ShapeSpec(**dataclasses.asdict(shape))
    ref_cell, cell = ref_make_cell(rcfg, ref_shape), make_cell(pcfg, shape)
    from repro.models.synth import synthesize_inputs as ref_synth
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    raw = ref_synth(ref_cell, seed=3)
    got_raw = synthesize_inputs(cell, seed=3)
    assert list(got_raw) == list(raw)
    for k in raw:
        np.testing.assert_array_equal(got_raw[k], raw[k])
    ref_state = ref_cell.init_state(jax.random.key(0))
    params = pnq.nequip_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref_state.params), "cpu")
    from repro_torch.train.optimizer import get_optimizer

    state = trainer.init_state(params, get_optimizer(pcfg.optimizer))
    want_state, want_m = jax.jit(ref_cell.step)(ref_state, raw)
    got_state, got_m = cell.step(state, as_tensors(raw, "cpu"))
    assert _rel(got_m["loss"], want_m["loss"]) <= TOL
    assert _rel(got_m["grad_norm"], want_m["grad_norm"]) <= TOL
    ref_loss = functools.partial(rnq.loss_fn, rcfg, with_forces=bool(shape.graph_batch))
    ref_grads = dict(tree_items(jax.jit(jax.grad(ref_loss))(ref_state.params, raw)))
    own = trainer._grads
    trainer._grads = lambda loss_fn, p, b: (own(loss_fn, p, b)[0],
                                            {k: torch.tensor(np.asarray(ref_grads[k])) for k in p})
    try:
        inj_state, _ = cell.step(trainer.init_state(params, get_optimizer(pcfg.optimizer)),
                                 as_tensors(raw, "cpu"))
    finally:
        trainer._grads = own
    want = dict(tree_items(want_state))
    for k, t in tree_items(inj_state):
        assert _rel(t, want[k]) <= 1e-6, k
    assert all(torch.isfinite(t).all() for _, t in tree_items(got_state))


# ---------------------------------------------------------------------------
# The converters and the neighbor sampler.
# ---------------------------------------------------------------------------


def _logical(tree, prefix=""):
    """(path, axes) of a nested dict whose leaves are axis tuples."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        yield from _logical(v, path) if isinstance(v, dict) else [(path, tuple(v))]


@pytest.mark.parametrize("d_feat", [0, 7])
def test_param_converters_round_trip(d_feat):
    _, cfg = _configs()
    params = pnq.init(cfg, 5, device="cpu", d_feat=d_feat)
    tree = pnq.nequip_params_to_numpy(params)
    assert set(tree["layers"]["w_msg"]) == {0, 1, 2} and set(tree["layers"]["w_gate"]) == {1, 2}
    back = pnq.nequip_params_from_numpy(cfg, tree, "cpu")
    assert set(back) == set(params)
    for k, t in params.items():
        assert torch.equal(back[k], t), k
    ref = rnq.init(_configs()[0], jax.random.key(1), d_feat)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in tree_items(ref)}
    assert {k: (tuple(v.shape), "float32") for k, v in params.items()} == want
    assert pnq.param_logical(cfg, d_feat) == dict(_logical(rnq.param_logical(_configs()[0], d_feat)))
    bad = dict(tree, readout_w=np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="readout_w"):
        pnq.nequip_params_from_numpy(cfg, bad, "cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_neighbors_equals_the_reference(seed):
    g = CSRGraph.random(2000, 12, seed=seed)
    rg = ref_sampler.CSRGraph.random(2000, 12, seed=seed)
    np.testing.assert_array_equal(g.indptr, rg.indptr)
    np.testing.assert_array_equal(g.indices, rg.indices)
    seeds = np.random.default_rng(seed).integers(0, 2000, 64)
    got = sample_neighbors(g, seeds, (15, 10), seed=seed)
    want = ref_sampler.sample_neighbors(rg, seeds, (15, 10), seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["edge_src"].max() < len(got["nodes"]) and g.n_nodes == 2000
