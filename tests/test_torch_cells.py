"""The port's model cells against the reference's: ``make_cell`` for the
RecSys family, the LM and NequIP train cells and the paper's forest,
``synthesize_inputs``, and the serve/train launchers.

- **Meta shapes**: at every FULL config and published shape (the LM's
  ``train_4k``; its serving shapes are in ``tests/test_torch_lm.py``), the
  port's ``abstract_state()`` (tensors on the ``meta`` device, no memory;
  a train cell's whole ``TrainState``, optimizer state included) has the
  paths, shapes and dtypes of the reference's ``jax.eval_shape`` state,
  and its ``input_specs()`` those of the reference's. Every (config,
  shape) of the registry without a ``skip_reason`` builds.
- **Inputs**: ``synthesize_inputs`` draws bit-identical arrays in both
  packages for every cell and several seeds (NequIP's ``ogb_products`` at a
  hundredth of its size).
- **Forest cell**: the port's step (the forest kernel's plain version on
  the CPU) is held to the reference's (``score_bitvector``) at
  ``capacity_frac`` 0, > 0 and with ``sentinel2``: scores within 1e-5 and
  ``cont`` equal, except documents whose Continue probability lies within
  1e-5 of the threshold (the two scorers sum trees in other orders, C2).
- **Launchers**: ``python -m repro_torch.launch.serve|train`` run with
  ``--device cpu``, and without a card and without it they fail.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as ref_configs  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.models.synth import synthesize_inputs as ref_synth  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import forest_head, make_cell  # noqa: E402
from repro_torch.models.synth import as_tensors, synthesize_inputs  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ("qwen2.5-14b", "minitron-4b", "qwen3-4b", "deepseek-moe-16b",
            "llama4-maverick-400b-a17b")
CELL_ARCHS = ("dlrm-rm2", "deepfm", "din", "bert4rec", "lear-msn1", *LM_ARCHS, "nequip")
# The LM serving shapes are held in tests/test_torch_lm.py; here their train_4k.
FULL_CELLS = [
    (arch, shape.name)
    for arch in CELL_ARCHS for shape in ref_configs.get_config(arch).shapes
    if arch not in LM_ARCHS or shape.name == "train_4k"
]
_DTYPES = {torch.float32: "float32", torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
           torch.bfloat16: "bfloat16"}


def _shape(arch, name):
    return next(s for s in ref_configs.get_config(arch).shapes if s.name == name)


def _port_shape(ref_shape):
    return ShapeSpec(**dataclasses.asdict(ref_shape))


def _ref_flat(tree) -> dict[str, tuple[tuple[int, ...], str]]:
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in tree_items(tree)}


def _port_flat(tree) -> dict[str, tuple[tuple[int, ...], str]]:
    out = {}
    for k, v in tree_items(tree):
        assert v.device.type == "meta", k
        out[k] = (tuple(v.shape), _DTYPES[v.dtype])
    return out


# ---------------------------------------------------------------------------
# Meta shapes at the full configs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape_name", FULL_CELLS)
def test_abstract_state_has_the_reference_shapes(arch, shape_name):
    ref_shape = _shape(arch, shape_name)
    ref_cell = ref_make_cell(ref_configs.get_config(arch), ref_shape)
    cell = make_cell(port_configs.get_config(arch), _port_shape(ref_shape))
    want = _ref_flat(ref_cell.abstract_state())
    got = _port_flat(cell.abstract_state())
    if arch == "lear-msn1":
        # The reference's two uint32 mask lanes are one int64 in the port.
        for ens in ("ranker", "classifier"):
            lo = want.pop(f"{ens}/mask_lo")
            assert want.pop(f"{ens}/mask_hi") == lo
            want[f"{ens}/mask"] = (lo[0], "int64")
    assert got == want
    assert _port_flat(cell.input_specs()) == _ref_flat(ref_cell.input_specs())
    assert cell.input_logical() == ref_cell.input_logical()


@pytest.mark.parametrize("arch", ("dlrm-rm2", "deepfm", "din", "bert4rec"))
def test_state_logical_mirrors_the_reference(arch):
    shape = _shape(arch, "train_batch")
    ref_cell = ref_make_cell(ref_configs.get_smoke_config(arch), shape)
    cell = make_cell(port_configs.get_smoke_config(arch), _port_shape(shape))
    is_axes = lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)
    want = {
        "/".join(str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p)))) for p in path): tuple(v)
        for path, v in jax.tree_util.tree_flatten_with_path(ref_cell.state_logical(), is_leaf=is_axes)[0]
    }
    got = {k: tuple(v) for k, v in _logical_items(cell.state_logical())}
    assert got == want


def _logical_items(tree, prefix=""):
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _logical_items(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", port_configs.list_archs())
def test_every_registry_cell_builds(arch):
    """``make_cell`` returns a cell for every (config, shape) of the
    registry without a ``skip_reason``, its state and inputs on ``meta``."""
    cfg = port_configs.get_config(arch)
    shapes = [s for s in cfg.shapes if not s.skip_reason]
    assert shapes
    for shape in shapes:
        cell = make_cell(cfg, shape)
        for _, t in (*tree_items(cell.abstract_state()), *tree_items(cell.input_specs())):
            assert not isinstance(t, torch.Tensor) or t.device.type == "meta", (arch, shape.name)


# ---------------------------------------------------------------------------
# Synthesized inputs.
# ---------------------------------------------------------------------------

SYNTH_CELLS = [
    (arch, s.name, cfg)
    for arch in CELL_ARCHS for s in ref_configs.get_config(arch).shapes
    for cfg in ("smoke", "full")
    if not (cfg == "full" and s.name == "rank_xl")   # 142M normals: smoke config only
    and (arch not in LM_ARCHS or s.name == "train_4k")
    and not (arch == "nequip" and cfg == "full")      # NequIP's inputs depend on the shape only
]
# ogb_products' inputs would be 245M normals a package: drawn at a hundredth
# of its nodes and edges (the same branch: over 10,000 nodes, no graph batch).
SYNTH_CUTS = {("nequip", "ogb_products"): dict(n_nodes=24_491, n_edges=618_592)}


@pytest.mark.parametrize("arch,shape_name,which", SYNTH_CELLS)
def test_synthesized_inputs_are_bit_identical(arch, shape_name, which):
    get = "get_config" if which == "full" else "get_smoke_config"
    ref_shape = dataclasses.replace(_shape(arch, shape_name),
                                    **SYNTH_CUTS.get((arch, shape_name), {}))
    ref_cell = ref_make_cell(getattr(ref_configs, get)(arch), ref_shape)
    cell = make_cell(getattr(port_configs, get)(arch), _port_shape(ref_shape))
    for seed in (0, 1, 7) if which == "smoke" else (3,):
        want, got = ref_synth(ref_cell, seed=seed), synthesize_inputs(cell, seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The forest cell.
# ---------------------------------------------------------------------------

FOREST_CASES = {
    "reference": {},
    "capacity": {"capacity_frac": 0.3},
    "sentinel2": {"capacity_frac": 0.4, "sentinel2": 12, "capacity2_frac": 0.2},
}


@pytest.mark.parametrize("case", FOREST_CASES)
def test_forest_cell_equals_the_reference(case):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("lear-msn1"), **FOREST_CASES[case])
    cfg = dataclasses.replace(port_configs.get_smoke_config("lear-msn1"), **FOREST_CASES[case])
    ref_shape = ref_configs.base.ShapeSpec(name="q", kind="serve", batch=6)
    ref_cell = ref_make_cell(ref_cfg, ref_shape)
    cell = make_cell(cfg, _port_shape(ref_shape))
    key = jax.random.key(11)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))   # as the reference derives it
    ref_params = ref_cell.init_state(key)
    params = cell.init_state(seed, device="cpu")
    np.testing.assert_array_equal(params["ranker"].threshold.numpy(),
                                  np.asarray(ref_params["ranker"].threshold))
    step = jax.jit(ref_cell.step)
    for s in (0, 1, 2):
        inputs = ref_synth(ref_cell, seed=s)
        want_scores, want_cont = (np.asarray(a) for a in step(ref_params, inputs))
        ops.reset_launch_counts()
        scores, cont = cell.step(params, as_tensors(inputs, "cpu"))
        n_launches = 4 if case == "sentinel2" else 3
        assert ops.launch_counts()["plain"] == n_launches
        boundary = _boundary(cfg, params, inputs)
        ok = ~boundary
        np.testing.assert_array_equal(cont.numpy()[ok], want_cont[ok])
        # A compacted path re-selects survivors around a boundary document,
        # so its scores are held only where no document of the block is one.
        if case == "reference" or not boundary.any():
            np.testing.assert_allclose(scores.numpy()[ok], want_scores[ok], rtol=1e-5, atol=1e-5)


def _boundary(cfg, params, inputs, tol=1e-5):
    """Documents whose Continue probability is within ``tol`` of the
    threshold."""
    mask = torch.as_tensor(inputs["mask"])
    _, _, prob = forest_head(cfg, params, torch.as_tensor(inputs["X"]), mask)
    return (mask & ((prob - params["threshold"]).abs() <= tol)).numpy()


# ---------------------------------------------------------------------------
# Launchers.
# ---------------------------------------------------------------------------


def _launch(module, *args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout, check=False,
    )


def test_launchers_run_on_the_cpu(tmp_path):
    out = _launch("serve", "--arch", "dlrm-rm2", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("scored 32 requests") == 3
    out = _launch("serve", "--arch", "lear-msn1", "--device", "cpu", "--batches", "2")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("ranked 4 queries") == 2
    ckpt = str(tmp_path / "ckpt")
    args = ("--arch", "dlrm-rm2", "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "5")
    out = _launch("train", *args, "--steps", "10")
    assert out.returncode == 0, out.stderr
    assert "step   10  loss" in out.stdout and out.stdout.rstrip().endswith("done")
    out = _launch("train", *args, "--steps", "15")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 10" in out.stdout and "step   15  loss" in out.stdout
    out = _launch("train", "--arch", "lear-msn1", "--device", "cpu")
    assert out.returncode != 0 and "not trainable" in out.stderr


@pytest.mark.parametrize("arch", ["qwen3-4b", "nequip"])
def test_train_launcher_trains_and_resumes_the_lm_and_nequip_on_the_cpu(tmp_path, arch):
    """``launch.train`` for an LM (bfloat16 leaves in its checkpoints) and
    for NequIP (forces): 4 steps with checkpoints at 2 and 4, then 6 steps,
    which resume from 4."""
    ckpt = str(tmp_path / "ckpt")
    args = ("--arch", arch, "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2")
    out = _launch("train", *args, "--steps", "4")
    assert out.returncode == 0, out.stderr
    assert "resumed" not in out.stdout and out.stdout.rstrip().endswith("done")
    out = _launch("train", *args, "--steps", "6")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 4" in out.stdout and "step    5  loss" in out.stdout
    assert sorted(os.listdir(ckpt)) == [f"step_{s:010d}.{e}" for s in (2, 4, 6) for e in ("json", "npz")]


def test_launchers_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for module in ("serve", "train"):
        out = _launch(module, "--arch", "dlrm-rm2")
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr


def test_train_watchdog_never_retries_a_device_fault():
    from repro_torch.launch.train import is_device_fault

    for exc in (RuntimeError("CUDA error: an illegal memory access was encountered"),
                torch.cuda.OutOfMemoryError("out of memory"),
                RuntimeError("forest kernel launch failed: cudaError_t 700"),
                RuntimeError("repro_torch: building forest_score.cu failed"),
                OSError("libforest_score.so: cannot open shared object file")):
        assert is_device_fault(exc), exc
    assert not is_device_fault(ValueError("batch 63 is not a multiple of microbatch 4"))
    assert not is_device_fault(FloatingPointError("loss is nan"))
