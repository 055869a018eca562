"""Port parity: logical-axis sharding, re-meshing and the data-parallel
train step against :mod:`repro.distributed` and :mod:`repro.train`.

- the three rule tables and every logical name's ``resolve`` equal the
  reference's (a one-axis tuple written as its name, as JAX writes it);
- ``constrain`` is the identity without rules and on a plain tensor, and
  redistributes a ``DTensor``;
- ``validate_divisibility`` finds the reference's problems on the same
  states at a 16 × 16 mesh (the reference reads only ``mesh.shape[a]``,
  so a stand-in object is its mesh; the port's reads names and sizes);
- ``remesh`` round-trips on ``make_local_mesh("cpu")``;
- the data-parallel train step in 4 ``gloo`` processes over an explicit
  ``TCPStore`` on 127.0.0.1 at mesh (4, 1) equals the one-process step
  in float32: the loss, the grad norm and every gradient the optimizer
  receives within 1e-6 (of each leaf's max), and every updated parameter
  within 1e-6 of its leaf's max plus what AdamW's first step makes of the
  gradients' rounding (``lr·|dg|·eps / (|g| + eps)²``: the step is
  ``lr·g / (|g| + eps)``, steep where ``|g|`` is near ``eps``); the MoE's
  loss also within the reference test's own 1e-2. Its loss equals the
  reference's one-program step at ``tests/lm_parity.py``'s tolerance.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from lm_parity import F32_TOL  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
import repro.distributed as ref_distributed  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.train import elastic as ref_elastic  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro.train.optimizer import get_optimizer as ref_get_optimizer  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import distributed  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("single_pod_rules", "multi_pod_rules", "local_rules")


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_and_every_resolve_equal_the_reference(table):
    port, ref = getattr(sharding, table)(), getattr(ref_sharding, table)()
    assert port.table == ref.table
    for name in ref.table:
        assert list(port.resolve(name, None)) == list(ref.resolve(name, None)), name
    assert list(port.resolve("batch", None, "ff")) == list(ref.resolve("batch", None, "ff"))
    with pytest.raises(KeyError):
        port.resolve("nonexistent")


def test_package_exports_the_reference_names():
    """``spec_to_placements`` in place of ``spec_to_sharding``."""
    want = set(ref_distributed.__all__) - {"spec_to_sharding"} | {"spec_to_placements"}
    assert set(distributed.__all__) == want
    assert all(hasattr(distributed, name) for name in want)


def test_resolve_and_constrain_without_rules():
    assert sharding.current_rules() is None and sharding.resolve("batch") == ()
    x = torch.ones(4, 4)
    assert sharding.constrain(x, "batch", None) is x
    with sharding.sharding_rules(sharding.single_pod_rules()):
        assert sharding.constrain(x, "batch", "ff") is x   # a plain tensor
        assert sharding.resolve("batch") == ("data",)
    assert sharding.current_rules() is None


def test_spec_to_placements_orders_and_checks_axes():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    rules = sharding.multi_pod_rules()
    assert sharding.spec_to_placements(mesh, rules.resolve("edges"), 1) == (Shard(0),) * 3
    assert sharding.spec_to_placements(mesh, rules.resolve("batch", None, "ff"), 3) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.spec_to_placements(mesh, rules.resolve(None, "expert_ff"), 2) == (
        Shard(1), Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.spec_to_placements(mesh, sharding.PartitionSpec(("model", "data")), 1)
    with pytest.raises(ValueError, match="twice"):
        sharding.spec_to_placements(mesh, sharding.PartitionSpec("data", "data"), 2)
    with pytest.raises(ValueError, match="more entries"):
        sharding.spec_to_placements(mesh, rules.resolve("batch", None), 1)


def test_constrain_redistributes_a_dtensor_on_the_local_mesh():
    mesh = make_local_mesh("cpu")
    d = elastic.remesh({"w": torch.arange(12.0).reshape(3, 4)}, {"w": ("batch", "ff")},
                       sharding.single_pod_rules(), mesh)["w"]
    assert tuple(d.placements) == (Shard(0), Shard(1))
    with sharding.sharding_rules(sharding.single_pod_rules(), mesh):
        assert sharding.current_mesh() is mesh
        y = sharding.constrain(d, None, "batch")
        assert tuple(y.placements) == (Shard(1), Replicate())
        assert sharding.constrain(y, None, "batch") is y
    assert torch.equal(y.full_tensor(), d.full_tensor())


def _norm(problems):
    """Problems with paths spelled ``/a/b`` (the port's flat keys hold the
    reference's nested path), sorted."""
    return sorted((re.sub(r"\['?([^'\]]*)'?\]", r"/\1", p), d, w) for p, d, w in problems)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b", "dlrm-rm2", "nequip"])
@pytest.mark.parametrize("table", ["single_pod_rules", "multi_pod_rules"])
def test_validate_divisibility_finds_the_reference_problems(arch, table):
    """Each arch's first cell's state (train state with optimizer entries
    for a train cell) and inputs at the production mesh."""
    multi = table == "multi_pod_rules"
    names, shape = ((("pod", "data", "model"), (2, 16, 16)) if multi
                    else (("data", "model"), (16, 16)))
    port_mesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    ref_mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    pcfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    pcell, rcell = make_cell(pcfg, pcfg.shapes[0]), ref_make_cell(rcfg, rcfg.shapes[0])
    prules, rrules = getattr(sharding, table)(), getattr(ref_sharding, table)()
    for what in ("params", "inputs"):
        if what == "params":
            pstate, plog = pcell.abstract_state(), pcell.state_logical()
            rstate, rlog = rcell.abstract_state(), rcell.state_logical()
            if hasattr(pstate, "params"):   # a train cell: its parameters
                pstate, plog, rstate, rlog = pstate.params, plog.params, rstate.params, rlog.params
        else:
            pstate, plog = pcell.input_specs(), pcell.input_logical()
            rstate, rlog = rcell.input_specs(), rcell.input_logical()
        got = elastic.validate_divisibility(pstate, plog, prules, port_mesh)
        want = ref_elastic.validate_divisibility(rstate, rlog, rrules, ref_mesh)
        assert _norm(got) == _norm(want), (what, got, want)


def test_validate_divisibility_spells_paths_as_keystr():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    tree = {"w": np.ones((8, 4), np.float32), "n": {"x": [np.ones((6, 32), np.float32)]}}
    logical = {"w": ("batch", "ff"), "n": {"x": [("ff", "batch")]}}
    ref_mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    want = ref_elastic.validate_divisibility(
        jax.tree.map(jnp.asarray, tree), logical, ref_sharding.single_pod_rules(), ref_mesh)
    got = elastic.validate_divisibility(tree, logical, sharding.single_pod_rules(), mesh)
    assert got == want == [("['n']['x'][0]", 6, 16), ("['w']", 8, 16), ("['w']", 4, 16)]
    with pytest.raises(ValueError, match="non-divisible"):
        elastic.remesh(tree, logical, sharding.single_pod_rules(), mesh)


def test_remesh_roundtrip_on_the_local_mesh():
    mesh = make_local_mesh("cpu")
    tree = {"w": torch.randn(8, 4), "b": np.zeros(4, np.float32),
            "h": torch.randn(6, 2).to(torch.bfloat16)}
    logical = {"w": ("embed", "ff"), "b": (None,), "h": ("batch", None)}
    out = elastic.remesh(tree, logical, sharding.single_pod_rules(), mesh)
    assert tuple(out["w"].placements) == (Shard(0), Shard(1))
    assert tuple(out["b"].placements) == (Replicate(), Replicate())
    for k, v in tree.items():
        assert torch.equal(out[k].full_tensor(), torch.as_tensor(v)), k
    local = elastic.remesh(tree, logical, sharding.local_rules(), mesh)
    assert all(p == Replicate() for t in local.values() for p in t.placements)


# ---------------------------------------------------------------------------
# The data-parallel train step in four gloo processes.
# ---------------------------------------------------------------------------

WORLD = 4
B, S, MICRO = 8, 32, 4

_RANK_PROG = r"""
import dataclasses, json, sys
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding_rules, single_pod_rules
from repro_torch.launch.mesh import join_ranks
from repro_torch.models.api import make_cell
from repro_torch.models.transformer import transformer_params_from_numpy
from repro_torch.train import trainer
from repro_torch.train.optimizer import get_optimizer

port, rank, world, archs, path, B, S, MICRO = sys.argv[1:]
rank, world, B, S, MICRO = int(rank), int(world), int(B), int(S), int(MICRO)
join_ranks("127.0.0.1", int(port), rank, world)
mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
seen = []   # the gradients each step hands its norm, clip and optimizer
norm = trainer.optax_global_norm
trainer.optax_global_norm = lambda g: seen.append(g) or norm(g)
LR, EPS = 1e-3, 1e-8


def rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


for arch in archs.split(","):
    d = f"{path}/{arch}"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cell = make_cell(cfg, ShapeSpec(name="t", kind="train", seq_len=S, global_batch=B,
                                    microbatch=MICRO))
    arrays = dict(np.load(d + "/params.npz"))
    batch = {k: torch.as_tensor(v) for k, v in np.load(d + "/batch.npz").items()}

    def state():
        nested = {}
        for key, a in arrays.items():
            node = nested
            *parents, last = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = a
        params = transformer_params_from_numpy(cfg, nested, "cpu")
        return trainer.init_state(params, get_optimizer(cfg.optimizer))

    seen.clear()
    with sharding_rules(single_pod_rules(), mesh):
        dp_state, dp_m = cell.step(state(), batch)
    one_state, one_m = cell.step(state(), batch)
    (g_dp, g_one), p0 = seen, state().params
    # AdamW's first step moves an entry by lr * g / (|g| + eps): rounding in
    # g moves it by up to lr * |dg| * eps / (|g| + eps)^2 (|g| the smaller
    # of the two, 0 across a sign change), which is large where |g| ~ eps.
    # Each updated entry must lie within that, plus 1e-6 of its leaf's max.
    excess = 0.0
    for k, want in one_state.params.items():
        a, b = g_dp[k], g_one[k]
        gmin = torch.where(a.sign() == b.sign(), torch.minimum(a.abs(), b.abs()), 0.0)
        bound = LR * (a - b).abs() * EPS / (gmin + EPS) ** 2 + 1e-6 * want.abs().max()
        excess = max(excess, float(((dp_state.params[k] - want).abs() - bound).max()))
    out = {"rank": rank, "dp_loss": float(dp_m["loss"]), "one_loss": float(one_m["loss"]),
           "dp_norm": float(dp_m["grad_norm"]), "one_norm": float(one_m["grad_norm"]),
           "grad_rel": max(rel(g_dp[k], g_one[k]) for k in g_one),
           "param_rel": max(rel(dp_state.params[k], v) for k, v in one_state.params.items()),
           "param_excess": excess, "moved": max(rel(one_state.params[k], p0[k]) for k in p0),
           "step": int(dp_state.step)}
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ARCHS = ("qwen3-4b", "deepseek-moe-16b")


def _run_ranks(path: str) -> None:
    """Four ranks, each stepping every arch of ``ARCHS`` once with the
    rules and once alone; rank r writes ``<path>/<arch>/rank<r>.json``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROG, str(port), str(r), str(WORLD), ",".join(ARCHS),
             path, str(B), str(S), str(MICRO)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs, strict=True)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    """Per arch: the reference's float32 smoke parameters (key 0) and a
    batch, handed to the four ranks as numpy files; then the ranks' reports."""
    path = tmp_path_factory.mktemp("gloo")
    inputs = {}
    for arch in ARCHS:
        rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype="float32")
        ref_params = jax.jit(lambda key, rcfg=rcfg: rtfm.init(rcfg, key))(jax.random.key(0))
        flat = {k: np.asarray(v) for k, v in tree_items(jax.tree.map(np.asarray, ref_params))}
        (path / arch).mkdir()
        np.savez(path / arch / "params.npz", **flat)
        rng = np.random.default_rng(5)
        batch = {k: rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        np.savez(path / arch / "batch.npz", **batch)
        inputs[arch] = (rcfg, ref_params, batch)
    _run_ranks(str(path))
    return {arch: (*inputs[arch], [json.load(open(path / arch / f"rank{r}.json"))
                                   for r in range(WORLD)]) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_train_step_in_four_gloo_ranks(arch, gloo_steps):
    """Mesh (4, 1): each rank takes 1/4 of every microbatch of 4 (one
    sequence, so each MoE dispatch group stays whole); gradients averaged
    with all_reduce. Against the one-process step and the reference's."""
    rcfg, ref_params, batch, ranks = gloo_steps[arch]
    for r in ranks:   # every rank took the same step
        assert r["dp_loss"] == ranks[0]["dp_loss"] and r["step"] == 1
    r0 = ranks[0]
    assert abs(r0["dp_loss"] - r0["one_loss"]) <= 1e-6 * abs(r0["one_loss"]), r0
    assert abs(r0["dp_norm"] - r0["one_norm"]) <= 1e-6 * abs(r0["one_norm"]), r0
    assert r0["grad_rel"] <= 1e-6, r0        # what the all-reduce averaged
    assert r0["param_excess"] <= 0.0, r0     # the updated parameters (see _RANK_PROG)
    assert r0["moved"] > 1e-3, r0            # and the step did move them
    if arch == "deepseek-moe-16b":   # the reference's own 8-device test's bound
        assert abs(r0["dp_loss"] - r0["one_loss"]) < 1e-2
    ref_shape = ref_configs.base.ShapeSpec(name="t", kind="train", seq_len=S, global_batch=B,
                                           microbatch=MICRO)
    ref_cell = ref_make_cell(rcfg, ref_shape)
    ref_state = ref_trainer.init_state(ref_params, ref_get_optimizer(rcfg.optimizer))
    _, ref_m = jax.jit(ref_cell.step)(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(r0["dp_loss"], float(ref_m["loss"]), rtol=F32_TOL)
