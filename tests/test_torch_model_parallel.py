"""The train step on a ``(data, model)`` mesh: tensor and expert
parallelism over ``"model"`` for the LM family, in ``gloo`` processes.

- Mesh ``(2, 2)`` in four ranks under ``single_pod_rules`` (FSDP over
  ``"data"``: ``embed`` → "data"; ``ff``, ``qkv``, ``vocab``, ``experts``
  → "model"): Qwen3-4B and DeepSeek-MoE-16B smoke in float32, B 8,
  sequence 32, microbatch 4; Minitron-4B (3 query heads, 1 key/value
  head: the projections are gathered over "model") and
  Llama-4-Maverick (Adafactor's factored moments on sharded leaves; no
  microbatches, as its cell accumulates them in bfloat16). Their states
  are placed by ``remesh`` from ``state_logical()``; the step runs on
  those ``DTensor``\\ s. DLRM-RM2 (sparse rows) and a NequIP graph batch
  run on the same mesh with plain parameters, replicated over ``"model"``.
- Mesh ``(4, 2)`` in eight ranks: the reference's own case
  (``tests/test_distributed.py::test_8device_spmd_train_step``), its rule
  table (no FSDP), DeepSeek-MoE-16B smoke, B 8, sequence 32, microbatch 4.

- Mesh ``(2, 2)``, Qwen3-4B placed under ``single_pod_rules`` and stepped
  under another table: with ``ff`` and ``qkv`` unmapped, the step still
  computes on the shards the parameters hold (what is split over
  ``"model"`` is read from their placements); with ``"batch"`` over
  ``"model"`` too, it raises ``ValueError``. Leaves that disagree on a
  split (``ff`` sharded over ``"model"`` in one, whole in another) raise
  ``ValueError`` too (a fake group in a subprocess).

Every case takes the port's float32 parameters (seed 0) and a batch the
reference draws (``train_parity.case``, as ``test_torch_dp_train.py``), and
its loss must lie within ``F32_TOL`` of the reference's jitted one-device
step on them. Each case is held against the same step in one process (no
rules, plain tensors): loss and grad norm within 1e-6; every rank takes the identical
step (ranks that hold the same shard of a leaf hold the same bits after
it); each rank's local bytes of every parameter and optimizer entry equal
the shard its logical axes resolve to (no parameter is replicated behind
the rules' back); the gradients within 1e-5 of each leaf's max (the
tensor-parallel partial sums add rounding: 1.4e-6 seen); and every
updated parameter within 1e-6 of its leaf's max plus AdamW's first-step
term (C13). The families with plain parameters are bit-equal across
ranks and within 1e-6 of the one-process step.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import gloo_ranks  # noqa: E402
from lm_parity import F32_TOL  # noqa: E402
from train_parity import case  # noqa: E402

_RANK_PROG = r"""
import dataclasses, json, math, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec, TransformerConfig
from repro_torch.distributed import sharding_rules, single_pod_rules
from repro_torch.distributed.sharding import Rules
from repro_torch.launch.mesh import join_ranks
from repro_torch.models.api import make_cell
from repro_torch.train import trainer
from repro_torch.train.elastic import axis_sizes, logical_leaves, remesh
from repro_torch.train.optimizer import get_optimizer
from repro_torch.utils import tree_items
from gloo_ranks import digest

port, rank, world, path, shape = sys.argv[1:]
rank, world = int(rank), int(world)
join_ranks("127.0.0.1", int(port), rank, world)
dims = tuple(int(n) for n in shape.split("x"))
mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
# The reference's 8-device test's table (tests/test_distributed.py).
REF_TABLE = Rules(table={
    "batch": ("data",), "groups": ("data",), "edges": ("data",),
    "seq": None, "embed": None, "ff": "model", "qkv": "model",
    "vocab": "model", "heads": None, "kv_seq": None, "layers": None,
    "experts": "model", "expert_ff": None, "rows": "model",
    "cands": ("data", "model"), "nodes": None, "dense": None,
})
SINGLE = single_pod_rules()
TABLES = {
    "single_pod": SINGLE,
    "reference": REF_TABLE,
    "ff_qkv_off": Rules(table=dict(SINGLE.table, ff=None, qkv=None)),
    "batch_on_model": Rules(table=dict(SINGLE.table, batch=("data", "model"))),
}
seen = []
norm = trainer.optax_global_norm
trainer.optax_global_norm = lambda g: seen.append(g) or norm(g)
LR, EPS = 1e-3, 1e-8


def full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return (t.to_dense() if t.is_sparse else t).float()


def rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def shard_key(t):
    # The mesh coordinates that pick this rank's shard of a leaf.
    if not isinstance(t, DTensor):
        return "whole"
    coord = mesh.get_coordinate()
    return ",".join(str(c) if isinstance(p, Shard) else "*"
                    for c, p in zip(coord, t.placements))


def report(name, **out):
    with open(f"{path}/{name}/{shape}.{rank}.json", "w") as f:
        json.dump({"rank": rank, **out}, f)


sizes = axis_sizes(mesh)
for name, (arch, cell_shape, placed_by, step_by) in json.load(open(f"{path}/{shape}/manifest.json")).items():
    if step_by is None:   # a case of another mesh
        continue
    rules, step_rules = TABLES[placed_by], TABLES[step_by]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = isinstance(cfg, TransformerConfig)
    cell = make_cell(cfg, ShapeSpec(name="t", **cell_shape))
    flat = dict(np.load(f"{path}/{name}/params.npz"))
    batch = {k: torch.as_tensor(v) for k, v in np.load(f"{path}/{name}/batch.npz").items()}

    def init():
        params = {k: torch.tensor(v) for k, v in flat.items()}
        return trainer.init_state(params, get_optimizer(cfg.optimizer))

    state = remesh(init(), cell.state_logical(), rules, mesh) if lm else init()
    seen.clear()
    try:
        with sharding_rules(step_rules, mesh):
            new, m = cell.step(state, batch)
    except ValueError as e:
        report(name, error=str(e))
        continue
    one, one_m = cell.step(init(), batch)
    g_mp, g_one = seen
    excess, grad_rel = 0.0, 0.0
    for k, want in one.params.items():
        a, b = full(g_mp[k]), full(g_one[k])
        grad_rel = max(grad_rel, rel(a, b))
        gmin = torch.where(a.sign() == b.sign(), torch.minimum(a.abs(), b.abs()), 0.0)
        bound = LR * (a - b).abs() * EPS / (gmin + EPS) ** 2 + 1e-6 * want.abs().max()
        excess = max(excess, float(((full(new.params[k]) - want).abs() - bound).max()))
    local = want_bytes = total = 0
    for _, leaf, lg in logical_leaves(new, cell.state_logical()):
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        local += t.numel() * t.element_size()
        total += leaf.numel() * leaf.element_size()
        ways = math.prod(sizes[a] for e in rules.resolve(*lg)
                         for a in ((e,) if isinstance(e, str) else (e or ())))
        want_bytes += leaf.numel() * leaf.element_size() // (ways if lm else 1)
    report(name, loss=float(m["loss"]), one_loss=float(one_m["loss"]),
           norm=float(m["grad_norm"]), one_norm=float(one_m["grad_norm"]),
           grad_rel=grad_rel, param_excess=excess,
           dtensor=all(isinstance(v, DTensor) for v in new.params.values()),
           local_bytes=local, want_bytes=want_bytes, total_bytes=total,
           shards={f"{k}@{shard_key(t)}": digest([t]) for k, t in tree_items(new)},
           step=int(full(new.step)))
dist.destroy_process_group()
"""

LM = dict(kind="train", seq_len=32, global_batch=8, microbatch=4)
# name -> (arch, shape, mesh, the table that places the state, the table
# the step runs under).
CASES = {
    "qwen3-4b": ("qwen3-4b", LM, "2x2", "single_pod", "single_pod"),
    "deepseek-moe-16b": ("deepseek-moe-16b", LM, "2x2", "single_pod", "single_pod"),
    "minitron-4b": ("minitron-4b", LM, "2x2", "single_pod", "single_pod"),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", dict(LM, microbatch=0), "2x2",
                                  "single_pod", "single_pod"),
    "dlrm-rm2": ("dlrm-rm2", dict(kind="train", batch=16, microbatch=8), "2x2", "single_pod",
                 "single_pod"),
    "nequip": ("nequip", dict(kind="train", n_nodes=10, n_edges=20, graph_batch=8), "2x2",
               "single_pod", "single_pod"),
    "qwen3-4b ff_qkv_off": ("qwen3-4b", LM, "2x2", "single_pod", "ff_qkv_off"),
    "qwen3-4b batch_on_model": ("qwen3-4b", LM, "2x2", "single_pod", "batch_on_model"),
    "deepseek-moe-16b 4x2": ("deepseek-moe-16b", LM, "4x2", "reference", "reference"),
}
LM_2X2 = ("qwen3-4b", "deepseek-moe-16b", "minitron-4b", "llama4-maverick-400b-a17b")
MESH_2X2 = (*LM_2X2, "dlrm-rm2", "nequip")


def _world(shape: str) -> int:
    return math.prod(int(n) for n in shape.split("x"))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Per case: the reference's loss and the ranks' reports. Both meshes'
    ranks run while the reference's steps compile."""
    path = tmp_path_factory.mktemp("mp")
    built = {}   # one case for each arch and shape
    for name, (arch, shape, *_) in CASES.items():
        key = json.dumps([arch, shape])
        if key not in built:
            built[key] = case(arch, shape)
        built[key].save(path / name)
    procs = {}
    for shape in ("2x2", "4x2"):
        (path / shape).mkdir()
        with open(path / shape / "manifest.json", "w") as f:
            json.dump({name: (arch, cell_shape, placed, step if mesh == shape else None)
                       for name, (arch, cell_shape, mesh, placed, step) in CASES.items()}, f)
        procs[shape] = gloo_ranks.start(_RANK_PROG, _world(shape), str(path), shape)
    try:
        ref_loss = {key: c.reference_loss() for key, c in built.items()}
    finally:
        for p in procs.values():
            gloo_ranks.join(p)
    return {name: (ref_loss[json.dumps([arch, shape])],
                   [json.load(open(path / name / f"{mesh}.{r}.json")) for r in range(_world(mesh))])
            for name, (arch, shape, mesh, _, _) in CASES.items()}


def _hold(ref_loss: float, ranks: list, lm: bool) -> None:
    r0 = ranks[0]
    for r in ranks:   # the identical step on every rank
        assert (r["loss"], r["norm"], r["step"]) == (r0["loss"], r0["norm"], 1), r
    shards: dict[str, str] = {}
    for r in ranks:   # ranks holding the same shard hold the same bits
        for key, d in r["shards"].items():
            assert shards.setdefault(key, d) == d, key
    assert abs(r0["loss"] - r0["one_loss"]) <= 1e-6 * abs(r0["one_loss"]), r0
    assert abs(r0["norm"] - r0["one_norm"]) <= 1e-6 * abs(r0["one_norm"]), r0
    assert r0["param_excess"] <= 0.0, r0
    for r in ranks:
        assert r["local_bytes"] == r["want_bytes"], r
    if lm:
        assert r0["dtensor"], r0
        assert r0["grad_rel"] <= 1e-5, r0
    else:
        assert r0["grad_rel"] <= 1e-6, r0
    np.testing.assert_allclose(r0["loss"], ref_loss, rtol=F32_TOL)


@pytest.mark.parametrize("arch", MESH_2X2)
def test_step_on_a_2x2_mesh(arch, mesh_runs):
    _hold(*mesh_runs[arch], lm=arch in LM_2X2)


def test_lm_ranks_hold_a_fraction_of_the_state(mesh_runs):
    """FSDP over "data" and tensor/expert parallelism over "model": each of
    the four ranks holds under a third of an LM state's bytes."""
    for arch in LM_2X2:
        for r in mesh_runs[arch][1]:
            assert 3 * r["local_bytes"] < r["total_bytes"], (arch, r["local_bytes"])


def test_reference_4x2_case_in_eight_ranks(mesh_runs):
    """The reference's 8-device step: its bound is 1e-2 of the unsharded
    loss; the port holds 1e-6."""
    ref_loss, ranks = mesh_runs["deepseek-moe-16b 4x2"]
    _hold(ref_loss, ranks, lm=True)
    assert abs(ranks[0]["loss"] - ranks[0]["one_loss"]) < 1e-2


def test_step_under_another_table_than_the_placement(mesh_runs):
    """Placed with ``ff`` and ``qkv`` over "model", stepped with them
    unmapped: the MLP and the attention still compute on the shards the
    parameters hold and sum them (a step that read the table would skip
    the sums and return partial sums, of the right shape)."""
    _hold(*mesh_runs["qwen3-4b ff_qkv_off"], lm=True)


def test_batch_split_over_model_raises(mesh_runs):
    """A batch split over "model" too would give the tensor-parallel ranks
    different tokens: every rank refuses the step."""
    for r in mesh_runs["qwen3-4b batch_on_model"][1]:
        assert "batch is split over 'model'" in r["error"], r


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_lm_step_on_the_one_rank_mesh_is_the_plain_step(arch):
    """On ``make_local_mesh("cpu")`` every axis has one rank: two steps of
    a state placed by ``remesh`` are bit-equal to two plain steps (a
    ``"model"`` axis of one rank splits nothing, though its placements say
    ``Shard``)."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding_rules, single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh
    from repro_torch.utils import tree_items

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cell = make_cell(cfg, ShapeSpec(name="t", **LM))
    batch = as_tensors(synthesize_inputs(cell, seed=4), "cpu")
    mesh, rules = make_local_mesh("cpu"), single_pod_rules()

    def run(state, ruled):
        seen = []
        for _ in range(2):
            with sharding_rules(rules if ruled else None, mesh if ruled else None):
                state, m = cell.step(state, batch)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        return state, seen

    want, plain = run(cell.init_state(0, "cpu"), False)
    got, ruled = run(remesh(cell.init_state(0, "cpu"), cell.state_logical(), rules, mesh), True)
    assert ruled == plain
    want = dict(tree_items(want))
    for k, t in tree_items(got):
        assert isinstance(t, DTensor), k
        assert torch.equal(t.to_local(), want[k]), k


_AXIS_PROG = r"""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.distributed.parallel import ModelAxis
from repro_torch.launch import dryrun

logical = {"w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
with dryrun.fake_world(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def params(down):
        return {"w_up": DTensor.from_local(torch.zeros(4, 2), mesh, [Replicate(), Shard(1)]),
                "w_down": DTensor.from_local(torch.zeros(2, 4), mesh, [Replicate(), down])}

    tp = ModelAxis.of(params(Shard(0)), lambda: logical)
    print("SPLIT", sorted(tp.split), tp.size)
    try:
        ModelAxis.of(params(Replicate()), lambda: logical)
    except ValueError as e:
        print("RAISED", e)
"""


def test_parameters_that_disagree_on_a_split_raise():
    """``ff`` split over "model" in one leaf and whole in another: the
    MLP could neither sum nor skip the sum for both, so ``ModelAxis.of``
    refuses; where the leaves agree it reads ``ff`` as split (a fake
    (2, 2) group in a subprocess)."""
    res = subprocess.run(
        [sys.executable, "-c", _AXIS_PROG], capture_output=True, text=True, timeout=300,
        cwd=gloo_ranks.ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(gloo_ranks.ROOT, "src")),
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "SPLIT ['ff'] 2" in res.stdout, res.stdout
    assert "RAISED parameters disagree on ['ff'] over 'model'" in res.stdout, res.stdout
