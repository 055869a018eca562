"""The train step on a ``(data, model)`` mesh, in ``gloo`` processes:
tensor and expert parallelism over ``"model"`` for the LM family, RecSys
tables split by rows over ``"model"``, NequIP's edges over every rank.

- Mesh ``(2, 2)`` in four ranks under ``single_pod_rules`` (FSDP over
  ``"data"``: ``embed`` → "data"; ``ff``, ``qkv``, ``vocab``, ``experts``
  → "model"): Qwen3-4B and DeepSeek-MoE-16B smoke in float32, B 8,
  sequence 32, microbatch 4; Minitron-4B (3 query heads, 1 key/value
  head: the projections are gathered over "model") and
  Llama-4-Maverick (Adafactor's factored moments on sharded leaves; no
  microbatches, as its cell accumulates them in bfloat16). Their states
  are placed by ``remesh`` from ``state_logical()``; the step runs on
  those ``DTensor``\\ s. DLRM-RM2 (row-wise Adagrad on sparse rows: every
  smoke table counts as row-wise here; also with bags of three ids, whose
  rows lie on both ranks, C17), DeepFM, DIN and BERT4Rec (its
  blocks tensor parallel over ``"qkv"`` and ``"ff"``, its tied softmax
  over the row-sharded ``item_embed``), placed the same way, step on
  their local shards: each rank holds half of every table's rows and of
  its row-wise state, and a table's sparse gradient holds exactly the
  one-program step's touched rows in the rank's range. A NequIP graph
  batch with forces splits its edges over the four ranks and its nodes
  over "data" (in float64 at 1e-6, also on ``(2, 1)`` and ``(1, 2)``
  meshes and on a ``(2, 2, 1)`` ``multi_pod`` mesh, nodes over "pod" and
  "data"; in float32 at NequIP's tolerance): each rank runs its share of
  the padded edges and of the nodes, and the forces loss's double
  backward crosses the ranks. 511 nodes, which two ranks do not divide,
  stay whole (the step with nodes unmapped, bit for bit); a planted
  node-side sum over "model" misses the bound; nodes over an axis that
  does not split the edges raise; the node gather and scatter alone are
  differentiated twice against one process.
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
term (C13). The RecSys and NequIP cases hold their gradients within 1e-6
of each leaf's max (a leaf whose gradient is rounding only, DIN's last
attention bias, is held by its update), NequIP's float32 case at 1e-4.
On the one-rank mesh the local-shard step is bit-equal to the plain one.
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
from repro_torch.distributed import multi_pod_rules, sharding_rules, single_pod_rules
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import Rules
from repro_torch.launch.mesh import join_ranks
from repro_torch.models import nequip
from repro_torch.models.api import make_cell
from repro_torch.train import optimizer, trainer
from repro_torch.train.elastic import axis_sizes, logical_leaves, remesh
from repro_torch.train.optimizer import get_optimizer
from repro_torch.utils import tree_items
from gloo_ranks import digest

port, rank, world, path, shape = sys.argv[1:]
rank, world = int(rank), int(world)
join_ranks("127.0.0.1", int(port), rank, world)
dims = tuple(int(n) for n in shape.split("x"))
mesh = init_device_mesh("cpu", dims, mesh_dim_names=("pod", "data", "model")[-len(dims):])
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
    "nodes_off": Rules(table=dict(SINGLE.table, nodes=None)),
    "nodes_not_edges": Rules(table=dict(SINGLE.table, edges=("data",), nodes=("model",))),
    "multi_pod": multi_pod_rules(),
}
seen = []
norm = trainer.optax_global_norm
trainer.optax_global_norm = lambda g, *a: seen.append(g) or norm(g, *a)
# Every smoke table row-wise (its padded 512 rows), so the row-wise state
# is placed and stepped too.
optimizer.ROWWISE_MIN_ROWS = 512
edges_seen = []   # the edges each NequIP energy of a step ran on
nodes_seen = []   # the node rows of its inputs and of its aggregates
energy = nequip.forward_energy


def spy_energy(cfg, p, pos, sp, src, dst, graph_id=None, *a, **k):
    edges_seen.append(int(src.shape[0]))
    nodes_seen.append(("inputs", int(pos.shape[0]), int(sp.shape[0]), int(graph_id.shape[0])))
    return energy(cfg, p, pos, sp, src, dst, graph_id, *a, **k)


nequip.forward_energy = spy_energy
scatter = parallel.NodeAxis.scatter_nodes


def spy_scatter(self, x):
    out = scatter(self, x)
    nodes_seen.append(("aggregate", int(out.shape[0])))
    return out


parallel.NodeAxis.scatter_nodes = spy_scatter
node_copy = parallel.NodeAxis.copy
# The planted fault: node-side parameters' gradients summed over every
# edge rank ("model" too), not over the node ranks alone.
FAULTS = {"model_sum": lambda self, x: parallel.edge_axis().copy(x)}
LR, EPS = 1e-3, 1e-8


def full(t, like=None):
    # A local shard (a local-shard step's gradient) goes whole through the
    # placements of ``like``.
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        t = t.to_dense() if t.is_sparse else t
        t = DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                               shape=like.shape, stride=like.stride())
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return (t.to_dense() if t.is_sparse else t).float()


def touched(g, like):
    # (this rank's touched rows at global indices, the row range it holds)
    # of a sparse local-shard gradient; (all rows, everything) otherwise.
    if not g.is_sparse:
        return None
    rows = g.coalesce().indices()[0]
    if not isinstance(like, DTensor) or not isinstance(like.placements[1], Shard):
        return rows.tolist(), (0, g.shape[0])
    lo = mesh.get_coordinate()[1] * g.shape[0]
    return (rows + lo).tolist(), (lo, lo + g.shape[0])


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
for name, (arch, cell_shape, placed_by, step_by, dtype, config, fault) in json.load(
        open(f"{path}/{shape}/manifest.json")).items():
    if step_by is None:   # a case of another mesh
        continue
    parallel.NodeAxis.copy = FAULTS[fault] if fault else node_copy
    rules, step_rules = TABLES[placed_by], TABLES[step_by]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **config)
    lm = isinstance(cfg, TransformerConfig)
    cell = make_cell(cfg, ShapeSpec(name="t", **cell_shape))
    flat = dict(np.load(f"{path}/{name}/params.npz"))
    batch = {k: torch.as_tensor(v) for k, v in np.load(f"{path}/{name}/batch.npz").items()}
    batch = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v
             for k, v in batch.items()}

    def init():
        params = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in flat.items()}
        return trainer.init_state(params, get_optimizer(cfg.optimizer))

    state = remesh(init(), cell.state_logical(), rules, mesh)
    seen.clear()
    edges_seen.clear()
    nodes_seen.clear()
    try:
        with sharding_rules(step_rules, mesh):
            new, m = cell.step(state, batch)
        n_edges = sorted(set(edges_seen))
        n_nodes = sorted(set(nodes_seen))
    except ValueError as e:
        report(name, error=str(e))
        continue
    parallel.NodeAxis.copy = node_copy
    one, one_m = cell.step(init(), batch)
    logical_axes = cell.state_logical().params
    g_mp, g_one = seen
    excess, grad_rel, rows_held = 0.0, 0.0, True
    # A leaf whose gradient is zero but for rounding (DIN's last attention
    # bias, which the softmax makes shift-invariant) is held by its update.
    top = max(float(full(g).abs().max()) for g in g_one.values())
    for k, want in one.params.items():
        a, b = full(g_mp[k], new.params[k]), full(g_one[k])
        held = float(b.abs().max()) >= 2**-23 * top
        mine = touched(g_mp[k], new.params[k])
        if mine is not None:
            lo, hi = mine[1]
            one_rows = g_one[k].coalesce().indices()[0]
            rows_held &= mine[0] == one_rows[(one_rows >= lo) & (one_rows < hi)].tolist()
        grad_rel = max(grad_rel, rel(a, b) if held else 0.0)
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
        want_bytes += leaf.numel() * leaf.element_size() // ways
    report(name, loss=float(m["loss"]), one_loss=float(one_m["loss"]),
           norm=float(m["grad_norm"]), one_norm=float(one_m["grad_norm"]),
           grad_rel=grad_rel, param_excess=excess, rows_held=rows_held,
           sparse=sorted(k for k, g in g_mp.items() if g.is_sparse),
           local_tables={k: [list(v.to_local().shape), list(v.shape)]
                         for k, v in new.params.items()
                         if (logical_axes[k] or (None,))[0] == "rows"},
           edges=n_edges, nodes=n_nodes,
           dtensor=all(isinstance(v, DTensor) for v in new.params.values()),
           local_bytes=local, want_bytes=want_bytes, total_bytes=total,
           shards={f"{k}@{shard_key(t)}": digest([t]) for k, t in tree_items(new)},
           step=int(full(new.step)))


# The node gather and scatter differentiated twice across the ranks, under
# each table of this mesh's NequIP cases, against the same function in one
# process: E = sum of squares of the node sums of messages m_e = (y_s . y_d) y_s
# over the edges, then L = |dE/dx|^2 and dL/dx.
def node_fn(x, src, dst):
    nx = parallel.node_axis()
    y = nx.gather_nodes(x)
    msg = (y[src] * y[dst]).sum(-1, keepdim=True) * y[src]
    agg = nx.scatter_nodes(torch.zeros_like(y).index_add(0, dst, msg))
    e = nx.reduce((agg * agg).sum()[None])[0]
    (g,) = torch.autograd.grad(e, x, create_graph=True)
    loss = nx.reduce((g * g).sum()[None])[0]
    (gg,) = torch.autograd.grad(loss, x)
    return e, g, loss, gg


gen = torch.Generator().manual_seed(7)
N, E = 16, 32
xw = torch.randn(N, 3, generator=gen, dtype=torch.float64)
src, dst = torch.randint(0, N, (2, E), generator=gen)
one = node_fn(xw.clone().requires_grad_(), src, dst)
steps = {step_by for _, _, _, step_by, *_ in json.load(
    open(f"{path}/{shape}/manifest.json")).values() if step_by is not None}
coll = {}
for table in sorted(steps & {"single_pod", "multi_pod"}):
    rules = TABLES[table]
    with sharding_rules(rules, mesh):
        eg, n_e, r_e = parallel.axis_groups("edges")
        ng, n_n, r_n = parallel.axis_groups("nodes")
    lo, hi = r_n * N // n_n, (r_n + 1) * N // n_n
    elo, ehi = r_e * E // n_e, (r_e + 1) * E // n_e
    x = xw[lo:hi].clone().requires_grad_()
    with parallel.edge_share(eg, n_e, r_e), parallel.node_share(ng, n_n, r_n):
        got = node_fn(x, src[elo:ehi], dst[elo:ehi])
    coll[table] = {"rows": int(got[1].shape[0]), "e": rel(got[0], one[0]),
                   "g": rel(got[1], one[1][lo:hi]), "loss": rel(got[2], one[2]),
                   "gg": rel(got[3], one[3][lo:hi])}
if coll:
    import os
    os.makedirs(f"{path}/collectives", exist_ok=True)
    with open(f"{path}/collectives/{shape}.{rank}.json", "w") as f:
        json.dump(coll, f)
dist.destroy_process_group()
"""

LM = dict(kind="train", seq_len=32, global_batch=8, microbatch=4)
RECSYS = dict(kind="train", batch=16, microbatch=8)
GRAPHS = dict(kind="train", n_nodes=10, n_edges=20, graph_batch=8)   # forces: a double backward
# name -> (arch, shape, mesh, the table that places the state, the table
# the step runs under).
CASES = {
    "qwen3-4b": ("qwen3-4b", LM, "2x2", "single_pod", "single_pod"),
    "deepseek-moe-16b": ("deepseek-moe-16b", LM, "2x2", "single_pod", "single_pod"),
    "minitron-4b": ("minitron-4b", LM, "2x2", "single_pod", "single_pod"),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", dict(LM, microbatch=0), "2x2",
                                  "single_pod", "single_pod"),
    "dlrm-rm2": ("dlrm-rm2", RECSYS, "2x2", "single_pod", "single_pod"),
    "dlrm-rm2 bags": ("dlrm-rm2", RECSYS, "2x2", "single_pod", "single_pod"),
    "deepfm": ("deepfm", dict(kind="train", batch=16), "2x2", "single_pod", "single_pod"),
    "din": ("din", dict(kind="train", batch=16), "2x2", "single_pod", "single_pod"),
    "bert4rec": ("bert4rec", RECSYS, "2x2", "single_pod", "single_pod"),
    "nequip": ("nequip", GRAPHS, "2x2", "single_pod", "single_pod"),
    "nequip f32": ("nequip", GRAPHS, "2x2", "single_pod", "single_pod"),
    "nequip 2x1": ("nequip", GRAPHS, "2x1", "single_pod", "single_pod"),
    "nequip 1x2": ("nequip", GRAPHS, "1x2", "single_pod", "single_pod"),
    "nequip multi_pod": ("nequip", GRAPHS, "2x2x1", "multi_pod", "multi_pod"),
    "nequip odd": ("nequip", GRAPHS, "2x2", "single_pod", "single_pod"),
    "nequip odd nodes_off": ("nequip", GRAPHS, "2x2", "single_pod", "nodes_off"),
    "nequip model_sum": ("nequip", GRAPHS, "2x2", "single_pod", "single_pod"),
    "nequip nodes_not_edges": ("nequip", GRAPHS, "2x2", "single_pod", "nodes_not_edges"),
    "qwen3-4b ff_qkv_off": ("qwen3-4b", LM, "2x2", "single_pod", "ff_qkv_off"),
    "qwen3-4b batch_on_model": ("qwen3-4b", LM, "2x2", "single_pod", "batch_on_model"),
    "deepseek-moe-16b 4x2": ("deepseek-moe-16b", LM, "4x2", "reference", "reference"),
}
# NequIP's forces in float32 are some 1e-5 of their max from the float64
# step on these molecules, so a change of summation order moves them by as
# much (ROADMAP C18): these cases run the float64 step, "nequip f32" is
# held at NequIP's stated tolerance (TOL of tests/test_torch_nequip.py).
FLOAT64 = ("nequip", "nequip 2x1", "nequip 1x2", "nequip multi_pod", "nequip odd",
           "nequip odd nodes_off", "nequip model_sum", "nequip nodes_not_edges")
# NequIP's node count where a case pads its graph batch to another than
# the cell's 512: 511 rows do not split over two "data" ranks.
PAD_NODES = {"nequip odd": 511, "nequip odd nodes_off": 511}
# A case's planted fault (the rank program's FAULTS).
FAULT = {"nequip model_sum": "model_sum"}
# The mesh of each NequIP float64 case with its node ranks (|N|).
NEQUIP_MESHES = {"2x2": ("nequip", 2), "2x1": ("nequip 2x1", 2), "1x2": ("nequip 1x2", 1),
                 "2x2x1": ("nequip multi_pod", 4)}
# Config fields a case changes (on both sides): bags of three ids, whose
# rows lie on both "model" ranks (ROADMAP C17).
CONFIG = {"dlrm-rm2 bags": {"multi_hot": 3}}
NEQUIP_TOL = 1e-4
LM_2X2 = ("qwen3-4b", "deepseek-moe-16b", "minitron-4b", "llama4-maverick-400b-a17b")
RECSYS_2X2 = ("dlrm-rm2", "dlrm-rm2 bags", "deepfm", "din", "bert4rec")
MESH_2X2 = (*LM_2X2, *RECSYS_2X2, "nequip")


def _world(shape: str) -> int:
    return math.prod(int(n) for n in shape.split("x"))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Per case: the reference's loss and the ranks' reports. Both meshes'
    ranks run while the reference's steps compile."""
    path = tmp_path_factory.mktemp("mp")
    built = {}   # one case for each arch, shape and batch

    def key(name, arch, shape):
        return json.dumps([arch, shape, CONFIG.get(name), PAD_NODES.get(name, 0)])

    for name, (arch, shape, *_) in CASES.items():
        k = key(name, arch, shape)
        if k not in built:
            built[k] = case(arch, shape, config=CONFIG.get(name),
                            pad_nodes=PAD_NODES.get(name, 0))
        built[k].save(path / name)
    procs = {}
    for shape in sorted({mesh for _, _, mesh, _, _ in CASES.values()}):
        (path / shape).mkdir()
        with open(path / shape / "manifest.json", "w") as f:
            json.dump({name: (arch, cell_shape, placed, step if mesh == shape else None,
                              "float64" if name in FLOAT64 else "float32", CONFIG.get(name, {}),
                              FAULT.get(name))
                       for name, (arch, cell_shape, mesh, placed, step) in CASES.items()}, f)
        procs[shape] = gloo_ranks.start(_RANK_PROG, _world(shape), str(path), shape)
    try:
        ref_loss = {k: c.reference_loss() for k, c in built.items()}
    finally:
        for p in procs.values():
            gloo_ranks.join(p)
    runs = {name: (ref_loss[key(name, arch, shape)],
                   [json.load(open(path / name / f"{mesh}.{r}.json")) for r in range(_world(mesh))])
            for name, (arch, shape, mesh, _, _) in CASES.items()}
    for mesh in NEQUIP_MESHES:
        runs[f"collectives {mesh}"] = [json.load(open(path / "collectives" / f"{mesh}.{r}.json"))
                                       for r in range(_world(mesh))]
    return runs


def _hold(ref_loss: float, ranks: list, lm: bool, tol: float = 1e-6) -> None:
    """``tol``: the loss, norm and gradients' bound against one process
    (the LM's gradients 1e-5)."""
    r0 = ranks[0]
    for r in ranks:   # the identical step on every rank
        assert (r["loss"], r["norm"], r["step"]) == (r0["loss"], r0["norm"], 1), r
    shards: dict[str, str] = {}
    for r in ranks:   # ranks holding the same shard hold the same bits
        for key, d in r["shards"].items():
            assert shards.setdefault(key, d) == d, key
    assert abs(r0["loss"] - r0["one_loss"]) <= tol * abs(r0["one_loss"]), r0
    assert abs(r0["norm"] - r0["one_norm"]) <= tol * abs(r0["one_norm"]), r0
    assert r0["param_excess"] <= 0.0, r0
    for r in ranks:
        assert r["local_bytes"] == r["want_bytes"], r
        assert r["rows_held"], r
    assert r0["dtensor"], r0
    assert r0["grad_rel"] <= (1e-5 if lm else tol), r0
    np.testing.assert_allclose(r0["loss"], ref_loss, rtol=F32_TOL)


@pytest.mark.parametrize("arch", MESH_2X2)
def test_step_on_a_2x2_mesh(arch, mesh_runs):
    _hold(*mesh_runs[arch], lm=arch in LM_2X2)


@pytest.mark.parametrize("arch", RECSYS_2X2)
def test_recsys_tables_are_split_by_rows_over_model(arch, mesh_runs):
    """Each rank holds half of every table's rows (and of its row-wise
    Adagrad state: ``local_bytes`` above); a table's sparse gradient holds
    exactly the one-program step's touched rows in this rank's range, at
    local indices (``rows_held``)."""
    _, ranks = mesh_runs[arch]
    for r in ranks:
        assert r["local_tables"], r
        for k, (local, whole) in r["local_tables"].items():
            assert local == [whole[0] // 2, *whole[1:]], (k, r["rank"])
    if arch.startswith("dlrm"):   # row-wise Adagrad: the tables' gradients are sparse rows
        assert ranks[0]["sparse"] == sorted(ranks[0]["local_tables"]), ranks[0]


@pytest.mark.parametrize("mesh", list(NEQUIP_MESHES))
def test_nequip_forces_step_with_edges_over_every_rank(mesh, mesh_runs):
    """NequIP's forces loss (a double backward through the node gathers
    and sums over the edge ranks) on 2 and 4 ranks, in float64: each rank
    runs its contiguous share of the padded edges and of the nodes
    (``single_pod``: nodes over "data", edges over both axes; ``2x2x1``
    under ``multi_pod``: nodes and edges over "pod" and "data"), and the
    step is within 1e-6 of one process, its parameter gradients included.
    A collective whose backward could not be differentiated would leave
    the other ranks' share out of them."""
    ref_loss, ranks = mesh_runs[NEQUIP_MESHES[mesh][0]]
    _hold(ref_loss, ranks, lm=False)
    n = len(ranks)
    edges = 512   # the GRAPHS batch's 160 edges padded to 512
    for r in ranks:
        assert r["edges"] == [edges // n], r


@pytest.mark.parametrize("mesh", list(NEQUIP_MESHES))
def test_nequip_node_arrays_and_aggregates_are_split_over_their_ranks(mesh, mesh_runs):
    """Each rank holds ``N/|N|`` rows of ``positions``, ``species`` and
    ``graph_id`` and of every per-layer aggregate (the GRAPHS batch's 80
    atoms padded to 512 nodes): |N| is the "data" ranks under
    ``single_pod`` (one on the 1 x 2 mesh, where the nodes stay whole),
    "pod" x "data" under ``multi_pod``."""
    name, n = NEQUIP_MESHES[mesh]
    rows = 512 // n
    for r in mesh_runs[name][1]:
        assert r["nodes"] == [["aggregate", rows], ["inputs", rows, rows, rows]], r["nodes"]


@pytest.mark.parametrize("mesh", list(NEQUIP_MESHES))
def test_node_gather_and_scatter_differentiate_twice_across_ranks(mesh, mesh_runs):
    """A node gather, per-edge messages on the rank's edges, a node
    scatter, a sum over the node ranks; its gradient by the node share
    (the gather's backward, a scatter) and that gradient's own gradient
    (the scatter's backward, a gather) on each rank equal one process's
    rows of them in float64."""
    n = NEQUIP_MESHES[mesh][1]
    for r in mesh_runs[f"collectives {mesh}"]:
        (got,) = r.values()
        assert got["rows"] == 16 // n, got
        for k in ("e", "g", "loss", "gg"):
            assert got[k] <= 1e-12, (k, got)


def test_nequip_node_count_the_ranks_do_not_divide_stays_whole(mesh_runs):
    """511 nodes over two "data" ranks: the nodes stay whole on every rank
    and the step is the one with nodes unmapped (the edges alone split),
    bit for bit, and within 1e-6 of one process."""
    ref_loss, ranks = mesh_runs["nequip odd"]
    _hold(ref_loss, ranks, lm=False)
    _, off = mesh_runs["nequip odd nodes_off"]
    for r, o in zip(ranks, off, strict=True):
        assert r["nodes"] == [["aggregate", 511], ["inputs", 511, 511, 511]], r["nodes"]
        assert r["edges"] == [128], r
        assert (r["loss"], r["norm"], r["shards"]) == (o["loss"], o["norm"], o["shards"])


def test_node_side_gradients_summed_over_model_fail_the_case(mesh_runs):
    """The planted fault: the node-side parameters enter through a copy
    over every edge rank, so their gradients are summed over "model" too
    (twice over on the 2 x 2 mesh), and the case misses its bound."""
    ref_loss, ranks = mesh_runs["nequip model_sum"]
    assert ranks[0]["grad_rel"] > 0.5, ranks[0]
    with pytest.raises(AssertionError):
        _hold(ref_loss, ranks, lm=False)


def test_nodes_over_an_axis_that_does_not_split_the_edges_raise(mesh_runs):
    """A table that splits the nodes over "model" and the edges over
    "data" alone: a rank's edges would reach node shares that no gather
    brings, so every rank refuses the step."""
    for r in mesh_runs["nequip nodes_not_edges"][1]:
        assert "must resolve to a subset" in r["error"], r


def test_nequip_float32_step_with_edges_over_every_rank(mesh_runs):
    """The same step in float32, held at NequIP's stated tolerance (1e-4):
    the one-process float32 step is itself ~1e-5 of its gradients' max
    from float64 on these molecules (C18)."""
    _hold(*mesh_runs["nequip f32"], lm=False, tol=NEQUIP_TOL)


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


@pytest.mark.parametrize("arch,shape", [
    ("dlrm-rm2", RECSYS), ("bert4rec", RECSYS), ("nequip", GRAPHS),
])
def test_local_shard_step_on_the_one_rank_mesh_is_the_plain_step(arch, shape):
    """On ``make_local_mesh("cpu")`` a RecSys or NequIP state placed by
    ``remesh`` steps on its local shards: a row-sharded lookup over one
    rank and an edge split over one rank are the identity, so two steps
    are bit-equal to two plain steps, every leaf back on its placements."""
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
    cell = make_cell(cfg, ShapeSpec(name="t", **shape))
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
    placed = remesh(cell.init_state(0, "cpu"), cell.state_logical(), rules, mesh,
                    src_data_rank=None)
    got, ruled = run(placed, True)
    assert ruled == plain
    want = dict(tree_items(want))
    for (k, t), (_, p) in zip(tree_items(got), tree_items(placed), strict=True):
        assert isinstance(t, DTensor) and t.placements == p.placements, k
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
