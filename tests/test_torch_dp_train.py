"""Port parity: the data-parallel train step for every trainable arch of
the registry, in four ``gloo`` processes, against the one-process step
and the reference's.

- One launch of four ranks (mesh ``(4, 1)``, ``single_pod_rules``,
  ``join_ranks`` on 127.0.0.1) steps every case below twice: under the
  rules (the batch split over the ranks) and alone (the whole batch).
- Every case is a smoke config in float32 with the port's parameters
  (seed 0; the reference's step gets them through the converters) and the
  reference's inputs (its ``synthesize_inputs``). Each rank reports the
  loss, the grad norm, the gradients the step hands its norm and
  optimizer, and a digest of its new state. The test holds: every rank's
  digest (and sparse gradient) bit-equal; loss and grad norm within 1e-6
  of the one-process step's; every gradient within 1e-6 of its leaf's max
  (a leaf whose gradient is zero but for rounding, its max below float32's
  epsilon times the largest leaf's, is held by its update alone: DIN's
  last attention bias, which the softmax makes shift-invariant, has
  2e-11 against 0.4); every updated parameter within 1e-6 of its leaf's max
  plus what the first step of a sign-like optimizer makes of the
  gradients' rounding (C13: ``lr·|dg|·eps / (|g| + eps)²``); the loss
  within ``F32_TOL`` of the reference's step on the same parameters and
  batch.
- BERT4Rec runs with an even mask (three masked positions a row) and an
  uneven one (C14: each microbatch's first half of rows fully masked, the
  second one position each, so the ranks' counts differ). NequIP runs a
  graph batch (``molecule``, forces) and a single graph
  (``full_graph_sm``): no input is split (C15), so every rank runs the
  whole step and the result is bit-equal to the one-process step.
- Llama-4-Maverick's cell (Adafactor) accumulates microbatch gradients in
  bfloat16, as the reference's, so its case takes no microbatches: the
  1e-6 bounds hold float32 arithmetic.
- ``reduce_sparse_rows`` in one process on the parts of a split batch
  equals the one-process sparse gradient.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gloo_ranks  # noqa: E402
from lm_parity import F32_TOL  # noqa: E402
from train_parity import case  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.optimizer import ROWWISE_MIN_ROWS  # noqa: E402

WORLD = 4
LM = dict(kind="train", seq_len=32, global_batch=8, microbatch=4)
RECSYS = dict(kind="train", batch=16)
# name -> (arch, shape, mask): the ten trainable archs of the registry.
CASES = {
    "qwen3-4b": ("qwen3-4b", LM, None),
    "deepseek-moe-16b": ("deepseek-moe-16b", LM, None),
    "qwen2.5-14b": ("qwen2.5-14b", LM, None),
    "minitron-4b": ("minitron-4b", LM, None),
    "llama4-maverick": ("llama4-maverick-400b-a17b", dict(LM, microbatch=0), None),
    "dlrm-rm2": ("dlrm-rm2", dict(RECSYS, microbatch=8), None),
    "deepfm": ("deepfm", RECSYS, None),
    "din": ("din", RECSYS, None),
    "bert4rec-even": ("bert4rec", dict(RECSYS, microbatch=8), "even"),
    "bert4rec-uneven": ("bert4rec", dict(RECSYS, microbatch=8), "uneven"),
    "nequip-graphs": ("nequip", dict(kind="train", n_nodes=10, n_edges=20, graph_batch=8), None),
    "nequip-graph": ("nequip", dict(kind="train", n_nodes=300, n_edges=900, d_feat=12), None),
}

_RANK_PROG = r"""
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding_rules, single_pod_rules
from repro_torch.launch.mesh import join_ranks
from repro_torch.models.api import make_cell
from repro_torch.train import trainer
from repro_torch.train.optimizer import get_optimizer
from repro_torch.utils import tree_items
from gloo_ranks import digest

port, rank, world, path = sys.argv[1:]
rank, world = int(rank), int(world)
join_ranks("127.0.0.1", int(port), rank, world)
mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
seen = []   # the gradients each step hands its norm, clip and optimizer
norm = trainer.optax_global_norm
trainer.optax_global_norm = lambda g: seen.append(g) or norm(g)
LR, EPS = 1e-3, 1e-8
manifest = json.load(open(path + "/manifest.json"))


def dense(g):
    return (g.to_dense() if g.is_sparse else g).float()


def rel(a, b):
    a, b = dense(a), dense(b)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


for name, (arch, shape) in manifest.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cell = make_cell(cfg, ShapeSpec(name="t", **shape))
    flat = dict(np.load(f"{path}/{name}/params.npz"))
    batch = {k: torch.as_tensor(v) for k, v in np.load(f"{path}/{name}/batch.npz").items()}

    def state():
        params = {k: torch.tensor(v) for k, v in flat.items()}
        return trainer.init_state(params, get_optimizer(cfg.optimizer))

    seen.clear()
    with sharding_rules(single_pod_rules(), mesh):
        dp_state, dp_m = cell.step(state(), batch)
    one_state, one_m = cell.step(state(), batch)
    (g_dp, g_one), p0 = seen, state().params
    # A sign-like first step (AdamW, Adagrad) moves an entry by about
    # lr * g / (|g| + eps): rounding in g moves it by up to
    # lr * |dg| * eps / (|g| + eps)^2 (|g| the smaller of the two, 0 across
    # a sign change). Each updated entry must lie within that, plus 1e-6 of
    # its leaf's max.
    excess = 0.0
    for k, want in one_state.params.items():
        a, b = dense(g_dp[k]), dense(g_one[k])
        gmin = torch.where(a.sign() == b.sign(), torch.minimum(a.abs(), b.abs()), 0.0)
        bound = LR * (a - b).abs() * EPS / (gmin + EPS) ** 2 + 1e-6 * want.abs().max()
        excess = max(excess, float(((dp_state.params[k] - want).abs() - bound).max()))
    top = max(float(dense(g).abs().max()) for g in g_one.values())
    held = [k for k, g in g_one.items() if float(dense(g).abs().max()) >= 2**-23 * top]
    out = {"rank": rank, "dp_loss": float(dp_m["loss"]), "one_loss": float(one_m["loss"]),
           "dp_norm": float(dp_m["grad_norm"]), "one_norm": float(one_m["grad_norm"]),
           "grad_rel": max(rel(g_dp[k], g_one[k]) for k in held),
           "rounding_only": sorted(set(g_one) - set(held)),
           "param_rel": max(rel(dp_state.params[k], v) for k, v in one_state.params.items()),
           "param_excess": excess, "moved": max(rel(one_state.params[k], p0[k]) for k in p0),
           "state_digest": digest([t for _, t in tree_items(dp_state)]),
           "one_digest": digest([t for _, t in tree_items(one_state)]),
           "sparse": sorted(k for k, g in g_dp.items() if g.is_sparse),
           "sparse_digest": digest([g for g in g_dp.values() if g.is_sparse]),
           "step": int(dp_state.step)}
    with open(f"{path}/{name}/rank{rank}.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """Per case: the reference's loss on the same parameters and batch,
    and the four ranks' reports. The ranks run while the reference's steps
    compile."""
    path = tmp_path_factory.mktemp("dp")
    cases = {name: case(arch, shape, mask) for name, (arch, shape, mask) in CASES.items()}
    for name, c in cases.items():
        c.save(path / name)
    with open(path / "manifest.json", "w") as f:
        json.dump({name: (arch, shape) for name, (arch, shape, _) in CASES.items()}, f)
    procs = gloo_ranks.start(_RANK_PROG, WORLD, str(path))
    try:
        ref_loss = {name: c.reference_loss() for name, c in cases.items()}
    finally:
        gloo_ranks.join(procs)
    return {name: (ref_loss[name], [json.load(open(path / name / f"rank{r}.json"))
                                    for r in range(WORLD)]) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_of_every_trainable_arch(name, dp_steps):
    ref_loss, ranks = dp_steps[name]
    r0 = ranks[0]
    for r in ranks:   # every rank took the identical step
        assert r["step"] == 1
        assert (r["dp_loss"], r["dp_norm"], r["state_digest"], r["sparse_digest"]) == (
            r0["dp_loss"], r0["dp_norm"], r0["state_digest"], r0["sparse_digest"]), r
    assert abs(r0["dp_loss"] - r0["one_loss"]) <= 1e-6 * abs(r0["one_loss"]), r0
    assert abs(r0["dp_norm"] - r0["one_norm"]) <= 1e-6 * abs(r0["one_norm"]), r0
    assert r0["grad_rel"] <= 1e-6, r0        # what the ranks reduced
    assert r0["param_excess"] <= 0.0, r0     # the updated parameters (see _RANK_PROG)
    assert r0["moved"] > 1e-4, r0            # and the step did move them
    if name.startswith("nequip"):   # no input is split: the one-process step, bit for bit
        assert r0["state_digest"] == r0["one_digest"], r0
        assert r0["dp_loss"] == r0["one_loss"] and r0["dp_norm"] == r0["one_norm"]
    if name == "dlrm-rm2":   # sparse table gradients, reduced as rows
        assert r0["sparse"], r0
    np.testing.assert_allclose(r0["dp_loss"], ref_loss, rtol=F32_TOL)


def test_uneven_mask_loss_is_the_whole_batch_quotient(dp_steps):
    """C14: the uneven mask gives the ranks different masked counts; the
    step's loss is still the one-process loss (the parent averaged the
    ranks' own quotients: a different loss and gradient)."""
    _, ranks = dp_steps["bert4rec-uneven"]
    r0 = ranks[0]
    assert abs(r0["dp_loss"] - r0["one_loss"]) <= 1e-6 * abs(r0["one_loss"])
    assert abs(r0["dp_norm"] - r0["one_norm"]) <= 1e-6 * abs(r0["one_norm"])


def test_graph_batch_runs_whole_on_every_rank(dp_steps):
    """C15: NequIP's inputs have no "batch" axis; the parent cut every
    input by the first one's rows and raised ``IndexError``."""
    for name in ("nequip-graphs", "nequip-graph"):
        _, ranks = dp_steps[name]
        assert all(r["state_digest"] == ranks[0]["one_digest"] for r in ranks), name


# ---------------------------------------------------------------------------
# The sparse-row reduction in one process.
# ---------------------------------------------------------------------------


def _sparse_loss(params, batch):
    v = torch.nn.functional.embedding(batch["ids"], params["t"], sparse=True)
    return (v.sum(-1) * batch["y"]).mean()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_reduce_sparse_rows_equals_the_one_process_gradient(n):
    """Each of ``n`` shares of a batch gives a coalesced sparse gradient of
    its mean loss; their reduction equals the whole batch's gradient within
    1e-6 and is the same bits for the same parts."""
    g = torch.Generator().manual_seed(n)
    rows = ROWWISE_MIN_ROWS
    batch = {"ids": torch.randint(0, 64, (64, 3), generator=g),
             "y": torch.randn(64, 3, generator=g)}
    params = {"t": torch.randn(rows, 8, generator=g)}
    _, whole = trainer._grads(_sparse_loss, params, batch)
    parts = []
    for r in range(n):
        share = {k: v[r * 64 // n:(r + 1) * 64 // n] for k, v in batch.items()}
        parts.append(trainer._grads(_sparse_loss, params, share)[1]["t"].coalesce())
    got = trainer.reduce_sparse_rows(parts, n)
    again = trainer.reduce_sparse_rows(parts, n)
    want = whole["t"].coalesce()
    assert got.is_sparse and got.is_coalesced()
    assert torch.equal(got.indices(), want.indices())
    scale = float(want.values().abs().max())
    assert float((got.values() - want.values()).abs().max()) <= 1e-6 * scale
    assert torch.equal(got.values(), again.values())


def test_reduce_sparse_rows_sums_a_row_that_several_ranks_touch():
    a = torch.sparse_coo_tensor(torch.tensor([[1, 4]]), torch.tensor([[1.0], [2.0]]), (8, 1))
    b = torch.sparse_coo_tensor(torch.tensor([[4, 6]]), torch.tensor([[3.0], [5.0]]), (8, 1))
    got = trainer.reduce_sparse_rows([a.coalesce(), b.coalesce()], 2)
    assert got.indices().tolist() == [[1, 4, 6]]
    assert got.values().view(-1).tolist() == [0.5, 2.5, 2.5]


def test_split_takes_only_batch_leading_inputs():
    """A leaf is cut by its own leading axis, and only if that axis is
    "batch"; the others pass whole."""
    batch = {"x": torch.arange(8).reshape(8, 1), "nodes": torch.arange(3)}
    keys = trainer._split_keys(batch, {"x": ("batch", None), "nodes": ("nodes",)})
    assert keys == {"x"}
    assert trainer._rank_share(batch["x"], 2, 1, 4).view(-1).tolist() == [2, 3, 6, 7]
    assert trainer._split_keys(batch, None) == {"x", "nodes"}
    with pytest.raises(ValueError, match="do not split"):
        trainer._rank_share(batch["nodes"], 2, 0, 0)

