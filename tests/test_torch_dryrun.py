"""Port parity: the dry run, its op analysis and the H100 roofline against
:mod:`repro.launch.roofline` and :mod:`repro.launch.hlo_analysis`.

- ``lm_param_count`` and ``lm_model_flops`` equal the reference's for every
  LM arch and shape;
- the matmul FLOPs that ``op_analysis`` counts in a smoke cell's forward
  equal the reference's ``dot`` FLOPs within 1%, summed by
  ``hlo_analysis._dot_flops`` with trip counts over its compiled
  one-device step;
- the per-device state-plus-input bytes on a (1, 1) mesh equal the
  reference's ``argument_size_in_bytes``;
- the collectives and the compute term are counted as the module
  docstrings say, and a trace survives ``save`` / ``load``;
- the DeepSeek-MoE-16B smoke step on a fake ``(4, 2)`` group (the
  reference's 8-device rule table) issues collectives over ``"model"``,
  and the dry run adds them to the collective term;
- a serving record carries the activation collectives of its sharded
  step: a retrieval's id gathers and row reduce-scatters, a decode step's
  merged softmax over the caches' sequence, the forest's gathered scores;
- a fake 16 × 16 dry run of smoke cells (in a subprocess: the fake process
  group is process-wide) writes records with the reference's keys
  (``lower_s`` and ``compile_s`` become ``trace_s``; XLA's temporary and
  code bytes have no counterpart), and ``reanalyze`` reproduces them.

``repro.launch.dryrun`` and ``repro.launch.hillclimb`` are never imported
here: they set ``XLA_FLAGS`` to 512 devices at import.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import TransformerConfig as RefTransformerConfig  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import single_pod_rules  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ref_configs.ASSIGNED_ARCHS
            if isinstance(ref_configs.get_config(a), RefTransformerConfig)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_count_and_model_flops_equal_the_reference(arch):
    pcfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    for active in (False, True):
        assert roofline.lm_param_count(pcfg, active) == ref_roofline.lm_param_count(rcfg, active)
    for ps, rs in zip(pcfg.shapes, rcfg.shapes, strict=True):
        assert roofline.lm_model_flops(pcfg, ps) == ref_roofline.lm_model_flops(rcfg, rs)


def _ref_dot_flops(hlo: str) -> float:
    """``hlo_analysis.analyze``'s walk, summing only ``dot`` FLOPs."""
    comps, entry = hlo_analysis.parse_module(hlo)
    total = 0.0

    def walk(comp: str, mult: float) -> None:
        nonlocal total
        instrs = comps.get(comp, [])
        by_name = {i.name: i for i in instrs}
        for i in instrs:
            if i.op == "while":
                body, cond = i.attr("body"), i.attr("condition")
                trips = hlo_analysis._trip_count(comps, cond) if cond else 1
                if body:
                    walk(body, mult * max(trips, 1))
            elif i.op in ("call", "conditional", "async-start", "fusion"):
                tgt = i.attr("to_apply") or i.attr("calls")
                if tgt:
                    walk(tgt, mult)
            elif i.op == "dot":
                total += mult * hlo_analysis._dot_flops(i, by_name)

    walk(entry, 1.0)
    return total


def _cells(arch: str, shape: ShapeSpec, dtype: str = "float32"):
    pcfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype=dtype)
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    ref_shape = ref_configs.base.ShapeSpec(**dataclasses.asdict(shape))
    return make_cell(pcfg, shape), ref_make_cell(rcfg, ref_shape)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_forward_matmul_flops_match_the_reference_dot_flops(arch):
    shape = ShapeSpec(name="p", kind="prefill", seq_len=64, global_batch=2)
    cell, ref_cell = _cells(arch, shape)
    tr, _ = op_analysis.trace(cell.step, cell.abstract_state(), cell.input_specs())
    cost = op_analysis.analyze(tr)
    got = sum(v for k, v in cost.flops.items() if k != "elementwise")
    hlo = jax.jit(ref_cell.step).lower(ref_cell.abstract_state(),
                                       ref_cell.input_specs()).compile().as_text()
    want = _ref_dot_flops(hlo)
    assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", ShapeSpec(name="t", kind="train", seq_len=32, global_batch=4)),
    ("deepseek-moe-16b", ShapeSpec(name="d", kind="decode", seq_len=64, global_batch=2)),
    ("dlrm-rm2", None),
    ("dlrm-rm2", next(s for s in port_configs.get_config("dlrm-rm2").shapes
                      if s.name == "retrieval_cand")),
    ("nequip", None),
])
def test_per_device_bytes_on_a_local_mesh_equal_the_reference_arguments(arch, shape):
    """On the (1, 1) mesh every leaf is whole: the step's arguments."""
    if shape is None:   # the arch's first registry shape, on its smoke config
        shape = port_configs.get_config(arch).shapes[0]
    cell, ref_cell = _cells(arch, shape)
    mesh = make_local_mesh("cpu")
    rules = single_pod_rules()
    _, s_local = dryrun.placed_bytes(cell.abstract_state(), cell.state_logical(), rules, mesh)
    _, i_local = dryrun.placed_bytes(cell.input_specs(), cell.input_logical(), rules, mesh)
    mem = jax.jit(ref_cell.step).lower(ref_cell.abstract_state(),
                                       ref_cell.input_specs()).compile().memory_analysis()
    assert s_local + i_local == mem.argument_size_in_bytes


def test_collectives_and_the_compute_term():
    tr = op_analysis.OpTrace()
    f32 = (((4, 8), "float32"),)
    tr.records[("_c10d_functional.all_reduce.default", f32, f32)] = [3, 0]
    tr.records[("_c10d_functional.all_gather_into_tensor.default", f32,
                (((16, 8), "float32"),))] = [1, 0]
    tr.records[("aten.mm.default", (((4, 8), "bfloat16"), ((8, 2), "bfloat16")),
                (((4, 2), "bfloat16"),))] = [2, 128]
    tr.records[("aten.add_.Tensor", f32 * 2, f32)] = [1, 0]
    tr.records[("aten.view.default", f32, (((32,), "float32"),))] = [5, 0]
    cost = op_analysis.analyze(tr)
    assert cost.coll_breakdown["all-reduce"] == 3 * 128 * 2
    assert cost.coll_breakdown["all-gather"] == 16 * 8 * 4
    assert cost.flops == {"bfloat16": 256, "elementwise": 32}
    assert cost.bytes == 2 * (64 + 32 + 16) + 3 * 128   # mm twice, the add; views none
    r = roofline.roofline(cost, chips=2, coll_breakdown={"all-gather": 100.0})
    assert r.compute_s == 128 / roofline.BF16_FLOPS + 16 / roofline.F32_FLOPS
    assert r.memory_s == cost.bytes / 2 / roofline.HBM_BW
    assert r.coll_breakdown["all-gather"] == 512 / 2 + 100
    assert r.collective_s == r.coll_bytes / roofline.NVLINK_BW
    assert r.bound_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert set(dataclasses.asdict(ref_roofline.Roofline(
        0, 0, 0, {}, 1, 0, 0, 0, 0, 0))) <= set(r.to_dict())


def test_a_trace_survives_save_and_load(tmp_path):
    a = torch.empty(16, 32, device="meta", requires_grad=True)

    def step():
        (torch.tanh(a @ a.T).sum()).backward()

    tr, _ = op_analysis.trace(step)
    op_analysis.save(tr, str(tmp_path / "t.ops.json.gz"))
    back = op_analysis.load(str(tmp_path / "t.ops.json.gz"))
    assert back.records == tr.records
    assert op_analysis.analyze(back) == op_analysis.analyze(tr)
    assert op_analysis.analyze(tr).flops["float32"] == 3 * 2 * 16 * 16 * 32


_DRYRUN_PROG = r"""
import dataclasses, json, os, sys
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, op_analysis, reanalyze

out = sys.argv[1]
cells = [
    ("qwen3-4b", ShapeSpec(name="t", kind="train", seq_len=32, global_batch=32, microbatch=16)),
    ("lear-msn1", get_config("lear-msn1").shapes[1]),
]
for arch, shape in cells:
    cfg = dataclasses.replace(get_smoke_config(arch), shapes=(shape,))
    record, tr = dryrun.run_cell(arch, shape.name, multi_pod=False, override_cfg=cfg)
    tag = f"{arch}__{shape.name}"
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(record, f)
    op_analysis.save(tr, os.path.join(out, tag + ".ops.json.gz"))
print("DRYRUN_OK")
"""


def test_fake_16x16_dry_run_writes_the_reference_record(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _DRYRUN_PROG, str(tmp_path)], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
    )
    assert "DRYRUN_OK" in res.stdout, res.stdout + res.stderr[-4000:]
    # The reference's record (src/repro/launch/dryrun.py, run_cell and _mem_dict).
    ref_keys = {"arch", "shape", "mesh", "kind", "lower_s", "compile_s", "chips", "memory",
                "roofline"}
    ref_roof = set(dataclasses.asdict(ref_roofline.Roofline(
        0, 0, 0, {}, 1, 0, 0, 0, 0, 0))) | {"dominant", "bound_s"}
    for name in ("qwen3-4b__t", "lear-msn1__rank_online"):
        with open(tmp_path / f"{name}.json") as f:
            rec = json.load(f)
        assert ref_keys - {"lower_s", "compile_s"} | {"trace_s"} <= set(rec), rec.keys()
        assert rec["chips"] == 256 and rec["mesh"] == "pod16x16"
        assert {"argument_size_in_bytes", "output_size_in_bytes",
                "per_device_total_gib"} <= set(rec["memory"])
        assert ref_roof <= set(rec["roofline"])
        r = rec["roofline"]
        assert r["compute_s"] > 0 and r["memory_s"] > 0 and np.isfinite(r["bound_s"])
        assert rec["memory"]["per_device_argument_bytes"] <= rec["memory"]["argument_size_in_bytes"]
    qwen = json.load(open(tmp_path / "qwen3-4b__t.json"))
    # Two microbatches: the weights "embed" shards are gathered 2 × 2 times.
    assert qwen["roofline"]["coll_breakdown"]["all-gather"] > 0
    assert qwen["roofline"]["coll_breakdown"]["all-reduce"] > 0
    assert qwen["divisibility"] == [] or all(len(p) == 3 for p in qwen["divisibility"])
    before = {n: json.load(open(tmp_path / f"{n}.json"))["roofline"]
              for n in ("qwen3-4b__t", "lear-msn1__rank_online")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.reanalyze", "--dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
    )
    assert res.returncode == 0, res.stderr[-4000:]
    for n, want in before.items():
        got = json.load(open(tmp_path / f"{n}.json"))["roofline"]
        for k in ("compute_s", "memory_s", "collective_s", "bound_s", "coll_breakdown"):
            assert got[k] == pytest.approx(want[k], rel=1e-12), (n, k)


_ACTIVATION_PROG = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import Rules
from repro_torch.launch import dryrun
from repro_torch.models.api import make_cell

rules = Rules(table={
    "batch": ("data",), "groups": ("data",), "edges": ("data",),
    "seq": None, "embed": None, "ff": "model", "qkv": "model",
    "vocab": "model", "heads": None, "kv_seq": None, "layers": None,
    "experts": "model", "expert_ff": None, "rows": "model",
    "cands": ("data", "model"), "nodes": None, "dense": None,
})
cell = make_cell(get_smoke_config("deepseek-moe-16b"),
                 ShapeSpec(name="t", kind="train", seq_len=32, global_batch=8, microbatch=4))
with dryrun.fake_world(8):
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    act = dryrun.activation_collectives(cell, rules, mesh)
    one = dryrun.activation_collectives(
        cell, rules, init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model")))
print("ACT", json.dumps({"act": act, "one": one}))
"""


def test_sharded_step_has_activation_collectives_on_a_fake_4x2_group():
    """Tensor-parallel sums (all-reduce) and the MoE's gather of its
    experts' outputs (all-gather) over "model"; none where "model" has one
    rank."""
    res = subprocess.run(
        [sys.executable, "-c", _ACTIVATION_PROG], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
    )
    line = [x for x in res.stdout.splitlines() if x.startswith("ACT ")]
    assert line, res.stdout + res.stderr[-4000:]
    got = json.loads(line[0][4:])
    assert got["act"]["all-reduce"] > 0 and got["act"]["all-gather"] > 0, got
    assert sum(got["act"].values()) > 0
    assert sum(got["one"].values()) == 0, got


_RECSYS_NEQUIP_PROG = r"""
import dataclasses, json
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun

out = {}
for arch, shape in (
    ("dlrm-rm2", next(s for s in get_config("dlrm-rm2").shapes if s.name == "train_batch")),
    ("nequip", next(s for s in get_config("nequip").shapes if s.name == "ogb_products")),
    ("dlrm-rm2", ShapeSpec(name="uneven", kind="train", batch=24)),
):
    cfg = dataclasses.replace(get_smoke_config(arch), shapes=(shape,))
    record, _ = dryrun.run_cell(arch, shape.name, multi_pod=False, override_cfg=cfg)
    out[f"{arch} {shape.name}"] = record
print("RECORDS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def recsys_nequip_records():
    """The fake 16 x 16 dry run of DLRM-RM2's ``train_batch`` and NequIP's
    ``ogb_products`` (registry shapes, smoke widths), and of a DLRM batch
    of 24, which does not split over 16 data ranks."""
    res = subprocess.run(
        [sys.executable, "-c", _RECSYS_NEQUIP_PROG], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
    )
    line = [x for x in res.stdout.splitlines() if x.startswith("RECORDS ")]
    assert line, res.stdout + res.stderr[-4000:]
    return json.loads(line[0][len("RECORDS "):])


def test_dlrm_train_records_row_lookup_sums_over_model(recsys_nequip_records):
    """Rows over "model": each of the 26 tables' lookups is summed over the
    axis, [4,096 rows a device, 26 tables, D] float32 at least once, and the
    collective term counts it beside the parameters' traffic."""
    rec = recsys_nequip_records["dlrm-rm2 train_batch"]
    cfg = port_configs.get_smoke_config("dlrm-rm2")
    act = rec["activation_collectives"]
    lookups = 65536 // 16 * len(cfg.vocab_sizes) * cfg.embed_dim * 4
    assert act["all-reduce"] >= lookups, act
    assert rec["roofline"]["coll_breakdown"]["all-reduce"] >= act["all-reduce"] / 256


def test_nequip_ogb_products_records_per_layer_node_sums(recsys_nequip_records):
    """Edges over all 256 ranks, nodes over the 16 "data" ranks: every
    layer reduce-scatters its node aggregates (``[N, paths · mul, 2l + 1]``
    for l = 0, 1, 2) over "data" and sums the 1/16 share over "model"; the
    backward gathers their gradients over "data". No collective of the
    step crosses "data" as an all-reduce of whole nodes, and the node
    inputs count 1/16 on each device."""
    rec = recsys_nequip_records["nequip ogb_products"]
    cfg = port_configs.get_smoke_config("nequip")
    shape = next(s for s in port_configs.get_config("nequip").shapes if s.name == "ogb_products")
    n = -(-shape.n_nodes // 512) * 512
    aggregates = cfg.n_layers * n * cfg.d_hidden * (1 + 3 + 5) * 4
    act, axes = rec["activation_collectives"], rec["activation_collectives_by_axis"]
    assert axes["data"]["reduce-scatter"] >= aggregates, axes
    assert axes["data"]["all-gather"] >= aggregates, axes
    assert axes["data"].get("all-reduce", 0) < aggregates / 100, axes
    assert 2 * aggregates / 16 <= axes["model"]["all-reduce"] <= act["reduce-scatter"] / 4, axes
    assert set(axes["model"]) == {"all-reduce"}, axes
    assert act == {k: sum(a.get(k, 0) for a in axes.values()) for k in act}, (act, axes)
    node_inputs = n * (3 + 1 + shape.d_feat) * 4     # positions, species, node_feat
    edges = 2 * (-(-shape.n_edges // 512) * 512) * 4
    assert rec["memory"]["per_device_argument_bytes"] >= (node_inputs + edges / 16) / 16
    assert rec["memory"]["per_device_argument_bytes"] < node_inputs / 8, rec["memory"]


def test_a_batch_that_does_not_split_says_so(recsys_nequip_records):
    rec = recsys_nequip_records["dlrm-rm2 uneven"]
    assert rec["activation_collectives"].startswith("no sharded step"), rec
    assert rec["divisibility"], rec


_SERVE_PROG = r"""
import dataclasses, json
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun

out = {}
for arch, name in (("dlrm-rm2", "retrieval_cand"), ("qwen3-4b", "decode_32k"),
                   ("lear-msn1", "rank_online")):
    shape = next(s for s in get_config(arch).shapes if s.name == name)
    cfg = dataclasses.replace(get_smoke_config(arch), shapes=(shape,))
    record, _ = dryrun.run_cell(arch, name, multi_pod=False, override_cfg=cfg)
    out[f"{arch} {name}"] = record
print("RECORDS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def serve_records():
    """The fake 16 x 16 dry run of three serving cells (registry shapes,
    smoke widths)."""
    res = subprocess.run(
        [sys.executable, "-c", _SERVE_PROG], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
    )
    line = [x for x in res.stdout.splitlines() if x.startswith("RECORDS ")]
    assert line, res.stdout + res.stderr[-4000:]
    return json.loads(line[0][len("RECORDS "):])


def test_retrieval_record_counts_the_candidates_exchange(serve_records):
    """Candidates over all 256 ranks, tables by rows over "model": each
    rank's ids gathered over its 16 "model" ranks, the held rows
    reduce-scattered back to their owners ([C / 16, D] float32 a device),
    the scores gathered over every rank; the serving record counts the
    trace's collectives as its collective term."""
    rec = serve_records["dlrm-rm2 retrieval_cand"]
    cfg = port_configs.get_smoke_config("dlrm-rm2")
    C = -(-1_000_000 // 512) * 512
    act = rec["activation_collectives"]
    assert act["reduce-scatter"] >= C // 16 * cfg.embed_dim * 4, act
    assert act["all-gather"] >= C * 4, act   # the scores, whole on every rank
    coll = rec["roofline"]["coll_breakdown"]
    assert coll["reduce-scatter"] == act["reduce-scatter"], coll   # both a device's bytes
    # Each device holds 1 / 256 of the candidate ids.
    assert rec["divisibility"] == [], rec["divisibility"]


def test_decode_record_counts_the_merged_softmax(serve_records):
    """The decode caches' sequence over 16 "model" ranks: per layer the
    ranks' maxima and their rescaled sums are reduced over "model"; the
    per-device bytes hold 1 / 256 of the caches, and the trace gathers
    less than that (the caches stay placed)."""
    rec = serve_records["qwen3-4b decode_32k"]
    act = rec["activation_collectives"]
    assert act["all-reduce"] > 0 and act["all-gather"] > 0, act
    cfg = port_configs.get_smoke_config("qwen3-4b")
    shape = next(s for s in port_configs.get_config("qwen3-4b").shapes if s.name == "decode_32k")
    caches = (2 * cfg.n_layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads
              * cfg.d_head * 2)
    assert rec["memory"]["per_device_argument_bytes"] < caches / 200, rec["memory"]
    # The caches are placed on their ranks: nothing gathers them back whole.
    assert act["all-gather"] < caches / 256, act


def test_forest_record_gathers_its_scores(serve_records):
    """Queries over the 16 "data" ranks: the scores and continue masks
    are gathered over them; the trees are replicated."""
    act = serve_records["lear-msn1 rank_online"]["activation_collectives"]
    assert act["all-gather"] > 0 and act["all-reduce"] == 0, act
