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
