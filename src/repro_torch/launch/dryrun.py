"""Multi-pod dry run: every (arch × shape × mesh) cell, shaped on ``meta``.

The port of :mod:`repro.launch.dryrun`. The reference lowers and compiles
each cell for 256 or 512 fake XLA devices. Eager PyTorch compiles nothing,
so for each cell this:

1. sets up a *fake* process group of 256 or 512 ranks (the ``"fake"``
   backend over ``FakeStore``; nothing is sent) and builds the production
   mesh on it,
2. resolves the cell's logical axes against the mesh rules and places its
   abstract state and input specs on the mesh as ``DTensor``\\ s on
   ``meta``: the per-device bytes of state and inputs, and the
   divisibility problems (:func:`~repro_torch.train.elastic.validate_divisibility`),
3. traces one step at global shape on plain ``meta`` tensors
   (:mod:`repro_torch.launch.op_analysis`): the per-device FLOPs and bytes
   are the global figures divided by the chips (ideal SPMD),
4. reckons the collectives from the rules (below) and records the H100
   roofline terms (:mod:`repro_torch.launch.roofline`) to
   ``artifacts/dryrun/<cell>.json``, with the trace as ``.ops.json.gz``.

The collective term, per device, reckons the parameters' traffic from the
rules:

- a parameter split over a ``"batch"`` axis (FSDP: ``"embed"`` → "data")
  is all-gathered over those axes once per pass over the weights (one per
  microbatch at serving, two, forward and backward, in training), and a
  training step reduce-scatters its gradient once;
- in training, a parameter replicated over the ``"batch"`` axes has its
  gradient all-reduced over them (counted twice, ring = reduce-scatter +
  all-gather).

A train cell of the LM family also counts its activation collectives
(:func:`activation_collectives`): its step runs once more on ``meta``,
with its state placed on the fake mesh as ``DTensor``\\ s and its inputs
split over ``"batch"``, and every ``_c10d_functional`` op over the
``"model"`` group is recorded (the tensor-parallel sums of the attention
and FFN outputs and their gradients, the vocab-sharded lookup and softmax,
the MoE's gathers of its experts' outputs) at this device's bytes. A cell
whose state or batch does not divide over the mesh has no sharded step,
and the record says so under ``activation_collectives``; ``trace_s``
includes this trace. RecSys and NequIP cells run with their
parameters replicated over ``"model"`` and have no activation
collectives. XLA's temporary bytes and GSPMD's chosen collectives have no
counterpart here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Unlike the reference, importing this module sets no environment variable.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from collections.abc import Iterator
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs
from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed.sharding import (
    Rules,
    mesh_axes,
    multi_pod_rules,
    sharding_rules,
    single_pod_rules,
    spec_to_placements,
)
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.elastic import axis_sizes, logical_leaves, remesh, validate_divisibility
from repro_torch.utils import tree_items

ARTIFACTS = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun")


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0) for the block. The process must have no group yet."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def placed_bytes(tree: Any, logical: Any, rules: Rules, mesh: DeviceMesh) -> tuple[int, int]:
    """(global, this device's) bytes of ``tree``'s leaves placed on
    ``mesh`` as ``DTensor``\\ s on ``meta`` (a dimension that does not
    divide gives the largest shard, as ``torch.chunk`` does)."""
    total = local = 0
    for _, leaf, lg in logical_leaves(tree, logical):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.empty(leaf.shape, device="meta")
        if t.device.type != "meta":
            t = torch.empty(t.shape, dtype=t.dtype, device="meta")
        d = distribute_tensor(t, mesh, spec_to_placements(mesh, rules.resolve(*lg), t.ndim),
                              src_data_rank=None)
        total += _nbytes(t)
        local += _nbytes(d.to_local())
    return total, local


def rule_collectives(params: Any, logical: Any, rules: Rules, sizes: dict[str, int],
                     train: bool, passes: int) -> dict[str, float]:
    """Per-device collective bytes of the parameters' traffic (see the
    module docstring); ``passes``: passes over the weights a step makes."""
    batch_axes = set(mesh_axes(rules.physical("batch")))
    n_data = math.prod(sizes[a] for a in batch_axes)
    out = {k: 0.0 for k in op_analysis.COLLECTIVES}
    for _, p, lg in logical_leaves(params, logical):
        used = [a for e in rules.resolve(*lg) for a in mesh_axes(e)]
        shard = _nbytes(p) / math.prod(sizes[a] for a in used)
        fsdp = math.prod(sizes[a] for a in used if a in batch_axes)
        if fsdp > 1:
            out["all-gather"] += passes * shard * fsdp
            if train:
                out["reduce-scatter"] += shard * fsdp
        elif train and n_data > 1:
            out["all-reduce"] += 2 * shard
    return out


@dataclasses.dataclass
class _GroupTrace(op_analysis.OpTrace):
    """An :class:`~repro_torch.launch.op_analysis.OpTrace` that records
    only the ``_c10d_functional`` collectives over the group named
    ``group``."""

    group: str = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional" and self.group in (*args, *kwargs.values()):
            return super().__torch_dispatch__(func, types, args, kwargs)
        return func(*args, **kwargs)


def activation_collectives(cell, rules: Rules, mesh: DeviceMesh) -> dict[str, float]:
    """This device's bytes, by kind, of the collectives over ``"model"``
    in one step of a train ``cell`` whose state is placed on ``mesh`` by
    its logical axes (``DTensor``\\ s on ``meta``) and whose inputs are
    split over ``"batch"``. Raises ``ValueError`` where the step cannot run
    sharded."""
    out = {k: 0.0 for k in op_analysis.COLLECTIVES}
    names = mesh.mesh_dim_names
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return out
    state = remesh(cell.abstract_state(), cell.state_logical(), rules, mesh, src_data_rank=None)
    tr = _GroupTrace(group=mesh.get_group("model").group_name)
    with sharding_rules(rules, mesh), tr:
        cell.step(state, cell.input_specs())
    return op_analysis.analyze(tr).coll_breakdown


def trace_step(cell) -> tuple[op_analysis.OpTrace, Any]:
    """One step of ``cell`` traced at global shape on its ``meta`` state
    and inputs; a 0-dim integer input (a decode step's position, which the
    step reads on the host) is a CPU zero."""
    inputs = {k: torch.zeros((), dtype=v.dtype)
              if isinstance(v, torch.Tensor) and v.ndim == 0 and not v.dtype.is_floating_point
              else v for k, v in cell.input_specs().items()}
    return op_analysis.trace(cell.step, cell.abstract_state(), inputs)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             override_cfg=None) -> tuple[dict, op_analysis.OpTrace | None]:
    from repro_torch.models.api import make_cell

    cfg = override_cfg or get_config(arch)
    shape = {s.name: s for s in cfg.shapes}[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if shape.skip_reason:
        record["skipped"] = shape.skip_reason
        return record, None

    rules = multi_pod_rules() if multi_pod else single_pod_rules()
    chips = 512 if multi_pod else 256
    cell = make_cell(cfg, shape)
    t0 = time.time()
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        sizes = axis_sizes(mesh)
        state, slog = cell.abstract_state(), cell.state_logical()
        inputs, ilog = cell.input_specs(), cell.input_logical()
        problems = (validate_divisibility(state, slog, rules, mesh)
                    + validate_divisibility(inputs, ilog, rules, mesh))
        s_total, s_local = placed_bytes(state, slog, rules, mesh)
        i_total, i_local = placed_bytes(inputs, ilog, rules, mesh)
        act = None
        if shape.kind == "train" and isinstance(cfg, TransformerConfig):
            try:
                act = activation_collectives(cell, rules, mesh)
            except ValueError as e:
                act = f"no sharded step: {e}"
    with sharding_rules(rules):
        tr, out = trace_step(cell)
    t_trace = time.time() - t0

    train = shape.kind == "train"
    params, plog = (state.params, slog.params) if train else (state, slog)
    if train:
        passes = 2 * (shape.global_batch // shape.microbatch if shape.microbatch else 1)
    else:
        passes = 1
    coll = rule_collectives(params, plog, rules, sizes, train, passes)
    if isinstance(act, dict):
        coll = {k: v + act[k] for k, v in coll.items()}
    model_flops = (
        rf.lm_model_flops(cfg, shape) if isinstance(cfg, TransformerConfig) else 0.0
    )
    roof = rf.roofline(op_analysis.analyze(tr), chips=chips, model_flops=model_flops,
                       coll_breakdown=coll)
    out_bytes = sum(_nbytes(t) for _, t in tree_items(out) if isinstance(t, torch.Tensor))
    per_device = s_local + i_local + out_bytes / chips
    record.update(
        {
            "trace_s": round(t_trace, 1),
            "chips": chips,
            "divisibility": problems,
            **({} if act is None else {"activation_collectives": act}),
            "memory": {
                "argument_size_in_bytes": s_total + i_total,
                "output_size_in_bytes": out_bytes,
                "per_device_argument_bytes": s_local + i_local,
                "per_device_total_gib": round(per_device / 2**30, 3),
            },
            "roofline": roof.to_dict(),
        }
    )
    return record, tr


def all_cells(include_forest: bool = True):
    archs = list(ASSIGNED_ARCHS) + (["lear-msn1"] if include_forest else [])
    for arch in archs:
        cfg = get_config(arch)
        for shape in cfg.shapes:
            for multi_pod in (False, True):
                yield arch, shape.name, multi_pod


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    p.add_argument("--arch", choices=list_archs())
    p.add_argument("--shape")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    out_dir = args.out or os.path.normpath(ARTIFACTS)
    os.makedirs(out_dir, exist_ok=True)

    if args.all:
        cells = list(all_cells())
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for arch, shape, multi_pod in cells:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        tag = f"{arch}__{shape}__{mesh_name}".replace("/", "_")
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            with open(path) as f:
                cached = json.load(f)
            if "error" not in cached:
                print(f"[skip-cached] {tag}")
                continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            record, tr = run_cell(arch, shape, multi_pod)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures += 1
            record, tr = {
                "arch": arch, "shape": shape, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }, None
            print(f"  FAILED: {record['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        if tr is not None:
            op_analysis.save(tr, os.path.join(out_dir, tag + ".ops.json.gz"))
        if "roofline" in record:
            r = record["roofline"]
            print(
                f"  ok: trace={record['trace_s']}s "
                f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
                f"coll={r['collective_s']:.2e}s dominant={r['dominant']}",
                flush=True,
            )
        elif "skipped" in record:
            print(f"  skipped: {record['skipped']}", flush=True)
    print(f"done, {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
