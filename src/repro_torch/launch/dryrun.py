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

Every cell also counts its activation collectives
(:func:`activation_collectives`): its step runs once more on ``meta``,
with its state placed on the fake mesh as ``DTensor``\\ s and its inputs
split as the step splits them, and every ``_c10d_functional`` op over the
:func:`activation_axes` is recorded at this device's bytes. A train
step's are over the ``"model"`` group (NequIP: over every axis
``"edges"`` resolves to): the LM's tensor-parallel sums of the attention
and FFN outputs and their gradients, its vocab-sharded lookup and softmax
and the MoE's gathers of its experts' outputs; RecSys's row-sharded
lookups' sums and BERT4Rec's block sums, gathered projections and
sharded softmax; NequIP's node gathers over the ranks ``"nodes"``
resolves to (``"data"``: positions and each layer's features) and its
per-layer node aggregates reduce-scattered over them and summed over the
other edge ranks (``"model"``: 1/16 of the aggregates on the 16 x 16
mesh), and, in the backward, their transposes (the aggregates' gradients
gathered, the features' reduce-scattered and summed), twice over with
forces. A serving step's are over every axis it
splits its inputs over as well (:func:`~repro_torch.train.trainer.make_serve_step`):
besides the "model" sums, a retrieval's id gathers and row
reduce-scatters, a decode step's merged softmax (maxima and sums over
"model"), its gathered heads, tokens and vocab-sharded logits, the
outputs' gathers over the split axes, and the parameters' FSDP gathers
as the step makes them, so a serving record counts the trace's
collectives in place of the rules' reckoning. The record gives the same
bytes by mesh axis (``activation_collectives_by_axis``). A cell whose state or batch
does not divide over the mesh has no sharded step, and the record says
so under ``activation_collectives``; ``trace_s`` includes this trace.

A cell's inputs are reckoned as its step splits them: a train step's by
:func:`~repro_torch.train.trainer.step_input_logical` (the leading
``"batch"``, ``"edges"`` or ``"nodes"`` axis, nothing else: NequIP's
node arrays count ``1/|"data"|`` on each device), a serving step's by
:func:`~repro_torch.train.trainer.serve_input_logical` (``"batch"``,
``"cands"`` and the decode caches' ``"kv_seq"``). XLA's temporary bytes and
GSPMD's chosen collectives have no counterpart here.

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
from repro_torch.train.trainer import SERVE_AXES, serve_input_logical, step_input_logical
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
    only the ``_c10d_functional`` collectives over the groups named in
    ``axes`` (group name → mesh axis), and each axis's in ``by_axis``."""

    axes: dict = dataclasses.field(default_factory=dict)
    by_axis: dict = dataclasses.field(default_factory=dict)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = op_analysis.run_op(func, args, kwargs)
        if func.namespace == "_c10d_functional":
            names = [a for a in (*args, *kwargs.values()) if isinstance(a, str) and a in self.axes]
            if names:
                self.record(func, args, kwargs, out)
                axis = self.by_axis.setdefault(self.axes[names[0]], op_analysis.OpTrace())
                axis.record(func, args, kwargs, out)
        return out


def activation_axes(cell, rules: Rules) -> tuple[str, ...]:
    """The mesh axes a step's activations cross: ``"model"``; for a train
    cell whose edges are split (NequIP), every axis ``"edges"`` resolves
    to (the axes of ``"nodes"`` among them); for a serving cell, every
    axis ``"batch"``, ``"cands"`` and ``"kv_seq"`` resolve to."""
    axes = ["model"]
    if cell.shape.kind != "train":
        for name in SERVE_AXES:
            axes += [a for a in mesh_axes(rules.physical(name)) if a not in axes]
    elif any(tuple(lg or (None,))[0] == "edges" for lg in cell.input_logical().values()):
        axes += [a for a in mesh_axes(rules.physical("edges")) if a not in axes]
    return tuple(axes)


def _step_inputs(cell) -> dict:
    """The cell's ``meta`` input specs; a 0-dim integer input (a decode
    step's position, which the step reads on the host) is a CPU zero."""
    return {k: torch.zeros((), dtype=v.dtype)
            if isinstance(v, torch.Tensor) and v.ndim == 0 and not v.dtype.is_floating_point
            else v for k, v in cell.input_specs().items()}


def activation_collectives(cell, rules: Rules, mesh: DeviceMesh,
                           by_axis: dict | None = None) -> dict[str, float]:
    """This device's bytes, by kind, of the collectives over the
    :func:`activation_axes` in one step of ``cell`` whose state is placed
    on ``mesh`` by its logical axes (``DTensor``\\ s on ``meta``) and whose
    inputs are split as its step splits them: a serving cell's inputs
    placed as ``DTensor``\\ s too (a decode step's caches live on their
    ranks; a plain cache would be gathered back whole after each step).
    ``by_axis``, where given, receives the same bytes by mesh axis and
    kind. Raises ``ValueError`` where the step cannot run sharded."""
    out = {k: 0.0 for k in op_analysis.COLLECTIVES}
    names = mesh.mesh_dim_names
    axes = [a for a in activation_axes(cell, rules)
            if a in names and mesh.size(names.index(a)) > 1]
    if not axes:
        return out
    state = remesh(cell.abstract_state(), cell.state_logical(), rules, mesh, src_data_rank=None)
    inputs = _step_inputs(cell)
    if cell.shape.kind != "train":
        ilog = serve_input_logical(cell.input_logical())
        keys = [k for k in inputs if any(any(lg) for _, _, lg in logical_leaves(inputs[k], ilog[k]))]
        inputs.update(remesh({k: inputs[k] for k in keys}, {k: ilog[k] for k in keys}, rules,
                             mesh, src_data_rank=None))
    tr = _GroupTrace(axes={mesh.get_group(a).group_name: a for a in axes})
    with sharding_rules(rules, mesh), tr:
        cell.step(state, inputs)
    if by_axis is not None:
        by_axis.update({a: {k: v for k, v in op_analysis.analyze(t).coll_breakdown.items() if v}
                        for a, t in tr.by_axis.items()})
    return op_analysis.analyze(tr).coll_breakdown


def trace_step(cell) -> tuple[op_analysis.OpTrace, Any]:
    """One step of ``cell`` traced at global shape on its ``meta`` state
    and inputs (:func:`_step_inputs`)."""
    return op_analysis.trace(cell.step, cell.abstract_state(), _step_inputs(cell))


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
        # What the step splits, not every rule.
        train = shape.kind == "train"
        ilog = step_input_logical(ilog) if train else serve_input_logical(ilog)
        problems = (validate_divisibility(state, slog, rules, mesh)
                    + validate_divisibility(inputs, ilog, rules, mesh))
        s_total, s_local = placed_bytes(state, slog, rules, mesh)
        i_total, i_local = placed_bytes(inputs, ilog, rules, mesh)
        act_axes: dict = {}
        try:
            act = activation_collectives(cell, rules, mesh, act_axes)
        except ValueError as e:
            act = f"no sharded step: {e}"
    with sharding_rules(rules):
        tr, out = trace_step(cell)
    t_trace = time.time() - t0

    params, plog = (state.params, slog.params) if train else (state, slog)
    if train:
        passes = 2 * (shape.global_batch // shape.microbatch if shape.microbatch else 1)
    else:
        passes = 1
    coll = rule_collectives(params, plog, rules, sizes, train, passes)
    if isinstance(act, dict):
        # A serving step's trace holds its parameters' gathers as it makes
        # them, in place of the rules' reckoning.
        coll = {k: (0.0 if not train else v) + act[k] for k, v in coll.items()}
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
            "activation_collectives": act,
            "activation_collectives_by_axis": act_axes,
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
