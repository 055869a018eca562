"""Logical-axis sharding rules → the dimensions of a ``DeviceMesh``.

The port of :mod:`repro.distributed.sharding`. Models annotate tensors with
*logical* axis names ("batch", "ff", "experts", "rows", …). A :class:`Rules`
table maps each logical name to physical mesh axes; the same model code
runs on the single-pod ``(data=16, model=16)`` mesh, the multi-pod
``(pod=2, data=16, model=16)`` mesh, and one device (rules absent → every
constraint is the identity). The tables are the reference's, as data.

Key placement decisions (the reference's):

- ``batch``/``groups``/``edges``  → all data-parallel axes (pod, data).
- ``ff``/``vocab``/``qkv``        → tensor parallel ("model").
- ``embed``                       → "data": FSDP over the d_model dim of
  every weight matrix (gathered once per layer pass).
- ``experts``                     → expert parallel ("model"; the expert
  FFN width also takes "pod" on the multi-pod mesh).
- ``kv_seq``                      → "model": decode KV caches shard their
  sequence axis.
- ``rows``                        → "model": embedding-table row sharding.
- ``cands``                       → every axis: retrieval scoring is
  embarrassingly parallel.

What differs from the reference, where JAX has no PyTorch counterpart:

- :meth:`Rules.resolve` returns this module's :class:`PartitionSpec`, a
  tuple whose entries equal those of ``jax.sharding.PartitionSpec`` (a
  one-axis tuple is written as its name, as JAX writes it).
- :func:`spec_to_placements` replaces ``spec_to_sharding``: a spec becomes
  DTensor placements, one ``Shard(d)`` or ``Replicate()`` per mesh
  dimension. A tensor dimension split over several mesh axes takes
  ``Shard(d)`` on each; DTensor splits them left to right over the mesh,
  the major-to-minor order JAX uses, so a spec must list its axes in mesh
  order.
- :func:`constrain` is ``with_sharding_constraint``'s counterpart: on a
  ``DTensor`` it redistributes to the resolved placements; a plain tensor
  (the one-device path) passes through unchanged, rules or not.
- :func:`sharding_rules` also takes the mesh the rules apply to
  (``jax.sharding.set_mesh``'s role), which the data-parallel train step
  reads through :func:`current_mesh`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections.abc import Iterator
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

Physical = Any  # str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (split over all of them, major to minor). As
    in JAX, a one-name tuple is written as the name and an empty one as
    ``None``."""

    def __new__(cls, *entries: Physical) -> PartitionSpec:
        def canon(e: Physical) -> Physical:
            if isinstance(e, tuple):
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict[str, Physical]

    def physical(self, logical: str | None) -> Physical:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]

    def resolve(self, *logical: str | None) -> PartitionSpec:
        return PartitionSpec(*(self.physical(ax) for ax in logical))


def single_pod_rules() -> Rules:
    return Rules(
        table={
            "batch": ("data",),
            "groups": ("data",),
            "edges": ("data", "model"),
            "seq": None,
            "seq_sp": "model",   # sequence parallelism (enabled per config)
            # FSDP: weight matrices shard their d_model dim over the DP axis.
            "embed": "data",
            "ff": "model",
            "qkv": "model",
            "vocab": "model",
            "heads": None,
            "kv_seq": "model",
            "layers": None,
            "experts": "model",
            "expert_ff": None,
            "rows": "model",
            "cands": ("data", "model"),
            "nodes": ("data",),
            "dense": None,
        }
    )


def multi_pod_rules() -> Rules:
    r = dict(single_pod_rules().table)
    r.update(
        {
            "batch": ("pod", "data"),
            "groups": ("pod", "data"),
            "edges": ("pod", "data", "model"),
            "nodes": ("pod", "data"),
            # Experts stay on "model"; the expert FFN width takes the pod axis.
            "expert_ff": "pod",
            "cands": ("pod", "data", "model"),
        }
    )
    return Rules(table=r)


def local_rules() -> Rules:
    """Everything replicated: single-device testing."""
    return Rules(table={k: None for k in single_pod_rules().table})


_CURRENT: contextvars.ContextVar[tuple[Rules | None, DeviceMesh | None]] = (
    contextvars.ContextVar("sharding_rules", default=(None, None))
)


@contextlib.contextmanager
def sharding_rules(rules: Rules | None, mesh: DeviceMesh | None = None) -> Iterator[None]:
    """Make ``rules`` (and the ``mesh`` they resolve against) current for
    the block."""
    token = _CURRENT.set((rules, mesh))
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_rules() -> Rules | None:
    return _CURRENT.get()[0]


def current_mesh() -> DeviceMesh | None:
    return _CURRENT.get()[1]


def resolve(*logical: str | None) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return PartitionSpec()
    return rules.resolve(*logical)


def mesh_axes(entry: Physical) -> tuple[str, ...]:
    """The mesh axes one spec entry splits over, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_placements(mesh: DeviceMesh, spec: PartitionSpec, ndim: int) -> tuple[Placement, ...]:
    """DTensor placements of a tensor of rank ``ndim`` under ``spec``: for
    each mesh dimension ``Shard(d)`` if tensor dimension ``d`` is split over
    it, else ``Replicate()``. Raises if the spec is longer than the tensor,
    names an axis the mesh lacks or uses twice, or lists a dimension's axes
    out of mesh order."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dimension names")
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dimensions")
    placements: list[Placement] = [Replicate()] * len(names)
    used: set[str] = set()
    for d, entry in enumerate(spec):
        axes = mesh_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the mesh {names}")
            if a in used:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            used.add(a)
            placements[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec}: dimension {d} lists {axes} out of the mesh's order {names}"
            )
    return tuple(placements)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the placements ``logical`` resolves
    to; the identity without active rules and for a plain tensor."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = spec_to_placements(mesh, rules.resolve(*logical), x.ndim)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
