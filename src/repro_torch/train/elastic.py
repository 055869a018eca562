"""Elastic re-meshing: resume the same logical program on another mesh.

The port of :mod:`repro.train.elastic`. Every placement is expressed
through *logical* axis rules (:mod:`repro_torch.distributed.sharding`), so
surviving a node failure is:

1. restore the last checkpoint (host tensors or numpy arrays),
2. build a new mesh from the surviving device count,
3. re-resolve the SAME logical specs against the new mesh,
4. ``distribute_tensor`` every leaf with the new placements.

:func:`remesh` does steps 3–4. Shrinking the data axis is always legal
(the batch re-divides); a change of the model axis is checked against the
divisibility of every sharded dimension before anything moves.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import Rules, mesh_axes, spec_to_placements


def _is_leaf(x: Any) -> bool:
    return hasattr(x, "shape")


def logical_leaves(tree: Any, logical: Any, path: str = "") -> Iterator[tuple[str, Any, Any]]:
    """``(path, leaf, logical axes)`` of every array leaf of ``tree``, the
    path spelled as ``jax.tree_util.keystr`` spells it (``['w']``, ``[0]``,
    ``.params``), dict keys in sorted order as JAX flattens them."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield path, tree, logical
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from logical_leaves(tree[k], logical[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from logical_leaves(v, logical[i], f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if not f.init:   # a cache, not state
                continue
            yield from logical_leaves(getattr(tree, f.name), getattr(logical, f.name),
                                      f"{path}.{f.name}")
    else:
        raise TypeError(
            f"{path or 'tree'}: not an array, dict, sequence or dataclass: {type(tree)}"
        )


def _map(fn: Callable[[Any, Any], Any], tree: Any, logical: Any) -> Any:
    """``tree`` with each array leaf replaced by ``fn(leaf, logical axes)``."""
    if tree is None or _is_leaf(tree):
        return tree if tree is None else fn(tree, logical)
    if isinstance(tree, dict):
        return {k: _map(fn, v, logical[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, logical[i]) for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: _map(fn, getattr(tree, f.name), getattr(logical, f.name))
        for f in dataclasses.fields(tree) if f.init
    })


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Mesh axis name → size (a ``DeviceMesh``, or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def validate_divisibility(tree: Any, logical_tree: Any, rules: Rules, mesh: DeviceMesh
                          ) -> list[tuple[str, int, int]]:
    """``(path, dim, ways)`` for every sharded dimension that its mesh-axis
    product does not divide."""
    sizes = axis_sizes(mesh)
    problems = []
    for path, leaf, logical in logical_leaves(tree, logical_tree):
        for dim, entry in zip(leaf.shape, rules.resolve(*logical)):
            ways = 1
            for a in mesh_axes(entry):
                ways *= sizes[a]
            if dim % ways:
                problems.append((path, dim, ways))
    return problems


def _host_tensor(leaf: Any) -> torch.Tensor:
    """A tensor leaf as it is; a numpy leaf as a tensor over its memory
    (bfloat16 from ``ml_dtypes`` through its 16-bit pattern)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.ascontiguousarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def remesh(tree: Any, logical_tree: Any, rules: Rules, mesh: DeviceMesh,
           src_data_rank: int | None = 0) -> Any:
    """Re-place ``tree`` onto ``mesh`` under ``rules``: every array leaf
    becomes a ``DTensor`` with the placements its logical axes resolve to.
    Raises ``ValueError`` on a dimension that would not divide.
    ``src_data_rank=None``: each rank cuts its shard from its own ``tree``
    with no communication (every rank holds the same values, or ``meta``
    tensors)."""
    problems = validate_divisibility(tree, logical_tree, rules, mesh)
    if problems:
        raise ValueError(f"re-mesh would shard non-divisible dims: {problems[:5]}")

    def put(leaf: Any, logical: Any) -> DTensor:
        t = _host_tensor(leaf)
        return distribute_tensor(t, mesh, spec_to_placements(mesh, rules.resolve(*logical), t.ndim),
                                 src_data_rank=src_data_rank)

    return _map(put, tree, logical_tree)
