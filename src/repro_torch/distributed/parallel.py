"""The collectives of the several-card train step.

Two kinds of parallelism, both read from the current
:func:`~repro_torch.distributed.sharding_rules` and their mesh:

- **Rank shares over "batch".** The train step gives each rank of the mesh
  axes that ``"batch"`` resolves to its share of every batch-leading input
  and runs the loss under :func:`rank_share`. A loss whose denominator is a
  count over the batch (BERT4Rec's masked positions) reads the whole
  batch's count through :func:`batch_total`; the step then all-reduces the
  gradients (:func:`all_reduce_`) or, for sparse rows, gathers every
  rank's part (:func:`gather_parts`).
- **Tensor and expert parallelism over "model".** Parameters placed as
  ``DTensor``\\ s (:func:`~repro_torch.train.elastic.remesh`) are used
  through :meth:`ModelAxis.use`: their shards over every other mesh axis
  are all-gathered for the use (FSDP) and their ``"model"`` shard stays
  local. The model then runs on local tensors with explicit collectives
  over the ``"model"`` group: :meth:`ModelAxis.copy` (identity forward,
  gradient summed over the group), :meth:`ModelAxis.reduce` (sum forward,
  identity backward), :meth:`ModelAxis.gather` (all-gather forward; the
  local slice, or the sum of the ranks' slices, backward) and
  :meth:`ModelAxis.max`, where :meth:`ModelAxis.on` says the parameters
  split a logical axis over ``"model"`` (read from their placements by
  :meth:`ModelAxis.of`; plain parameters get :data:`LOCAL`, on which
  every collective is the identity). The gradient of a parameter reaches its
  ``DTensor`` leaf with the placements it is reduced by: ``Partial`` over
  the batch axes the batch was split over, the parameter's own placement
  over ``"model"``.

The ``"model"`` collectives are ``torch.distributed._functional_collectives``
ops, so a step traced on ``meta`` tensors over a fake group records them
(:mod:`repro_torch.launch.dryrun`); a ``"model"`` axis of one rank runs
none.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import current_mesh, current_rules, mesh_axes

MODEL_AXIS = "model"


# The names differ between PyTorch versions.
_ALL_GATHER = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_REDUCE_SCATTER = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    return _wait(funcol.all_reduce(t, "sum", group))


# ---------------------------------------------------------------------------
# Rank shares over "batch".
# ---------------------------------------------------------------------------


def batch_groups() -> tuple[list, int, int]:
    """``(groups, n, r)``: the process groups of the mesh axes that
    ``"batch"`` resolves to (those of more than one rank), their rank count
    and this rank's index among them (major to minor); ``([], 1, 0)``
    without rules or mesh."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return [], 1, 0
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    groups, n, r = [], 1, 0
    for a in mesh_axes(rules.physical("batch")):
        size = mesh.size(names.index(a))
        if size > 1:
            groups.append(mesh.get_group(a))
        n, r = n * size, r * size + coord[names.index(a)]
    return groups, n, r


_SHARE: contextvars.ContextVar[tuple[list, int] | None] = contextvars.ContextVar(
    "rank_share", default=None)


@contextlib.contextmanager
def rank_share(groups: list, n: int) -> Iterator[None]:
    """Mark the block as running this rank's share of a batch split over
    the ``n`` ranks of ``groups`` (no mark for ``n == 1``)."""
    token = _SHARE.set((groups, n) if n > 1 else None)
    try:
        yield
    finally:
        _SHARE.reset(token)


def split_ranks() -> int:
    """The ranks the current batch is split over (1 outside a share)."""
    share = _SHARE.get()
    return 1 if share is None else share[1]


def all_reduce_(t: torch.Tensor, groups: list) -> torch.Tensor:
    """``t`` summed over every rank of ``groups``, in place."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def batch_total(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(x summed over the ranks sharing the batch, their count)``; ``(x,
    1)`` outside a rank share. The sum is not differentiated."""
    share = _SHARE.get()
    if share is None:
        return x, 1
    groups, n = share
    return all_reduce_(x.detach().clone(), groups), n


def _gather_lists(parts: list[torch.Tensor], group: Any) -> list[torch.Tensor]:
    """Every rank of ``group``'s list of parts (each rank holds as many),
    concatenated in rank order."""
    size = dist.get_world_size(group)
    lens = torch.tensor([p.shape[0] for p in parts], dtype=torch.int64, device=parts[0].device)
    all_lens = [torch.empty_like(lens) for _ in range(size)]
    dist.all_gather(all_lens, lens, group=group)
    width = max(int(x.sum()) for x in all_lens)
    flat = torch.cat(parts)
    flat = torch.cat([flat, flat.new_zeros((width - flat.shape[0], *flat.shape[1:]))])
    got = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(got, flat, group=group)
    out = []
    for block, ln in zip(got, all_lens):
        out.extend(block.split(ln.tolist() + [width - int(ln.sum())])[:-1])
    return out


def gather_parts(t: torch.Tensor, groups: list) -> list[torch.Tensor]:
    """Every rank's ``t`` (leading dimensions may differ), in rank order
    (major to minor over ``groups``)."""
    parts = [t.contiguous()]
    for g in reversed(groups):       # the minor axis first
        parts = _gather_lists(parts, g)
    return parts


# ---------------------------------------------------------------------------
# Tensor and expert parallelism over "model".
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, grad):
        ctx.dim, ctx.rank, ctx.n, ctx.group, ctx.grad = dim, rank, x.shape[dim], group, grad
        return _wait(_ALL_GATHER(x.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _wait(_REDUCE_SCATTER(g.contiguous(), "sum", ctx.dim, ctx.group))
        else:
            g = g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)
        return g, None, None, None, None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The ``"model"`` axis of the mesh a model's ``DTensor`` parameters
    live on: its group, size and this rank's index, the logical axes its
    parameters are split over on it, and the mesh axes the current batch
    is split over."""

    split: frozenset[str]
    batch_axes: frozenset[str]
    group: Any
    size: int
    rank: int

    @staticmethod
    def of(params: dict[str, torch.Tensor],
           logical: Callable[[], dict[str, tuple]]) -> ModelAxis:
        """The axis of ``params``' mesh (:data:`LOCAL` for plain tensors or
        a mesh without ``"model"``). Which logical axes (``logical()``, by
        parameter; called for ``DTensor`` parameters only) are split over ``"model"`` is read from the parameters'
        own placements, not from the rules in force: a step under another
        table than the one that placed them still computes on what each
        rank holds. Raises ``ValueError`` where the placements disagree
        (one leaf split on a logical axis, another whole on it) and where
        the batch is split over ``"model"`` too."""
        first = next(iter(params.values()))
        if not isinstance(first, DTensor) or MODEL_AXIS not in (
                first.device_mesh.mesh_dim_names or ()):
            return LOCAL
        mesh = first.device_mesh
        d = mesh.mesh_dim_names.index(MODEL_AXIS)
        size = mesh.size(d)
        split: set[str] = set()
        whole: set[str] = set()
        if size > 1:   # a Shard over one rank splits nothing
            axes = logical()
            for k, w in params.items():
                pl = w.placements[d]
                for dim, name in enumerate(axes[k]):
                    if name is not None:
                        (split if isinstance(pl, Shard) and pl.dim == dim else whole).add(name)
        if split & whole:
            raise ValueError(f"parameters disagree on {sorted(split & whole)} over {MODEL_AXIS!r}")
        rules = current_rules()
        batch = frozenset(mesh_axes(rules.physical("batch"))) if rules is not None else frozenset()
        if size > 1 and split_ranks() > 1 and MODEL_AXIS in batch:
            raise ValueError(f"the batch is split over {MODEL_AXIS!r}, which holds the "
                             "parameters' tensor-parallel shards")
        return ModelAxis(frozenset(split), batch, mesh.get_group(MODEL_AXIS), size,
                         mesh.get_coordinate()[d])

    def on(self, logical: str) -> bool:
        """Whether the parameters split the logical axis over ``"model"``."""
        return logical in self.split

    def use(self, w: torch.Tensor) -> torch.Tensor:
        """The local tensor a step computes with: ``w`` gathered over every
        mesh axis but ``"model"``, its ``"model"`` shard kept. Its gradient
        returns to ``w`` as ``Partial`` over the axes the batch is split
        over (:func:`rank_share`), as ``w``'s own placement elsewhere (a
        sharded axis is reduce-scattered on the way back)."""
        if not isinstance(w, DTensor):
            return w
        split = self.batch_axes if split_ranks() > 1 else frozenset()
        target, grad = [], []
        for name, pl in zip(w.device_mesh.mesh_dim_names, w.placements):
            if name == MODEL_AXIS:
                target.append(pl)
                grad.append(pl)
            else:
                target.append(Replicate())
                grad.append(Partial() if name in split else Replicate())
        if tuple(target) != tuple(w.placements):
            w = w.redistribute(w.device_mesh, target)
        return w.to_local(grad_placements=grad)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged; its gradient summed over the group (where a
        replicated tensor enters sharded computation)."""
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group; the gradient passes unchanged."""
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int, grad: str = "slice") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order. Each
        rank's gradient is its own slice of the gradient (``"slice"``:
        what follows runs alike on every rank) or the sum of every rank's
        slices (``"sum"``: what follows gives each rank a part)."""
        if self.size == 1:
            return x
        return _Gather.apply(x, dim, self.group, self.rank, grad)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise maximum over the group (not differentiated)."""
        if self.size == 1:
            return x.detach()
        return _wait(funcol.all_reduce(x.detach().contiguous(), "max", self.group))


#: The axis of plain parameters: one rank, nothing split; every collective
#: is the identity.
LOCAL = ModelAxis(frozenset(), frozenset(), None, 1, 0)
