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

- **Local shards** (RecSys, NequIP). A step that runs on its parameters'
  local shards (:func:`local_shards`: each ``DTensor`` leaf replicated over
  every axis but ``"model"``) gives the model plain tensors;
  :meth:`ModelAxis.of` then returns the axis those shards were cut on, so
  a row-sharded table (``"rows"`` → "model") is looked up as the LM's
  vocab-sharded embedding is.
- **Edges and nodes over their ranks** (NequIP). The train step gives
  each rank of the mesh axes that ``"edges"`` resolves to its contiguous
  share of the edges and runs the loss under :func:`edge_share`; where
  the ranks that ``"nodes"`` resolves to (N, a subset of the edge ranks)
  divide the node arrays, each takes its contiguous share of those too,
  under :func:`node_share`. The other edge ranks (M) hold the same node
  share. The model gathers its node arrays at its edges through
  :meth:`NodeAxis.gather_nodes` (all-gather over N) and sums its per-edge
  messages into its node share through :meth:`NodeAxis.scatter_nodes`
  (reduce-scatter over N, then all-reduce over M); with the nodes whole
  (N of one rank) these are :meth:`Axis.copy` and :meth:`Axis.reduce`
  over every edge rank (:func:`edge_axis`, :func:`node_axis`).
- **Serving shares** (:func:`~repro_torch.train.trainer.make_serve_step`).
  A serving step gives each rank its share of the queries (:func:`rank_share`;
  :func:`batch_axis` gathers a decode step's tokens for its one MoE
  dispatch group), of the candidates (:func:`cand_share`: the part of the
  share cut over ``"model"``, whose ranks exchange ids and rows with a
  row-sharded table) and of the LM caches' sequence (:func:`kv_share`:
  each rank attends over its slice and the partial softmaxes merge through
  :meth:`Axis.max` and :meth:`Axis.reduce`). :meth:`Axis.gather` and
  :meth:`Axis.scatter` are not differentiated.

``copy`` and ``reduce`` are each other's transposes, and each one's
backward is the other's autograd op, so they can be differentiated twice
(NequIP's forces loss differentiates a gradient); so are
``gather_nodes`` and ``scatter_nodes``. The collectives are
``torch.distributed._functional_collectives`` ops, so a step traced on
``meta`` tensors over a fake group records them
(:mod:`repro_torch.launch.dryrun`); an axis of one rank runs none.
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


def _groups(group: Any) -> tuple:
    """A group, or a tuple or list of groups (major to minor), as a tuple."""
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def _sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group``, or over each group of a tuple in turn."""
    for g in _groups(group):
        t = _wait(funcol.all_reduce(t, "sum", g))
    return t


def gather_over(t: torch.Tensor, dim: int, groups: Any) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (major to
    minor over ``groups``: the minor axis is gathered first). Booleans
    travel as bytes. Not differentiated."""
    flag = t.dtype == torch.bool
    t = t.detach().to(torch.uint8) if flag else t.detach()
    for g in reversed(_groups(groups)):
        t = _wait(_ALL_GATHER(t.contiguous(), dim, g))
    return t.bool() if flag else t


def scatter_over(t: torch.Tensor, dim: int, groups: Any) -> torch.Tensor:
    """``t`` summed over the ranks of ``groups``, of which each keeps its
    own block of ``dim`` in rank order (a reduce-scatter over each group,
    major first: its block holds the minor ones'). Not differentiated."""
    t = t.detach()
    for g in _groups(groups):
        t = _wait(_REDUCE_SCATTER(t.contiguous(), "sum", dim, g))
    return t


# ---------------------------------------------------------------------------
# Rank shares over "batch".
# ---------------------------------------------------------------------------


def axis_groups(logical: str) -> tuple[list, int, int]:
    """``(groups, n, r)``: the process groups of the mesh axes that
    ``logical`` resolves to (those of more than one rank), their rank count
    and this rank's index among them (major to minor); ``([], 1, 0)``
    without rules or mesh."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return [], 1, 0
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    groups, n, r = [], 1, 0
    for a in mesh_axes(rules.physical(logical)):
        size = mesh.size(names.index(a))
        if size > 1:
            groups.append(mesh.get_group(a))
        n, r = n * size, r * size + coord[names.index(a)]
    return groups, n, r


_SHARE: contextvars.ContextVar[tuple[list, int, int] | None] = contextvars.ContextVar(
    "rank_share", default=None)


@contextlib.contextmanager
def rank_share(groups: list, n: int, r: int = 0) -> Iterator[None]:
    """Mark the block as running this rank's share (index ``r``) of a batch
    split over the ``n`` ranks of ``groups`` (no mark for ``n == 1``)."""
    token = _SHARE.set((groups, n, r) if n > 1 else None)
    try:
        yield
    finally:
        _SHARE.reset(token)


def batch_axis() -> Axis:
    """The ranks the current batch is split over (:data:`WHOLE` outside a
    share)."""
    share = _SHARE.get()
    return WHOLE if share is None else Axis(tuple(share[0]), share[1], share[2])


def split_ranks() -> int:
    """The ranks the current batch is split over (1 outside a share)."""
    share = _SHARE.get()
    return 1 if share is None else share[1]


def all_reduce_(t: torch.Tensor, groups: list) -> torch.Tensor:
    """``t`` summed over every rank of ``groups``: in place, or in a
    contiguous copy of a strided ``t`` (NCCL takes no other; a matmul's
    weight gradient may come back transposed)."""
    if groups and not t.is_contiguous():
        t = t.contiguous()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def batch_total(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(x summed over the ranks sharing the batch, their count)``; ``(x,
    1)`` outside a rank share. The sum is not differentiated."""
    share = _SHARE.get()
    if share is None:
        return x, 1
    groups, n, _ = share
    return all_reduce_(x.detach().clone(), groups), n


def _gather_lists(parts: list[torch.Tensor], group: Any) -> list[torch.Tensor]:
    """Every rank of ``group``'s list of parts (each rank holds as many),
    concatenated in rank order."""
    size = dist.get_world_size(group)
    if parts[0].is_meta:
        # A trace on meta (the dry run) cannot read the lengths: every
        # rank's parts are taken as long as this rank's.
        return [p for _ in range(size) for p in parts]
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
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


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
class Axis:
    """Ranks that split a computation: their process ``group`` (or a tuple
    of groups, one per mesh axis, summed over in turn), their count and
    this rank's index among them."""

    group: Any
    size: int
    rank: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged; its gradient summed over the ranks (where a
        whole tensor enters the split computation)."""
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks; the gradient passes unchanged."""
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise maximum over the ranks (not differentiated)."""
        x = x.detach()
        if self.size == 1:
            return x
        for g in _groups(self.group):
            x = _wait(funcol.all_reduce(x.contiguous(), "max", g))
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (not
        differentiated)."""
        return x if self.size == 1 else gather_over(x, dim, self.group)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the ranks, of which each keeps its own
        ``1/size`` of ``dim`` in rank order (a reduce-scatter; not
        differentiated)."""
        return x.detach() if self.size == 1 else scatter_over(x, dim, self.group)


@dataclasses.dataclass(frozen=True)
class ModelAxis(Axis):
    """The ``"model"`` axis of the mesh a model's ``DTensor`` parameters
    live on: its group, size and this rank's index, the logical axes its
    parameters are split over on it, and the mesh axes the current batch
    is split over."""

    split: frozenset[str]
    batch_axes: frozenset[str]

    @staticmethod
    def of(params: dict[str, torch.Tensor],
           logical: Callable[[], dict[str, tuple]]) -> ModelAxis:
        """The axis of ``params``' mesh (for plain tensors, the axis of the
        local shards a step runs on, :func:`local_shards`, else
        :data:`LOCAL`; :data:`LOCAL` on a mesh without ``"model"``).
        Which logical axes (``logical()``, by
        parameter; called for ``DTensor`` parameters only) are split over ``"model"`` is read from the parameters'
        own placements, not from the rules in force: a step under another
        table than the one that placed them still computes on what each
        rank holds. Raises ``ValueError`` where the placements disagree
        (one leaf split on a logical axis, another whole on it) and where
        the batch is split over ``"model"`` too."""
        first = next(iter(params.values()))
        if not isinstance(first, DTensor):
            return _SHARDS.get()
        if MODEL_AXIS not in (first.device_mesh.mesh_dim_names or ()):
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
        return ModelAxis(mesh.get_group(MODEL_AXIS), size, mesh.get_coordinate()[d],
                         frozenset(split), batch)

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

    def gather(self, x: torch.Tensor, dim: int, grad: str = "slice") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order. Each
        rank's gradient is its own slice of the gradient (``"slice"``:
        what follows runs alike on every rank) or the sum of every rank's
        slices (``"sum"``: what follows gives each rank a part)."""
        if self.size == 1:
            return x
        return _Gather.apply(x, dim, self.group, self.rank, grad)


#: The axis of plain parameters: one rank, nothing split; every collective
#: is the identity.
LOCAL = ModelAxis(None, 1, 0, frozenset(), frozenset())


_SHARDS: contextvars.ContextVar[ModelAxis] = contextvars.ContextVar("local_shards",
                                                                  default=LOCAL)


@contextlib.contextmanager
def local_shards(tp: ModelAxis) -> Iterator[None]:
    """Mark the block as running on parameters' local shards cut on
    ``tp``'s axis: :meth:`ModelAxis.of` returns ``tp`` for plain tensors."""
    token = _SHARDS.set(tp)
    try:
        yield
    finally:
        _SHARDS.reset(token)


# ---------------------------------------------------------------------------
# Edges over their ranks.
# ---------------------------------------------------------------------------


#: One rank: every collective is the identity.
WHOLE = Axis((), 1, 0)

_EDGES: contextvars.ContextVar[Axis] = contextvars.ContextVar("edge_share", default=WHOLE)


@contextlib.contextmanager
def edge_share(groups: list, n: int, r: int) -> Iterator[None]:
    """Mark the block as running this rank's share (index ``r``) of edges
    split over the ``n`` ranks of ``groups``."""
    token = _EDGES.set(Axis(tuple(groups), n, r) if n > 1 else WHOLE)
    try:
        yield
    finally:
        _EDGES.reset(token)


def edge_axis() -> Axis:
    """The ranks the current step's edges are split over (:data:`WHOLE`
    outside an edge share)."""
    return _EDGES.get()


# ---------------------------------------------------------------------------
# Nodes over their ranks.
# ---------------------------------------------------------------------------


class _NodeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nodes, rest):
        ctx.nodes, ctx.rest = nodes, rest
        return gather_over(x, 0, nodes) if nodes else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _NodeScatter.apply(g, ctx.nodes, ctx.rest), None, None


class _NodeScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nodes, rest):
        ctx.nodes, ctx.rest = nodes, rest
        return _sum(scatter_over(x, 0, nodes).contiguous(), rest)

    @staticmethod
    def backward(ctx, g):
        return _NodeGather.apply(g, ctx.nodes, ctx.rest), None, None


@dataclasses.dataclass(frozen=True)
class NodeAxis(Axis):
    """The ranks a step's node arrays are split over (N: ``group``, a tuple
    of groups, ``size`` and ``rank`` as :class:`Axis`, whose ``copy`` and
    ``reduce`` act over N), and ``rest``: the groups of the other ranks its
    edges are split over (M), which hold the same node share."""

    rest: tuple = ()

    def gather_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """The whole node array from this rank's share ``x``: all-gathered
        over N. Its gradient, a partial sum on every edge rank, comes back
        summed over them all, this rank's share kept
        (:meth:`scatter_nodes`)."""
        if self.size == 1 and not self.rest:
            return x
        return _NodeGather.apply(x, self.group, self.rest)

    def scatter_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's node share of ``x`` (whole nodes; a partial sum on
        each edge rank) summed over every edge rank: reduce-scattered over
        N, then summed over M. Its gradient is all-gathered over N
        (:meth:`gather_nodes`)."""
        if self.size == 1 and not self.rest:
            return x
        return _NodeScatter.apply(x, self.group, self.rest)


_NODES: contextvars.ContextVar[Axis] = contextvars.ContextVar("node_share", default=WHOLE)


@contextlib.contextmanager
def node_share(groups: list, n: int, r: int) -> Iterator[None]:
    """Mark the block as running this rank's share (index ``r``) of node
    arrays split over the ``n`` ranks of ``groups``, each of which must
    split the edges too (:func:`node_axis`)."""
    token = _NODES.set(Axis(tuple(groups), n, r) if n > 1 else WHOLE)
    try:
        yield
    finally:
        _NODES.reset(token)


def node_axis() -> NodeAxis:
    """The ranks the current step's nodes are split over and the other
    ranks of its edge share (every edge rank, with the nodes whole).
    Raises ``ValueError`` where a node rank's group does not split the
    edges."""
    nodes, edges = _NODES.get(), _EDGES.get()
    if any(g not in edges.group for g in nodes.group):
        raise ValueError("the nodes are split over mesh axes that do not split the edges: "
                         "\"nodes\" must resolve to a subset of the axes \"edges\" resolves to")
    return NodeAxis(nodes.group, nodes.size, nodes.rank,
                    tuple(g for g in edges.group if g not in nodes.group))


# ---------------------------------------------------------------------------
# Serving shares: candidates and the caches' sequence.
# ---------------------------------------------------------------------------


_CANDS: contextvars.ContextVar[Axis] = contextvars.ContextVar("cand_share", default=WHOLE)
_KV: contextvars.ContextVar[Axis] = contextvars.ContextVar("kv_share", default=WHOLE)


@contextlib.contextmanager
def cand_share(axis: Axis) -> Iterator[None]:
    """Mark the block as scoring this rank's share of the candidates, whose
    ranks over ``"model"`` (``axis``, the minor part of the share) hold
    consecutive parts of one block."""
    token = _CANDS.set(axis)
    try:
        yield
    finally:
        _CANDS.reset(token)


def cand_axis() -> Axis:
    """The ``"model"`` ranks the current candidates are split over
    (:data:`WHOLE` outside a share cut over ``"model"``)."""
    return _CANDS.get()


@contextlib.contextmanager
def kv_share(groups: list, n: int, r: int) -> Iterator[None]:
    """Mark the block as holding this rank's slice (index ``r``) of the KV
    caches' sequence, split over the ``n`` ranks of ``groups``."""
    token = _KV.set(Axis(tuple(groups), n, r) if n > 1 else WHOLE)
    try:
        yield
    finally:
        _KV.reset(token)


def kv_axis() -> Axis:
    """The ranks the current caches' sequence is split over (:data:`WHOLE`
    outside a share)."""
    return _KV.get()
