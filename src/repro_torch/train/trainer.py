"""Train-step factory: grad accumulation, aux metrics, optional grad clip.

The port of :mod:`repro.train.trainer`. ``make_train_step(loss_fn,
optimizer, microbatch)`` returns ``step(state, batch, input_logical=None)
→ (state, metrics)``:

- ``microbatch > 0`` splits the batch on its leading axis into equal
  chunks, runs forward and backward on each in turn and sums the gradients
  in ``accum_dtype``, then divides by the chunk count (the reference's
  ``lax.scan``, eagerly).
- Gradients come from ``torch.autograd.grad`` on detached leaves that share
  the parameters' storage, so no parameter is copied. A sparse gradient (an
  embedding lookup with ``sparse_grad=True``) stays sparse: the chunks'
  are summed, then coalesced, so the global norm counts each row once.
- ``grad_clip > 0`` scales every gradient by ``min(1, clip / norm)``.
- Several ranks: under :func:`~repro_torch.distributed.sharding_rules`
  with a mesh, every rank is given the whole batch. The inputs whose
  leading logical axis is ``"batch"`` (``input_logical``, the cell's
  :meth:`~repro_torch.models.api.Cell.input_logical`) are split over the
  ranks of the mesh axes ``"batch"`` resolves to: each rank takes, from
  each microbatch of the one-program step, its contiguous ``1/n`` (so a
  microbatch of ``m`` rows becomes ``m/n`` rows a rank, and an MoE's
  dispatch groups, one per sequence, stay whole). The loss runs under
  :func:`~repro_torch.distributed.parallel.rank_share`, so a count over
  the batch can cross ranks (BERT4Rec). Then the loss and the gradients
  are summed over the ranks and divided by their count before the norm,
  the clip and the optimizer: a plain gradient by ``all_reduce``, a
  sparse one by gathering every rank's rows (:func:`reduce_sparse_rows`),
  a ``DTensor`` one (parameters placed by
  :func:`~repro_torch.train.elastic.remesh`; the model computes on their
  ``"model"`` shards, :class:`~repro_torch.distributed.parallel.ModelAxis`)
  by redistributing it to its parameter's placements. Every rank takes
  the step the one-program step takes on the whole batch (to rounding).
- The inputs whose leading logical axis is ``"edges"`` (NequIP's
  ``edge_src`` and ``edge_dst``) are split the same way over the ranks of
  the axes ``"edges"`` resolves to, and the loss runs under
  :func:`~repro_torch.distributed.parallel.edge_share`. Those whose
  leading axis is ``"nodes"`` (NequIP's node arrays) are split over the
  ranks ``"nodes"`` resolves to, under
  :func:`~repro_torch.distributed.parallel.node_share`, where those ranks
  divide every one of them and the edges are split; else they go whole
  to every rank. The model's node gathers and sums cross those ranks, so
  the loss and every gradient come out whole on each of them and the
  step reduces nothing for them. Other inputs (per-graph targets) go
  whole to every rank.
- ``param_logical`` (the parameters' logical axes; the RecSys and NequIP
  cells bind it): a state of ``DTensor``\\ s whose every leaf is
  replicated over all mesh axes but ``"model"`` is stepped on its local
  shards, plain tensors, under
  :func:`~repro_torch.distributed.parallel.local_shards` (the model reads
  the ``"model"`` axis through ``ModelAxis.of``: RecSys's row-sharded
  tables, BERT4Rec's blocks); gradients are reduced over the batch ranks
  only (a table's sparse rows stay at this rank's local indices and are
  never gathered over ``"model"``), the global norm sums the squares of
  the shards over ``"model"``, the optimizer updates each shard (row-wise
  Adagrad's rows in place) and the new state goes back on the old
  placements.

Parameters are a flat ``dict[str, Tensor]``; the state is the reference's
``TrainState(params, opt_state, step)``.

``make_serve_step(fwd, input_logical, output_logical, ...)`` is the serving
counterpart: ``step(params, inputs) → outputs``, no gradients. Under
:func:`~repro_torch.distributed.sharding_rules` with a mesh, each rank
steps its share of the inputs (:func:`serve_input_logical`: the
``"batch"``, ``"cands"`` and ``"kv_seq"`` dimensions, each over the ranks
of the mesh axes it resolves to; a dimension those ranks do not divide
stays whole on every one of them, which computes the same rows). A plain
input is cut into a view of this rank's share; a ``DTensor`` input placed
by those axes gives its local shard. The model reads the shares through
:func:`~repro_torch.distributed.parallel.rank_share`,
:func:`~repro_torch.distributed.parallel.cand_share` and
:func:`~repro_torch.distributed.parallel.kv_share`. Outputs come back at
global shape, gathered over the axes that split them
(``output_logical``); an output that is an input written in place (a
decode step's caches) comes back as that input: a ``DTensor`` with its
local shard written, or the plain tensor with every rank's writes
gathered into it. A state of ``DTensor``\\ s replicated over all mesh
axes but ``"model"`` (RecSys's, the forest's) steps on its local shards,
as a train step with ``param_logical`` does; one split over another axis
too (the LM's, FSDP over "data") is used as it is, through
:meth:`~repro_torch.distributed.parallel.ModelAxis.use`. Without rules,
or on a one-rank mesh, the step is ``fwd`` itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections.abc import Callable
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.parallel import (
    MODEL_AXIS,
    WHOLE,
    Axis,
    ModelAxis,
    all_reduce_,
    axis_groups,
    cand_share,
    edge_share,
    gather_over,
    gather_parts,
    kv_share,
    local_shards,
    node_share,
    rank_share,
)
from repro_torch.distributed.sharding import constrain, current_mesh, current_rules, mesh_axes
from repro_torch.train.elastic import map_tree
from repro_torch.train.optimizer import Optimizer
from repro_torch.utils import tree_items


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: Any
    step: torch.Tensor  # int32 scalar


def init_state(params: dict[str, torch.Tensor], optimizer: Optimizer) -> TrainState:
    first = next(iter(params.values()))
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def _grads(loss_fn: Callable, params: dict[str, torch.Tensor], batch
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(params.items(), grads)
    }


def _values(g: torch.Tensor, fn: Callable) -> torch.Tensor:
    """``fn`` applied to a dense gradient, or to the stored rows of a
    coalesced sparse one."""
    if g.is_sparse:
        return torch.sparse_coo_tensor(g.indices(), fn(g.values()), g.shape,
                                       is_coalesced=True, check_invariants=False)
    return fn(g)


def _split_keys(batch: dict, input_logical: dict | None, axis: str = "batch") -> set:
    """The inputs whose leading logical axis is ``axis`` (for ``"batch"``,
    every input when no logical axes are given)."""
    if input_logical is None:
        return set(batch) if axis == "batch" else set()
    return {k for k in batch if tuple(input_logical.get(k) or (None,))[0] == axis}


#: The logical axes a train step splits its inputs' leading dimension over.
STEP_AXES = ("batch", "edges", "nodes")


def step_input_logical(input_logical: dict) -> dict:
    """The inputs' logical axes as the step splits them: each input's
    leading axis where it is one of :data:`STEP_AXES`, no other."""
    def cut(lg):
        lg = tuple(lg or ())
        return tuple(a if i == 0 and a in STEP_AXES else None for i, a in enumerate(lg))

    return {k: cut(v) for k, v in input_logical.items()}


def _rank_share(v: torch.Tensor, n: int, r: int, microbatch: int) -> torch.Tensor:
    """Rank ``r``'s rows of ``v``: its contiguous ``1/n`` of each
    microbatch of ``v``'s own leading axis (of the whole axis without
    microbatching)."""
    lead = v.shape[0]
    chunk = microbatch or lead
    if lead % chunk or chunk % n:
        raise ValueError(f"batch {lead} / microbatch {chunk} do not split over {n} ranks")
    part = chunk // n
    return v.reshape(lead // chunk, chunk, *v.shape[1:])[:, r * part:(r + 1) * part].reshape(
        -1, *v.shape[1:])


def reduce_sparse_rows(parts: list[torch.Tensor], n: int) -> torch.Tensor:
    """The mean of ``n`` ranks' sparse row gradients from their coalesced
    parts in rank order: the rows concatenated in that order, coalesced
    (a row's values summed), divided by ``n``. Every rank computes it from
    the same parts, so it is bit-equal on every rank."""
    first = parts[0]
    g = torch.sparse_coo_tensor(
        torch.cat([p.indices() for p in parts], dim=1),
        torch.cat([p.values() for p in parts]), first.shape, check_invariants=False,
    ).coalesce()
    return _values(g, lambda v: v / n)


def _reduce(g: torch.Tensor, p: torch.Tensor, groups: list, n: int) -> torch.Tensor:
    """A rank's gradient made the step's: a ``DTensor``'s reduced by its
    parameter's placements, a plain one summed over the batch ``groups``
    (sparse rows gathered), each divided by the ``n`` ranks the batch was
    split over."""
    if isinstance(g, DTensor):
        g = g.redistribute(p.device_mesh, p.placements)
        return g if n == 1 else g / n
    if n == 1:
        return g
    if g.is_sparse:
        idx = gather_parts(g.indices().t(), groups)
        val = gather_parts(g.values(), groups)
        return reduce_sparse_rows([
            torch.sparse_coo_tensor(i.t(), v, g.shape, is_coalesced=True, check_invariants=False)
            for i, v in zip(idx, val, strict=True)
        ], n)
    return all_reduce_(g, groups).div_(n)


def make_train_step(
    loss_fn: Callable,            # (params, batch) -> scalar loss
    optimizer: Optimizer,
    microbatch: int = 0,
    grad_clip: float = 0.0,
    accum_dtype: torch.dtype = torch.float32,
):
    def step(state: TrainState, batch, input_logical: dict | None = None,
             param_logical: dict | None = None) -> tuple[TrainState, dict]:
        placed = None
        if param_logical is not None and _on_local_shards(state.params):
            placed = state
            state = map_tree(lambda t, _: t.to_local() if isinstance(t, DTensor) else t,
                             state, state)
        params = state.params
        split = _split_keys(batch, input_logical)
        edges = _split_keys(batch, input_logical, "edges")
        nodes = _split_keys(batch, input_logical, "nodes")
        groups, n_dp, r_dp = axis_groups("batch") if split else ([], 1, 0)
        e_groups, n_e, r_e = axis_groups("edges") if edges else ([], 1, 0)
        n_groups, n_n, r_n = _node_groups(batch, nodes, n_e)
        mbatch = microbatch
        if n_dp > 1:
            batch = {k: _rank_share(v, n_dp, r_dp, microbatch) if k in split else v
                     for k, v in batch.items()}
            mbatch = microbatch // n_dp
        if n_e > 1:
            batch = {k: _rank_share(v, n_e, r_e, 0) if k in edges else v
                     for k, v in batch.items()}
        if n_n > 1:
            batch = {k: _rank_share(v, n_n, r_n, 0) if k in nodes else v
                     for k, v in batch.items()}
        with (rank_share(groups, n_dp, r_dp), edge_share(e_groups, n_e, r_e),
              node_share(n_groups, n_n, r_n)):
            tp = (ModelAxis.of(placed.params, lambda: param_logical) if placed is not None
                  else None)
            with local_shards(tp) if tp is not None else contextlib.nullcontext():
                if mbatch:
                    loss, grads = _accumulate(loss_fn, params, batch, split, mbatch,
                                              accum_dtype, state.step.device)
                else:
                    loss, grads = _grads(loss_fn, params, batch)
                    grads = {k: g.coalesce() if g.is_sparse else g for k, g in grads.items()}
        if n_dp > 1:
            loss = all_reduce_(loss.clone(), groups).div_(n_dp)
        grads = {k: _reduce(g, params[k], groups, n_dp) for k, g in grads.items()}

        if tp is not None and tp.size > 1:
            sharded = {k for k, p in placed.params.items() if _model_shard(p)}
            gnorm = optax_global_norm(grads, sharded, tp)
        else:
            gnorm = optax_global_norm(grads)
        if grad_clip > 0:
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = {k: _values(g, lambda v: v * scale) for k, g in grads.items()}

        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        new_state = TrainState(params=new_params, opt_state=new_opt, step=state.step + 1)
        if placed is not None:
            new_state = _rewrap(new_state, placed)
        else:
            new_state = _placed_like(new_state, state)
        if isinstance(gnorm, DTensor):
            gnorm = gnorm.full_tensor()
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def _node_groups(batch: dict, nodes: set, n_edges: int) -> tuple[list, int, int]:
    """``(groups, n, r)`` of the ranks ``"nodes"`` resolves to, where they
    divide every node input's leading dimension and the edges are split
    (``n_edges`` ranks); ``([], 1, 0)`` otherwise: the nodes stay whole."""
    if not nodes or n_edges == 1:
        return [], 1, 0
    groups, n, r = axis_groups("nodes")
    if n == 1 or any(batch[k].shape[0] % n for k in nodes):
        return [], 1, 0
    return groups, n, r


def _model_shard(p: Any) -> bool:
    """Whether ``p`` is a ``DTensor`` split over ``"model"``."""
    if not isinstance(p, DTensor):
        return False
    names = p.device_mesh.mesh_dim_names
    return isinstance(p.placements[names.index(MODEL_AXIS)], Shard)


def _on_local_shards(params: Any, strict: bool = True) -> bool:
    """Whether ``params`` (a tree) are ``DTensor``\\ s replicated over every
    mesh axis but ``"model"``. Where they are ``DTensor``\\ s otherwise
    placed (such a state needs the ``DTensor`` step), raises if
    ``strict``, else says no."""
    leaves = [p for _, p in tree_items(params) if isinstance(p, DTensor)]
    if not leaves:
        return False
    for p in leaves:
        names = p.device_mesh.mesh_dim_names
        if any(n != MODEL_AXIS and not isinstance(pl, Replicate)
               for n, pl in zip(names, p.placements)):
            if not strict:
                return False
            raise ValueError(f"a local-shard step needs every leaf replicated over all axes "
                             f"but {MODEL_AXIS!r}; got {p.placements}")
    return True


def _rewrap(new: TrainState, placed: TrainState) -> TrainState:
    """``new``'s local tensors as ``DTensor``\\ s on the placements of
    the same leaves of ``placed``."""
    def wrap(t: Any, old: Any) -> Any:
        if not isinstance(old, DTensor):
            return t
        return DTensor.from_local(t, old.device_mesh, old.placements, run_check=False,
                                  shape=old.shape, stride=old.stride())

    return map_tree(wrap, new, placed)


def _placed_like(new: Any, old: Any) -> Any:
    """``new`` with every ``DTensor`` leaf redistributed to the placements
    of the same leaf of ``old``: a reduction over a sharded dimension (an
    Adafactor moment) leaves its result ``Partial``, and the state keeps
    the placements its logical axes give it."""
    if isinstance(new, DTensor):
        if isinstance(old, DTensor) and tuple(new.placements) != tuple(old.placements):
            return new.redistribute(old.device_mesh, old.placements)
        return new
    if isinstance(new, dict):
        return {k: _placed_like(v, old[k]) for k, v in new.items()}
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{f.name: _placed_like(getattr(new, f.name),
                                                                getattr(old, f.name))
                                           for f in dataclasses.fields(new)})
    return new


def _accumulate(loss_fn: Callable, params: dict, batch: dict, split: set, mbatch: int,
                accum_dtype: torch.dtype, device: torch.device
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The mean loss and gradients over the microbatches of ``mbatch``
    rows of the split inputs (the others go whole to every microbatch)."""
    lead = {batch[k].shape[0] for k in split}
    if len(lead) != 1 or next(iter(lead)) % mbatch:
        raise ValueError(f"batch {sorted(lead)} is not one multiple of microbatch {mbatch}")
    n_chunks = next(iter(lead)) // mbatch
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    gsum: dict[str, torch.Tensor] = {}
    for c in range(n_chunks):
        mb = {k: constrain(v[c * mbatch:(c + 1) * mbatch], "batch", *([None] * (v.ndim - 1)))
              if k in split else v for k, v in batch.items()}
        loss, g = _grads(loss_fn, params, mb)
        loss_sum = loss_sum + loss
        for k, gk in g.items():
            if gk.is_sparse:
                gsum[k] = gk if k not in gsum else gsum[k] + gk
            else:
                acc = gsum.get(k)
                if acc is None:
                    acc = torch.zeros_like(gk, dtype=accum_dtype)
                gsum[k] = acc + gk.to(accum_dtype)
        del g   # the next chunk's backward runs without this one's gradients
    # Dense sums are divided in place (the same arithmetic): a second
    # float32 copy of every gradient would not fit beside an LM's state.
    grads = {
        k: _values(g.coalesce(), lambda v: v / n_chunks) if g.is_sparse else g.div_(n_chunks)
        for k, g in gsum.items()
    }
    return loss_sum / n_chunks, grads


def optax_global_norm(grads: dict[str, torch.Tensor], sharded: set = frozenset(),
                      tp: ModelAxis | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient; a coalesced sparse
    gradient counts its stored rows (each row once). The gradients named in
    ``sharded`` are this rank's shards over ``tp``'s axis: their squares
    are summed over it."""
    def sq(g):
        return torch.sum(torch.square((g.values() if g.is_sparse else g).float()))

    if not sharded:
        return torch.sqrt(sum(sq(g) for g in grads.values()))
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    split = sum((sq(g) for k, g in grads.items() if k in sharded), zero)
    whole = sum((sq(g) for k, g in grads.items() if k not in sharded), zero)
    return torch.sqrt(tp.reduce(split) + whole)


# ---------------------------------------------------------------------------
# The serving step.
# ---------------------------------------------------------------------------

#: The logical axes a serving step splits its inputs over.
SERVE_AXES = ("batch", "cands", "kv_seq")


def _map_logical(fn: Callable[[tuple], Any], logical: Any) -> Any:
    if isinstance(logical, dict):
        return {k: _map_logical(fn, v) for k, v in logical.items()}
    return fn(tuple(logical or ()))


def serve_input_logical(input_logical: dict) -> dict:
    """The serving inputs' logical axes as the serving step splits them:
    ``"batch"``, ``"cands"`` and ``"kv_seq"`` where they stand (a decode
    cache's ``(None, "batch", "kv_seq", None, None)``), no other."""
    return _map_logical(lambda lg: tuple(a if a in SERVE_AXES else None for a in lg),
                        input_logical)


def _zip_map(fn: Callable[[Any, tuple], Any], tree: Any, logical: Any) -> Any:
    """``tree`` (dicts, lists and tuples of leaves) with each leaf replaced
    by ``fn(leaf, its logical axes)``."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, logical[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, lg) for v, lg in zip(tree, logical, strict=True))
    return fn(tree, tuple(logical or ()))


def _serve_shares(inputs: dict, axes: dict, kv_len: int) -> dict[str, tuple[list, int, int]]:
    """``{axis: (groups, n, r)}`` for each of :data:`SERVE_AXES` that the
    step splits: the ranks it resolves to divide every input dimension it
    names (and ``kv_len``, the caches' length, for ``"kv_seq"``)."""
    sizes: dict[str, set] = {a: set() for a in SERVE_AXES}
    if kv_len:
        sizes["kv_seq"].add(kv_len)

    def note(v, lg):
        for d, a in enumerate(lg):
            if a is not None and isinstance(v, torch.Tensor):
                sizes[a].add(v.shape[d])

    _zip_map(note, inputs, axes)
    shares = {}
    for a, dims in sizes.items():
        if dims:
            groups, n, r = axis_groups(a)
            if n > 1 and all(d % n == 0 for d in dims):
                shares[a] = (groups, n, r)
    return shares


def _cand_model_part() -> Axis:
    """The ``"model"`` part of a candidate share (:data:`WHOLE` where
    ``"model"`` does not cut it): ``"model"`` must be its minor axis, so
    that a data block's ``"model"`` ranks hold consecutive parts of it."""
    mesh, rules = current_mesh(), current_rules()
    names = mesh.mesh_dim_names
    axes = [a for a in mesh_axes(rules.physical("cands")) if mesh.size(names.index(a)) > 1]
    if MODEL_AXIS not in axes:
        return WHOLE
    if axes[-1] != MODEL_AXIS:
        raise ValueError(f"candidates split over {axes}: {MODEL_AXIS!r} must be the minor axis")
    d = names.index(MODEL_AXIS)
    return Axis(mesh.get_group(MODEL_AXIS), mesh.size(d), mesh.get_coordinate()[d])


def make_serve_step(fwd: Callable, input_logical: dict, output_logical: Any,
                    param_logical: dict | None = None, kv_len: int = 0):
    """``step(params, inputs) → fwd(params, inputs)``'s outputs, split as
    the module docstring says. ``param_logical``: the parameters' logical
    axes (a flat dict of parameters), read by ``ModelAxis.of`` for a state
    stepped on its local shards; ``kv_len``: the length of the caches'
    ``"kv_seq"`` dimension, which an output (prefill's caches) may have
    alone."""
    axes = serve_input_logical(input_logical)
    locals_of: dict[int, tuple[weakref.ref, Any]] = {}   # a placed dataclass → its local view

    def to_local(tree: Any) -> Any:
        """``tree`` with every ``DTensor`` leaf's local shard; a dataclass
        (a forest's ensemble) is unwrapped once and its local view kept
        for as long as it lives, so the view's caches live as long."""
        if isinstance(tree, DTensor):
            return tree.to_local()
        if isinstance(tree, dict):
            return {k: to_local(v) for k, v in tree.items()}
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            ref, view = locals_of.get(id(tree), (None, None))
            if ref is None or ref() is not tree:
                view = map_tree(lambda t, _: t.to_local() if isinstance(t, DTensor) else t,
                                tree, tree)
                key = id(tree)
                locals_of[key] = (weakref.ref(tree, lambda _: locals_of.pop(key, None)), view)
            return view
        return tree

    @torch.no_grad()
    def step(params, inputs):
        tp = None
        if _on_local_shards(params, strict=False):
            if param_logical is not None:
                tp = ModelAxis.of(params, lambda: param_logical)
            params = to_local(params)
        shares = _serve_shares(inputs, axes, kv_len)
        views: dict[int, tuple[Any, list, torch.Tensor]] = {}

        def cut(v, lg):
            if not isinstance(v, torch.Tensor):
                return v
            dims = [(d, shares[a]) for d, a in enumerate(lg) if a in shares]
            if isinstance(v, DTensor):
                mine = v.to_local()
                want = list(v.shape)
                for d, (_, n, _) in dims:
                    want[d] //= n
                if list(mine.shape) != want:
                    raise ValueError(f"a placed input's shard is {list(mine.shape)}, the step's "
                                     f"share {want}")
            else:
                mine = v
                for d, (_, n, r) in dims:
                    size = v.shape[d] // n
                    mine = mine.narrow(d, r * size, size)
            if mine is not v:
                views[id(mine)] = (v, dims, mine)
            return mine

        def join(t, lg):
            if not isinstance(t, torch.Tensor):
                return t
            if id(t) in views and views[id(t)][2] is t:   # an input written in place
                whole, dims, _ = views[id(t)]
                if isinstance(whole, DTensor):
                    return whole
                for d, (groups, _, _) in dims:
                    t = gather_over(t, d, groups)
                return whole.copy_(t)
            for d, a in enumerate(lg):
                if a in shares:
                    t = gather_over(t, d, shares[a][0])
            return t

        mine = _zip_map(cut, inputs, axes)
        with contextlib.ExitStack() as ctx:
            if "batch" in shares:
                ctx.enter_context(rank_share(*shares["batch"]))
            if "kv_seq" in shares:
                ctx.enter_context(kv_share(*shares["kv_seq"]))
            if "cands" in shares:
                ctx.enter_context(cand_share(_cand_model_part()))
            if tp is not None:
                ctx.enter_context(local_shards(tp))
            out = fwd(params, mine)
        return _zip_map(join, out, output_logical)

    return step
