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
  dispatch groups, one per sequence, stay whole). Other inputs go whole
  to every rank; a step with no split input runs whole on every rank and
  reduces nothing (NequIP's graph batches). The loss runs under
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

Parameters are a flat ``dict[str, Tensor]``; the state is the reference's
``TrainState(params, opt_state, step)``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.parallel import (
    all_reduce_,
    batch_groups,
    gather_parts,
    rank_share,
)
from repro_torch.distributed.sharding import constrain
from repro_torch.train.optimizer import Optimizer


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


def _split_keys(batch: dict, input_logical: dict | None) -> set:
    """The inputs whose leading logical axis is ``"batch"`` (every input
    when no logical axes are given)."""
    if input_logical is None:
        return set(batch)
    return {k for k in batch if tuple(input_logical.get(k) or (None,))[0] == "batch"}


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
    def step(state: TrainState, batch, input_logical: dict | None = None
             ) -> tuple[TrainState, dict]:
        params = state.params
        split = _split_keys(batch, input_logical)
        groups, n_dp, r_dp = batch_groups() if split else ([], 1, 0)
        mbatch = microbatch
        if n_dp > 1:
            batch = {k: _rank_share(v, n_dp, r_dp, microbatch) if k in split else v
                     for k, v in batch.items()}
            mbatch = microbatch // n_dp
        with rank_share(groups, n_dp):
            if mbatch:
                loss, grads = _accumulate(loss_fn, params, batch, split, mbatch, accum_dtype,
                                          state.step.device)
            else:
                loss, grads = _grads(loss_fn, params, batch)
                grads = {k: g.coalesce() if g.is_sparse else g for k, g in grads.items()}
        if n_dp > 1:
            loss = all_reduce_(loss.clone(), groups).div_(n_dp)
        grads = {k: _reduce(g, params[k], groups, n_dp) for k, g in grads.items()}

        gnorm = optax_global_norm(grads)
        if grad_clip > 0:
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = {k: _values(g, lambda v: v * scale) for k, g in grads.items()}

        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        new_state = _placed_like(
            TrainState(params=new_params, opt_state=new_opt, step=state.step + 1), state)
        if isinstance(gnorm, DTensor):
            gnorm = gnorm.full_tensor()
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


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


def optax_global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient; a coalesced sparse
    gradient counts its stored rows (each row once)."""
    return torch.sqrt(sum(
        torch.sum(torch.square((g.values() if g.is_sparse else g).float()))
        for g in grads.values()
    ))

