"""Train-step factory: grad accumulation, aux metrics, optional grad clip.

The port of :mod:`repro.train.trainer`. ``make_train_step(loss_fn,
optimizer, microbatch)`` returns ``step(state, batch) → (state, metrics)``:

- ``microbatch > 0`` splits the batch on its leading axis into equal
  chunks, runs forward and backward on each in turn and sums the gradients
  in ``accum_dtype``, then divides by the chunk count (the reference's
  ``lax.scan``, eagerly).
- Gradients come from ``torch.autograd.grad`` on detached leaves that share
  the parameters' storage, so no parameter is copied. A sparse gradient (an
  embedding lookup with ``sparse_grad=True``) stays sparse: the chunks'
  are summed, then coalesced, so the global norm counts each row once.
- ``grad_clip > 0`` scales every gradient by ``min(1, clip / norm)``.
- Data parallel: under :func:`~repro_torch.distributed.sharding_rules`
  with a mesh whose ``"batch"`` axes hold more than one rank, every rank
  is given the whole batch and takes its shard along the leading
  (``"batch"``) axis: from each microbatch of the one-program step, its
  contiguous ``1/n`` (so a microbatch of ``m`` rows becomes ``m/n`` rows a
  rank, and an MoE's dispatch groups, one per sequence, stay whole). The
  gradients and the loss are summed over the ranks with
  ``dist.all_reduce`` and divided by their count before the norm, the
  clip and the optimizer, so every rank takes the step the one-program
  step takes on the whole batch (to rounding). Dense gradients only.

Parameters are a flat ``dict[str, Tensor]``; the state is the reference's
``TrainState(params, opt_state, step)``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import constrain, current_mesh, current_rules, mesh_axes
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


def _data_parallel() -> tuple[list, int, int]:
    """``(groups, n, r)``: the process groups of the mesh axes that
    ``"batch"`` resolves to, their rank count and this rank's index among
    them (major to minor); ``([], 1, 0)`` without rules, mesh or split."""
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


def _rank_rows(batch: dict, n: int, r: int, microbatch: int) -> dict:
    """Rank ``r``'s rows of every leaf: its ``1/n`` of each microbatch
    (of the whole batch without microbatching)."""
    lead = next(iter(batch.values())).shape[0]
    chunk = microbatch or lead
    if lead % chunk or chunk % n:
        raise ValueError(f"batch {lead} / microbatch {chunk} do not split over {n} ranks")
    part = chunk // n
    rows = torch.cat([torch.arange(c + r * part, c + (r + 1) * part)
                      for c in range(0, lead, chunk)])
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


def _mean_over(groups: list, n: int, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank of ``groups`` (in place), over ``n``."""
    if t.is_sparse:
        raise NotImplementedError("data-parallel steps take dense gradients")
    for g in groups:
        dist.all_reduce(t, group=g)
    return t.div_(n)


def make_train_step(
    loss_fn: Callable,            # (params, batch) -> scalar loss
    optimizer: Optimizer,
    microbatch: int = 0,
    grad_clip: float = 0.0,
    accum_dtype: torch.dtype = torch.float32,
):
    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        groups, n_dp, r_dp = _data_parallel()
        mbatch = microbatch
        if n_dp > 1:
            batch = _rank_rows(batch, n_dp, r_dp, microbatch)
            mbatch = microbatch // n_dp
        if mbatch:
            lead = next(iter(batch.values())).shape[0]
            if lead % mbatch:
                raise ValueError(f"batch {lead} is not a multiple of microbatch {mbatch}")
            n_chunks = lead // mbatch
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            gsum: dict[str, torch.Tensor] = {}
            for c in range(n_chunks):
                mb = {k: constrain(v[c * mbatch:(c + 1) * mbatch], "batch", *([None] * (v.ndim - 1)))
                      for k, v in batch.items()}
                loss, g = _grads(loss_fn, params, mb)
                loss_sum = loss_sum + loss
                for k, gk in g.items():
                    if gk.is_sparse:
                        gsum[k] = gk if k not in gsum else gsum[k] + gk
                    else:
                        acc = gsum.get(k, torch.zeros(gk.shape, dtype=accum_dtype, device=gk.device))
                        gsum[k] = acc + gk.to(accum_dtype)
                del g   # the next chunk's backward runs without this one's gradients
            loss = loss_sum / n_chunks
            # Dense sums are divided in place (the same arithmetic): a second
            # float32 copy of every gradient would not fit beside an LM's state.
            grads = {
                k: _values(g.coalesce(), lambda v: v / n_chunks) if g.is_sparse
                else g.div_(n_chunks)
                for k, g in gsum.items()
            }
            del gsum
        else:
            loss, grads = _grads(loss_fn, params, batch)
            grads = {k: g.coalesce() if g.is_sparse else g for k, g in grads.items()}
        if n_dp > 1:
            loss = _mean_over(groups, n_dp, loss.clone())
            grads = {k: _mean_over(groups, n_dp, g) for k, g in grads.items()}

        gnorm = optax_global_norm(grads)
        if grad_clip > 0:
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = {k: _values(g, lambda v: v * scale) for k, g in grads.items()}

        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        new_state = TrainState(params=new_params, opt_state=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def optax_global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient; a coalesced sparse
    gradient counts its stored rows (each row once)."""
    return torch.sqrt(sum(
        torch.sum(torch.square((g.values() if g.is_sparse else g).float()))
        for g in grads.values()
    ))

