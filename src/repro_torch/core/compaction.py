"""Survivor compaction: gather continuing documents into a dense prefix.

The port of :mod:`repro.core.compaction`. Both implementations compute the
same stable partition — the indices of the ``True`` entries of a flat
continue mask, in ascending order, written into a fixed-size
``[capacity]`` selection buffer (the size never depends on the data, so
nothing waits on the device):

- :func:`compact_indices_cumsum` — production path: ``cumsum(cont) - 1``
  gives each survivor its slot; one scatter into a ``capacity + 1``
  buffer whose last slot takes every exited or overflowing index, then a
  slice (the reference's ``mode="drop"`` scatter).
- :func:`compact_indices_argsort` — stable argsort, kept as the oracle.

Slots beyond ``min(n_cont, capacity)`` are padding (index 0 for cumsum);
callers mask per-slot results with ``slot < n_cont``. ``n_cont`` is a
0-dim device tensor. Indices are int64 (PyTorch's index type).
"""

from __future__ import annotations

import torch


def compact_indices_cumsum_masked(
    cont: torch.Tensor, capacity: int, limit: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sel [capacity], n_cont [], within [n])``: ``within[i]`` ⇔
    ``cont[i]`` and survivor ``i`` got a slot below ``capacity`` (and below
    ``limit``, a 0-dim device tensor, when given: the slots a split batch's
    earlier shards left this one)."""
    cont = cont.reshape(-1)
    n = cont.shape[0]
    pos = torch.cumsum(cont.long(), 0) - 1                    # survivor → slot
    n_cont = pos[-1] + 1 if n else torch.zeros((), dtype=torch.long, device=cont.device)
    within = cont & (pos < capacity)
    if limit is not None:
        within = within & (pos < limit)
    slot = torch.where(within, pos, torch.full_like(pos, capacity))
    sel = torch.zeros(capacity + 1, dtype=torch.long, device=cont.device)
    sel.scatter_(0, slot, torch.arange(n, device=cont.device))
    return sel[:capacity], n_cont, within


def compact_indices_cumsum(
    cont: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(n) stable partition → ``(sel [capacity], n_cont [])``."""
    sel, n_cont, _ = compact_indices_cumsum_masked(cont, capacity)
    return sel, n_cont


def compact_indices_argsort(
    cont: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(n log n) reference: stable argsort puts survivors first."""
    cont = cont.reshape(-1)
    order = torch.argsort((~cont).to(torch.uint8), stable=True)
    return order[:capacity], cont.sum()


COMPACTORS = {
    "cumsum": compact_indices_cumsum,
    "argsort": compact_indices_argsort,
}
