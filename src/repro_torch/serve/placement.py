"""Where serving batches live: the single-device placement.

The port of :mod:`repro.serve.placement`, single device only. The
reference pins batches to a JAX mesh; on one card there is nothing to
split, so :func:`single_device` is the placement: :meth:`ServePlacement.put`
moves the request block to the service's ``torch.device``. It is the one
conversion ``RankingService.rank_batch`` makes, and its default when no
placement is given. ``local`` and ``data_parallel`` raise
``NotImplementedError``: a mesh of cards is a queued item of
``ROADMAP.md``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ServePlacement:
    """One device: the service's own."""

    @property
    def n_devices(self) -> int:
        return 1

    def put(
        self,
        X: torch.Tensor | np.ndarray,
        mask: torch.Tensor | np.ndarray,
        device: torch.device,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``X [Q, D, F]`` as f32 and ``mask [Q, D]`` as bool on ``device``
        (the service passes its own)."""
        return (
            torch.as_tensor(X, dtype=torch.float32, device=device),
            torch.as_tensor(mask, dtype=torch.bool, device=device),
        )


def single_device() -> ServePlacement:
    """The batch goes to the service's device, as with no placement."""
    return ServePlacement()


def local() -> ServePlacement:
    raise NotImplementedError(
        "repro_torch: mesh placement is not ported yet (ROADMAP.md, queue A: "
        "'data_parallel / local placement')"
    )


def data_parallel(n_devices: int | None = None) -> ServePlacement:
    raise NotImplementedError(
        "repro_torch: data-parallel placement is not ported yet (ROADMAP.md, "
        "queue A: 'data_parallel / local placement')"
    )
