"""Where serving batches live: the single-device placement.

The port of :mod:`repro.serve.placement`, single device only. The
reference pins batches to a JAX mesh; on one card there is nothing to
split, so :func:`single_device` is the placement: :meth:`ServePlacement.put`
moves the request block to the service's ``torch.device``. It is the one
conversion ``RankingService.rank_batch`` makes, and its default when no
placement is given. ``local`` and ``data_parallel`` raise
``NotImplementedError``: a mesh of cards is a queued item of
``ROADMAP.md``. :func:`auto` picks ``data_parallel`` when more than one
card is visible and ``single_device`` otherwise, as the reference does.
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
        (the service passes its own).

        A host block goes to the card through pinned memory and an
        asynchronous copy, so the host never waits for the card here: a
        blocking copy (``torch.as_tensor(X, device=...)``) waits for the
        stream to drain, and so does an asynchronous one from pageable
        memory (CUDA's rule for pageable host-to-device copies).
        """
        return _on(X, torch.float32, device), _on(mask, torch.bool, device)


def _on(a: torch.Tensor | np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=dtype)
    if t.device == device:
        return t
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


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


def auto() -> ServePlacement:
    """Data-parallel over every visible card; the single-device placement
    when there is at most one (keeps the one-device case bit-exact)."""
    return data_parallel() if torch.cuda.device_count() > 1 else single_device()
