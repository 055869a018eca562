"""Device placement for the serving tier: devices + logical-axis rules.

The port of :mod:`repro.serve.placement`. A :class:`ServePlacement` pairs
the devices of a ``(data, model)`` mesh with the repo's logical-axis
:class:`~repro_torch.distributed.sharding.Rules` table: the query axis of
``X [Q, D, F]`` and ``mask [Q, D]`` carries the logical ``"batch"`` axis
(data parallel: queries are independent), documents and features stay
whole on each device.

The reference's GSPMD partitions one compiled step along Q. The port is
single-controller as well: one process drives every device.
:meth:`ServePlacement.put_shards` splits the block along Q into one
contiguous shard per ``"batch"`` slice of the mesh, each on its device;
:meth:`~repro_torch.serve.ranking_service.RankingService.rank_batch` runs
the cascade on each shard on that device's current stream (one copy of the
forests per device), carries the compaction counts from shard to shard on
the devices, so the survivors that overflow a capacity are those the
one-program batch would drop, and gathers the shards' results on its own
device for its one host read. A Q that the shard count does not divide is
not split: the whole block runs on the first device (a stray shape must
degrade, never crash).

- :func:`single_device` (no devices): the block goes to the service's
  device, the plain path.
- :func:`local`: the ``(1, 1)`` ``DeviceMesh`` over one device with the
  production rules, through the whole machinery; one shard, so it is
  bit-equal to :func:`single_device`.
- :func:`data_parallel`: an ``(n, 1)`` mesh of devices, the query axis
  split ``n`` ways. The devices are listed, so one card may stand for
  several (``[cuda:0] * 2``: the shards run one after the other on it) and
  the CPU tests can pass ``[cpu] * 8``. A hybrid service's dense scores
  depend on its GEMM's row count (ROADMAP C5), so only its tree stages are
  bit-equal across shardings.
- :func:`auto`: ``data_parallel`` over every card when there is more than
  one, else ``single_device``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import Rules, mesh_axes, single_pod_rules
from repro_torch.launch.mesh import AXES, make_local_mesh
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ServePlacement:
    """Where serving batches live. No devices → the service's own.

    ``devices`` are the mesh's, row-major over ``axes`` (name, size);
    ``mesh`` is the ``DeviceMesh`` when one backs them (:func:`local`).
    """

    devices: tuple[torch.device, ...] = ()
    axes: tuple[tuple[str, int], ...] = ()
    rules: Rules | None = None
    mesh: DeviceMesh | None = None

    @property
    def n_devices(self) -> int:
        return max(len(self.devices), 1)

    def _batch_shards(self) -> int:
        """How many ways the logical "batch" axis splits on this mesh."""
        if self.rules is None:
            return 1
        sizes = dict(self.axes)
        n = 1
        for a in mesh_axes(self.rules.physical("batch")):
            n *= sizes[a]
        return n

    def n_shards(self, n_queries: int) -> int:
        """Shards of a block of ``n_queries``: the batch split, or 1 (the
        block whole on the first device) when it does not divide Q."""
        n = self._batch_shards()
        return n if n_queries % n == 0 else 1

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

    def put_shards(
        self,
        X: torch.Tensor | np.ndarray,
        mask: torch.Tensor | np.ndarray,
        device: torch.device,
    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """One ``(X, mask)`` pair per shard along Q, contiguous and in
        order, each on its device (:meth:`put`'s copies); with no devices,
        the one pair on ``device``."""
        if not self.devices:
            return [self.put(X, mask, device)]
        n = self.n_shards(len(X))
        per = len(X) // n
        stride = len(self.devices) // self._batch_shards()
        return [
            self.put(X[i * per:(i + 1) * per], mask[i * per:(i + 1) * per],
                     self.devices[i * stride])
            for i in range(n)
        ]


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


def local(device: str | torch.device | None = None) -> ServePlacement:
    """The (1, 1) mesh over ``device`` (``None``: the card) with the
    production rules table: the whole placement machinery, nothing split."""
    mesh = make_local_mesh(device)
    return ServePlacement(
        devices=(resolve_device(device),), axes=tuple(zip(AXES, (1, 1))),
        rules=single_pod_rules(), mesh=mesh,
    )


def data_parallel(
    n_devices: int | None = None, *, devices: Sequence[str | torch.device] | None = None
) -> ServePlacement:
    """(n, 1) mesh over ("data", "model"): the query axis split n ways.
    ``devices`` lists the mesh's devices (repeats allowed); by default the
    first ``n_devices`` visible cards (all of them for ``None``)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"data_parallel: {n} devices of {count} visible cards")
        devs = tuple(resolve_device(f"cuda:{i}") for i in range(n))
    else:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"data_parallel: n_devices={n_devices}, devices={devs}")
    return ServePlacement(
        devices=devs, axes=(("data", len(devs)), ("model", 1)), rules=single_pod_rules(),
    )


def auto() -> ServePlacement:
    """Data-parallel over every visible card; the single-device placement
    when there is at most one (keeps the one-device case bit-exact)."""
    return data_parallel() if torch.cuda.device_count() > 1 else single_device()
