"""Mesh construction: the port of :mod:`repro.launch.mesh`.

Single pod: 16 × 16 = 256 devices, axes ("data", "model").
Multi-pod:  2 × 16 × 16 = 512 devices, axes ("pod", "data", "model"); the
"pod" axis is a further data-parallel dimension over slower links, and the
logical rules place only batch-like axes (and the widest expert dimension)
on it.

A ``DeviceMesh`` lives on a ``torch.distributed`` process group. Nothing
here reads an address or an environment variable:

- :func:`make_production_mesh` builds on the group the caller has set up
  (:func:`join_ranks` for real ranks; the dry run uses a fake group);
- :func:`make_local_mesh` sets up a one-rank group itself, from an explicit
  ``HashStore``, when none exists;
- :func:`join_ranks` joins several processes through a ``TCPStore`` at the
  host and port the caller passes.

The group's backend is ``gloo`` for CPU tensors and ``nccl`` for CUDA ones
(``"cpu:gloo,cuda:nccl"`` where NCCL is built in).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.utils import resolve_device

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def _backend() -> str:
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over the caller's process group of
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=MULTI_POD_AXES if multi_pod else AXES)


def make_local_mesh(device: str | torch.device | None = None) -> DeviceMesh:
    """The (1, 1) ("data", "model") mesh over one device (``None``: the
    card). Sets up a one-rank process group from a ``HashStore`` if the
    process has none; an existing group must have one rank."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(), store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(
            f"make_local_mesh: the process group has {dist.get_world_size()} ranks, not 1"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=AXES)


def join_ranks(host: str, port: int, rank: int, world_size: int) -> None:
    """Join process ``rank`` of ``world_size`` to the default group through
    a ``TCPStore`` at ``host:port`` (rank 0 serves it); a rank that does
    not arrive within five minutes fails the others."""
    timeout = datetime.timedelta(minutes=5)
    store = dist.TCPStore(host, port, world_size, is_master=rank == 0, timeout=timeout)
    dist.init_process_group(_backend(), store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
