"""Several ``gloo`` processes on 127.0.0.1 for the port's train-step tests.

:func:`start` launches ``world`` Python processes of one program, each
given ``port rank world *args`` on its command line (``join_ranks`` on
127.0.0.1 at ``port``); :func:`join` waits for them and fails with the
log of a rank that failed. The programs find ``src/`` and this directory
on their path, so a rank imports :func:`digest` from here. Nothing here
imports JAX.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(prog: str, world: int, *args: str) -> list[subprocess.Popen]:
    """``world`` ranks of the program text ``prog``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), TESTS]),
               OMP_NUM_THREADS="1")
    return [
        subprocess.Popen([sys.executable, "-c", prog, str(port), str(r), str(world), *args],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(world)
    ]


def join(procs: list[subprocess.Popen], timeout: float = 300) -> None:
    """Wait for every rank; kill what is left on the way out. Fails with a
    failed rank's log."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs, strict=True)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"


def run(prog: str, world: int, *args: str, timeout: float = 300) -> None:
    join(start(prog, world, *args), timeout)


def digest(tensors) -> str:
    """SHA-256 of the bytes of ``tensors`` in order: a ``DTensor``'s local
    shard, a sparse tensor's indices and values."""
    import torch
    from torch.distributed.tensor import DTensor

    h = hashlib.sha256()
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        if t.is_sparse:
            h.update(t.indices().numpy().tobytes())
            t = t.values()
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

