"""Build, load and count the port's CUDA kernels: ``nvcc`` → shared
library → ctypes.

The kernels in ``repro_torch/csrc`` expose a plain C interface, so they are
compiled by ``nvcc`` alone (seconds) rather than against PyTorch's headers
(minutes), and loaded with :mod:`ctypes`. A library is built at first use
into ``build/repro_torch/`` at the root of the checkout (or the directory
given to :func:`set_build_dir`, which
:func:`repro_torch.serve.warmup.enable_persistent_cache` calls), named
by a hash of every source and header under ``csrc/`` and the flags, so an
edit to any file the build may read builds anew and an unchanged tree is
reused.

This module is the seam every kernel module shares: :func:`load` keeps the
loaded libraries by name under one lock, :data:`KERNEL_LAUNCHES` counts
each kernel's launches and :data:`FIRST_TOUCHES` the costs warmup must pay
first. A kernel module keeps only its C signatures and its checks.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# Where libraries are built and found; moved by
# repro_torch.serve.warmup.enable_persistent_cache before the first build.
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    # repro: noqa(TS004) -- read at a library's first build only; load()
    # returns the loaded library after that.
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "repro_torch: nvcc not found (CUDA_HOME, /usr/local/cuda, PATH); "
            "the CUDA kernels are built from source at first use"
        )
    return found


SOURCE_SUFFIXES = (".cu", ".cuh", ".h", ".hpp")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the name, the path and
    bytes of every source and header under ``csrc/``, and the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.suffix in SOURCE_SUFFIXES):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and the compiler's log (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when nothing was built)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"repro_torch: building {name}.cu failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out, proc.stdout + proc.stderr


# Launches of each CUDA kernel, bumped by its wrapper where it launches the
# kernel and nowhere else (the plain CPU path does not count).
KERNEL_LAUNCHES = {"forest_score": 0, "forest_score_segments": 0, "sentinel_features": 0}

# First-touch costs that would land on a request if warmup did not pay them
# first, counted where they happen: loads of a kernel library, growths of
# the forest kernels' per-stream scratch, the forest library's shared-memory
# limit asked for a new table shape, and padded_forest cache misses
# (kernels.ops). The forest launcher's plans are counted in its library
# (kernels.forest_score.first_touches adds them); the shared-memory opt-in
# is raised with a kernel's first plan or limit query on a device, so these
# counts cover it. ``dense`` counts the dense scorer's first run per
# (device, stream, row count) (models.dense_scorer).
FIRST_TOUCHES = {
    "library": 0, "scratch": 0, "max_features": 0, "padded_forest": 0, "dense": 0,
}

Library = ctypes.CDLL   # a loaded kernel library

# The loaded libraries by name, each with the path it was loaded from; one
# lock for all of them and for moving BUILD_DIR.
_LOADED: dict[str, tuple[Library, Path]] = {}
_LOCK = threading.Lock()


def reset_kernel_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def kernel_launches() -> dict[str, int]:
    return dict(KERNEL_LAUNCHES)


def load(name: str, bind: Callable[[Library], None]) -> Library:
    """The library of ``csrc/<name>.cu``, built and loaded at first use
    (``bind`` declares its C functions' types) and cached; a load counts as
    a first touch."""
    with _LOCK:
        if name not in _LOADED:
            path, _ = build(name)
            lib = Library(str(path))
            bind(lib)
            _LOADED[name] = (lib, path)
            FIRST_TOUCHES["library"] += 1
        return _LOADED[name][0]


def loaded(name: str) -> Library | None:
    """The library of ``csrc/<name>.cu`` if it is loaded, else ``None``."""
    with _LOCK:
        got = _LOADED.get(name)
        return None if got is None else got[0]


def set_build_dir(path: str | Path) -> None:
    """Build (or reuse) the kernel libraries under ``path`` from now on.
    Raises ``RuntimeError`` once any library is loaded from another
    directory: a process holds one copy of the kernels."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _LOCK:
        for name, (_, lib_path) in _LOADED.items():
            if lib_path.parent != path:
                raise RuntimeError(
                    f"repro_torch: the {name} kernel library is already loaded from "
                    f"{lib_path.parent}; set the build directory before the first build"
                )
        BUILD_DIR = path


def on_device(x: torch.Tensor) -> contextlib.AbstractContextManager:
    """Make ``x``'s card the current one for a launch (a no-op when it is)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)
