"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ctypes.

The kernels in ``repro_torch/csrc`` expose a plain C interface, so they are
compiled by ``nvcc`` alone (seconds) rather than against PyTorch's headers
(minutes), and loaded with :mod:`ctypes`. The library is built at first use
into ``build/repro_torch/`` at the root of the checkout (or the directory
given to :func:`repro_torch.serve.warmup.enable_persistent_cache`), named
by a hash of every source and header under ``csrc/`` and the flags, so an
edit to any file the build may read builds anew and an unchanged tree is
reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
    # repro: noqa(TS004) -- read at the library's first build only;
    # kernels.forest_score.library() returns the loaded library after that.
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
