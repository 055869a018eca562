"""The sentinel-features kernel: LEAR's four sentinel-time features and the
augmented copy of the documents in one CUDA launch.

:func:`sentinel_features_kernel` computes what
:func:`repro_torch.core.features.augment_features_plain` computes —
``X [Q, D, F]`` with the partial score, its rank within the query, the
min–max-normalized partial and the query's candidate count appended,
``[Q, D, F + 4]`` — without writing the ``[Q, D, D]`` rank predicate or any
other intermediate to device memory, bit for bit. It replaces no Pallas
kernel: the JAX package builds these features with plain ``jnp``. The CUDA
source is ``repro_torch/csrc/sentinel_features.cu``; its header says what
bounds the kernel on an H100 and how the design answers it.

The wrapper takes CUDA tensors only: it launches the kernel or raises, and
never falls back. :func:`repro_torch.core.features.augment_features` calls
it for a CUDA tensor and runs the plain version otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KERNEL_LAUNCHES, on_device
from repro_torch.typecheck import Tensor

N_AUG = 4  # features the kernel appends (core.features.N_AUG)


def _bind(lib: build.Library) -> None:
    """Declare the library's C function's types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sentinel_features.argtypes = [p, p, p, p, i, i, i, p]
    lib.sentinel_features.restype = i


def library() -> build.Library:
    """The kernel library (compiled at first use, then cached)."""
    return build.load("sentinel_features", _bind)


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple[int, ...]) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"sentinel features: {name} must be {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def _on_card(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(
            f"sentinel features: {name} on {t.device}; every operand must be on "
            f"one CUDA device (the plain version runs elsewhere)"
        )
    if not t.is_contiguous():
        raise ValueError(f"sentinel features: {name} must be contiguous")


def _check(X: torch.Tensor, partial: torch.Tensor, mask: torch.Tensor) -> None:
    if X.dim() != 3:
        raise ValueError(f"sentinel features: X must be [Q, D, F], got {tuple(X.shape)}")
    Q, D, F = X.shape
    _expect("X", X, torch.float32, (Q, D, F))
    _expect("partial", partial, torch.float32, (Q, D))
    _expect("mask", mask, torch.bool, (Q, D))
    _on_card("X", X, X.device)
    _on_card("partial", partial, X.device)
    _on_card("mask", mask, X.device)
    if Q >= 2**31 or D * (F + N_AUG) >= 2**31:
        raise ValueError(
            f"sentinel features: {(Q, D, F)}: Q and a query's D * (F + 4) "
            f"must stay below 2**31"
        )


def sentinel_features_kernel(
    X: Tensor["q d f", torch.float32],
    partial: Tensor["q d", torch.float32],
    mask: Tensor["q d", torch.bool],
) -> Tensor["q d g", torch.float32]:
    """``X`` with the four sentinel-time features appended →
    ``[Q, D, F + 4]``, in one launch on the current stream of ``X``'s card."""
    _check(X, partial, mask)
    Q, D, F = X.shape
    out = torch.empty((Q, D, F + N_AUG), dtype=torch.float32, device=X.device)
    if Q == 0 or D == 0:
        return out
    with on_device(X):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = library().sentinel_features(
            X.data_ptr(), partial.data_ptr(), mask.data_ptr(), out.data_ptr(),
            Q, D, F, stream,
        )
    if err != 0:
        raise RuntimeError(f"sentinel features launch failed: cudaError_t {err}")
    KERNEL_LAUNCHES["sentinel_features"] += 1
    return out
