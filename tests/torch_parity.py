"""Helpers for the port's parity tests: the same arrays go to both packages.

The JAX reference (``repro``) and the PyTorch port (``repro_torch``) meet
only here, in numpy: a reference ensemble's fields are read out with
``np.asarray`` and handed to the port's weight converter.
"""

import numpy as np

from repro_torch.forest.ensemble import from_numpy

FIELDS = (
    "feature", "threshold", "left", "right", "mask_lo", "mask_hi",
    "leaf_value", "base_score",
)


def ref_arrays(ens) -> dict[str, np.ndarray]:
    """A reference ``TreeEnsemble``'s fields as numpy arrays."""
    return {k: np.asarray(getattr(ens, k)) for k in FIELDS}


def to_port(ens):
    """The port's CPU copy of a reference ensemble."""
    return from_numpy(ref_arrays(ens), "cpu")


def mask_lanes(mask) -> tuple[np.ndarray, np.ndarray]:
    """The port's int64 mask patterns split back into uint32 (lo, hi)."""
    bits = mask.cpu().numpy().view(np.uint64)
    return (
        (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (bits >> np.uint64(32)).astype(np.uint32),
    )


def keep_boundary_docs(scores, keep, mask, tol) -> np.ndarray:
    """``[Q, D]`` bool: the valid documents whose dense score lies within
    tolerance of their query's keep boundary — those that have a valid
    document on the other side of the keep decision ``keep`` closer than
    ``2·(tol + tol·max|score|)`` (each of two scores that agree within
    ``tol`` may move by that much, so only such a pair can swap order)."""
    scores = np.asarray(scores, np.float64)
    keep, mask = np.asarray(keep, bool), np.asarray(mask, bool)
    gap = np.abs(scores[:, :, None] - scores[:, None, :])
    scale = np.maximum(np.abs(scores[:, :, None]), np.abs(scores[:, None, :]))
    near = gap <= 2 * (tol + tol * scale)
    across = (keep[:, :, None] != keep[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    return mask & (near & across).any(axis=-1)
