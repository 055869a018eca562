"""Launch-overhead calibration: measure the cost model's one knob.

The port of :func:`repro.serve.calibration.calibrate_launch_overhead_trees`.
:func:`repro_torch.metrics.speedup.progressive_cost_model` prices one extra
kernel launch at ``launch_overhead_trees`` doc·tree equivalents. The probe
scores a small forest twice through the plain-range kernel — over one tree
block (launch-dominated) and over the whole forest — and solves::

    per_doctree = (t_full − t_small) / (docs · (trees_full − trees_small))
    overhead_trees = max(t_small − per_doctree · docs · trees_small, 0)
                     / per_doctree

Times are CUDA-event times on the card and ``perf_counter`` times on the
CPU (the plain PyTorch path, whose value says nothing about the card). The
result is cached per process, per device type and probe shape.
:func:`expected_engine_seconds` extrapolates the last probe to a whole
batch: the batcher's prior for when to flush a request with a deadline.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.forest.ensemble import random_ensemble
from repro_torch.kernels.ops import forest_score_range, padded_forest
from repro_torch.utils import resolve_device

DEFAULT_LAUNCH_OVERHEAD_TREES = 4096.0  # fallback when the probe degenerates

_CALIBRATION_CACHE: dict = {}


def _min_time_us(fn: Callable[[], object], device: torch.device, iters: int) -> float:
    fn()  # build the padded buffers and the kernel outside the timed window
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def calibrate_launch_overhead_trees(
    device: str | torch.device | None = None,
    n_docs: int = 128,
    n_trees: int = 64,
    block_t: int = 16,
    iters: int = 5,
) -> float:
    """Launch latency in doc·tree equivalents on ``device`` (cached).
    A degenerate measurement (non-positive per-tree slope) falls back to
    :data:`DEFAULT_LAUNCH_OVERHEAD_TREES`."""
    dev = resolve_device(device)
    key = (dev.type, n_docs, n_trees, block_t)
    if key in _CALIBRATION_CACHE:
        return _CALIBRATION_CACHE[key]["launch_overhead_trees"]

    ens = random_ensemble(0, n_trees=n_trees, depth=3, n_features=16, device=dev)
    pf = padded_forest(ens, boundaries=(block_t, n_trees), block_t=block_t)
    x = torch.as_tensor(
        np.random.default_rng(0).normal(size=(n_docs, 16)).astype(np.float32),
        device=dev,
    )
    t_small = _min_time_us(lambda: forest_score_range(pf, x, 0, 1), dev, iters)
    t_full = _min_time_us(lambda: forest_score_range(pf, x, 0, 2), dev, iters)

    per_doctree = (t_full - t_small) / max(n_docs * (n_trees - block_t), 1)
    if per_doctree <= 0:
        overhead = DEFAULT_LAUNCH_OVERHEAD_TREES
    else:
        overhead = max(t_small - per_doctree * n_docs * block_t, 0.0) / per_doctree
    _CALIBRATION_CACHE[key] = {
        "per_doctree_us": per_doctree, "launch_overhead_trees": overhead,
    }
    return overhead


def expected_engine_seconds(n_docs: int, n_trees: int) -> float:
    """Prior estimate of one engine call's wall time: the last probe's
    per-doc·tree slope over ``n_docs × n_trees`` plus one launch overhead
    (0 when no probe has run in this process)."""
    cal = next(reversed(_CALIBRATION_CACHE.values()), None)
    if cal is None:
        return 0.0
    work = n_docs * n_trees + cal["launch_overhead_trees"]
    return max(cal["per_doctree_us"] * work, 0.0) * 1e-6
