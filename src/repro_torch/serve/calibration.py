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
:func:`last_calibration` returns the last probe's report (for embedding in
a benchmark's payload); ``record_path`` merges it into a JSON file under
``"launch_calibration"``.
"""

from __future__ import annotations

import contextlib
import json
import os
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
    record_path: str | None = None,
) -> float:
    """Launch latency in doc·tree equivalents on ``device`` (cached).
    A degenerate measurement (non-positive per-tree slope) falls back to
    :data:`DEFAULT_LAUNCH_OVERHEAD_TREES`. With ``record_path`` the probe's
    report is merged under ``"launch_calibration"`` into that JSON file
    (:func:`_record`: never raises)."""
    dev = resolve_device(device)
    key = (dev.type, n_docs, n_trees, block_t)
    cached = _CALIBRATION_CACHE.get(key)
    if cached is not None:
        if record_path is not None:
            _record(record_path, cached)
        return cached["launch_overhead_trees"]

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
    payload = {
        "backend": dev.type,
        "probe_docs": n_docs,
        "probe_trees": n_trees,
        "block_t": block_t,
        "t_small_us": round(t_small, 1),
        "t_full_us": round(t_full, 1),
        "per_doctree_us": per_doctree,
        "launch_overhead_trees": overhead,
    }
    _CALIBRATION_CACHE[key] = payload
    if record_path is not None:
        _record(record_path, payload)
    return overhead


def last_calibration() -> dict | None:
    """The most recent probe's report (``None`` before the first probe)."""
    return next(reversed(_CALIBRATION_CACHE.values()), None)


def expected_engine_seconds(n_docs: int, n_trees: int) -> float:
    """Prior estimate of one engine call's wall time: the last probe's
    per-doc·tree slope over ``n_docs × n_trees`` plus one launch overhead
    (0 when no probe has run in this process)."""
    cal = last_calibration()
    if cal is None:
        return 0.0
    work = n_docs * n_trees + cal["launch_overhead_trees"]
    return max(cal["per_doctree_us"] * work, 0.0) * 1e-6


def _record(path: str, payload: dict) -> None:
    """Merge ``payload`` under ``"launch_calibration"`` into the JSON file at
    ``path``; never raise: an unwritable path or a corrupt file must not
    take the serving path down (``ValueError`` covers a JSON decode error)."""
    with contextlib.suppress(OSError, ValueError):
        doc = {}
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
        if not isinstance(doc, dict):
            doc = {}
        doc["launch_calibration"] = payload
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
