"""Synthesize valid random inputs for any Cell (smoke tests / launchers).

The port's copy of :mod:`repro.models.synth` (numpy): for the same cell and
seed it draws the same arrays, bit for bit, in the same order. Integer
inputs are drawn within the valid range implied by the config (vocab sizes,
node counts, …); the specs are ``cell.input_specs()``'s ``meta`` tensors,
nested dicts of them (an LM decode cell's caches) drawn in sorted key order
as ``jax.tree.map`` visits them. A bfloat16 spec (an LM decode cell's
caches) is drawn as the reference draws it: numpy does not count
``ml_dtypes``' bfloat16 as floating (``np.issubdtype(bfloat16,
np.floating)`` is False), so the reference's draw falls through to the
integer branch and gives int32 ids in ``[0, vocab)``; so does this one.
:func:`as_tensors` moves a drawn batch to a device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (
    ForestConfig,
    NequIPConfig,
    RecSysConfig,
    TransformerConfig,
)
from repro_torch.models.api import Cell

_NP_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.bool: np.dtype(np.bool_),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.bfloat16: np.dtype(np.int32),   # drawn as the reference draws it (above)
}


def synthesize_inputs(cell: Cell, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    cfg, shape = cell.cfg, cell.shape
    specs = cell.input_specs()
    out = {}
    for name, spec in specs.items():
        out[name] = _one(name, spec, cfg, shape, rng)
    return out


def as_tensors(inputs: dict, device: str | torch.device) -> dict:
    """A drawn batch (nested dicts of numpy arrays) as tensors on ``device``."""
    if isinstance(inputs, dict):
        return {k: as_tensors(v, device) for k, v in inputs.items()}
    return torch.as_tensor(inputs, device=device)


def _ints(rng, shape, hi):
    return rng.integers(0, max(int(hi), 1), size=shape).astype(np.int32)


def _one(name, spec, cfg, shape, rng):
    if isinstance(spec, dict):
        return {k: _one(name, spec[k], cfg, shape, rng) for k in sorted(spec)}
    shp, dt = tuple(spec.shape), _NP_DTYPES[spec.dtype]

    if np.issubdtype(dt, np.floating):
        if name == "mask_pos":
            return (rng.random(shp) < 0.15).astype(np.float32)
        return rng.normal(size=shp).astype(dt)
    if dt == np.bool_:
        m = rng.random(shp) < 0.8
        if m.ndim == 2:
            m[:, 0] = True
        return m

    # Integer inputs: range depends on semantics.
    if isinstance(cfg, TransformerConfig):
        if name == "pos":
            return np.int32(min(8, shape.seq_len - 1))
        return _ints(rng, shp, cfg.vocab_size)
    if isinstance(cfg, NequIPConfig):
        if name == "species":
            return _ints(rng, shp, cfg.n_species)
        if name in ("edge_src", "edge_dst"):
            return _ints(rng, shp, shape.n_nodes)
        if name == "graph_id":
            n_graphs = shape.graph_batch or 1
            return np.sort(_ints(rng, shp, n_graphs))
        return _ints(rng, shp, 4)
    if isinstance(cfg, RecSysConfig):
        if cfg.family == "dlrm" and name == "sparse":
            ids = np.stack(
                [_ints(rng, shp[:1] + shp[2:], v) for v in cfg.vocab_sizes[: shp[1]]],
                axis=1,
            )
            return ids
        if cfg.family == "deepfm" and name == "ids":
            offs = np.cumsum([0, *cfg.vocab_sizes[:-1]])
            cols = shp[1]
            ids = np.stack(
                [offs[i] + _ints(rng, shp[:1], cfg.vocab_sizes[i]) for i in range(cols)],
                axis=1,
            )
            return ids.astype(np.int32)
        if name == "cand_ids":
            hi = {
                "dlrm": cfg.vocab_sizes[-1] if cfg.vocab_sizes else 1,
                "deepfm": sum(cfg.vocab_sizes),
                "din": cfg.item_vocab,
                "bert4rec": cfg.item_vocab,
            }[cfg.family]
            return _ints(rng, shp, hi)
        if name in ("hist_ids", "target_id", "ids", "labels"):
            return _ints(rng, shp, cfg.item_vocab or sum(cfg.vocab_sizes))
    if isinstance(cfg, ForestConfig):
        return _ints(rng, shp, 2)
    return _ints(rng, shp, 2)
