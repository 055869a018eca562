"""The benchmark's own weight draws: random complete trees in heap layout.

Frozen here so that no change to the program changes the weights. A forest
is a dict of raw arrays, the layout ``forest.ensemble.from_complete_arrays``
takes and :mod:`lear_bench.reference` traverses:

- ``feature``: ``[T, 2**depth - 1]`` int64, the feature each internal node
  tests (heap order: node ``n`` has children ``2n + 1`` and ``2n + 2``);
- ``threshold``: ``[T, 2**depth - 1]`` float32 (``x <= threshold`` goes left);
- ``leaf_value``: ``[T, 2**depth]`` float32, leaves left to right.

The ranker is drawn on the device from ``--seed`` with a ``torch.Generator``
(three calls). The exit classifiers are part of a configuration's exit
policy: they come from the seed its file fixes, by the draw of the
program's ``forest.ensemble.random_ensemble`` (numpy ``default_rng``:
features, thresholds, then leaves), so they are the same trees on every
device and the threshold chosen on the CPU gives the same share on the card.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF_SCALE = 0.1  # random_ensemble's default: leaves ~ N(0, 0.1**2)


def draw_ranker(
    generator: torch.Generator, n_trees: int, depth: int, n_features: int,
    device: torch.device,
) -> dict[str, torch.Tensor]:
    """The ranker's trees, drawn on ``device`` from ``generator``."""
    n_int = (1 << depth) - 1
    kw = {"generator": generator, "device": device}
    return {
        "feature": torch.randint(0, n_features, (n_trees, n_int), **kw),
        "threshold": torch.randn((n_trees, n_int), **kw),
        "leaf_value": LEAF_SCALE * torch.randn((n_trees, 1 << depth), **kw),
    }


def draw_classifier(
    seed: int, n_trees: int, depth: int, n_features: int, device: torch.device,
) -> dict[str, torch.Tensor]:
    """An exit classifier's trees from a fixed seed, in the order of
    ``random_ensemble``'s draw."""
    rng = np.random.default_rng(seed)
    n_int = (1 << depth) - 1
    feature = rng.integers(0, n_features, size=(n_trees, n_int))
    threshold = rng.normal(size=(n_trees, n_int)).astype(np.float32)
    leaf_value = (LEAF_SCALE * rng.normal(size=(n_trees, 1 << depth))).astype(np.float32)
    return {
        "feature": torch.as_tensor(feature, dtype=torch.int64, device=device),
        "threshold": torch.as_tensor(threshold, device=device),
        "leaf_value": torch.as_tensor(leaf_value, device=device),
    }
