"""Tensorized additive tree ensembles with QuickScorer-style bitmasks.

The port of :mod:`repro.forest.ensemble`. A ``TreeEnsemble`` stores ``T``
binary decision trees padded to a common ``n_nodes`` internal-node count
and ``n_leaves`` leaf count, as dense tensors shaped ``[T, n_nodes]`` /
``[T, n_leaves]``, with the same two encodings as the reference:

1. **Structural** (``left``/``right`` child indices): entries ``>= 0`` index
   internal nodes, entries ``< 0`` encode leaves as ``-(leaf_id + 1)``.
2. **QuickScorer bitmask** (``mask``): for each internal node ``n`` a 64-bit
   mask with zeros at the leaves of the *left* subtree of ``n``. The exit
   leaf of a document is the lowest set bit of the AND of the masks of its
   *false* nodes (``x[feat] <= thr`` fails); true and padded nodes
   contribute all ones.

The reference keeps each mask as two uint32 lanes (``mask_lo``/``mask_hi``).
This torch has no working uint32 bit arithmetic on the CPU, so the port
keeps ONE int64 per node holding the same 64-bit pattern
(``lo | hi << 32``); bit 63 set reads as a negative int64. The CUDA kernel
reads it as ``uint64_t``. :func:`from_numpy` converts the reference's
fields.

Leaves are numbered left-to-right (in-order); ``n_leaves`` must be ≤ 64.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device

ALL_ONES = -1  # int64 with every bit set: the mask of a true/padded node


@dataclasses.dataclass
class TreeEnsemble:
    """Dense, padded additive ensemble of binary regression trees.

    ``_padded_cache`` holds kernel-aligned buffer sets built by
    :func:`repro_torch.kernels.ops.padded_forest` (pad once, score many);
    it is only ever a cache and is not copied by :meth:`to`.
    """

    feature: torch.Tensor     # [T, N] int32 — split feature per internal node
    threshold: torch.Tensor   # [T, N] float32 — x <= thr → left
    left: torch.Tensor        # [T, N] int32 — left child (neg = ~leaf)
    right: torch.Tensor       # [T, N] int32
    mask: torch.Tensor        # [T, N] int64 — QS false-node mask, 64 bits
    leaf_value: torch.Tensor  # [T, L] float32
    base_score: torch.Tensor  # [] float32 — additive offset
    _padded_cache: OrderedDict = dataclasses.field(
        default_factory=OrderedDict, init=False, repr=False, compare=False
    )

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.feature.shape[1]

    @property
    def n_leaves(self) -> int:
        return self.leaf_value.shape[1]

    @property
    def depth(self) -> int:
        return int(np.log2(self.n_leaves))

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device: str | torch.device | None) -> TreeEnsemble:
        """The same ensemble on ``device`` (``None`` → the card)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return TreeEnsemble(*(
            getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self) if f.init
        ))

    def astype(self, dtype: torch.dtype) -> TreeEnsemble:
        """The same trees with thresholds, leaf values and the base score
        cast to ``dtype`` (features, children and masks unchanged)."""
        return TreeEnsemble(
            feature=self.feature, threshold=self.threshold.to(dtype), left=self.left,
            right=self.right, mask=self.mask, leaf_value=self.leaf_value.to(dtype),
            base_score=self.base_score.to(dtype),
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The reference's fields as numpy arrays, the inverse of
        :func:`from_numpy`: the int64 mask splits into two uint32 lanes."""
        bits = self.mask.cpu().numpy().view(np.uint64)
        out = {
            name: getattr(self, name).cpu().numpy()
            for name in ("feature", "threshold", "left", "right", "leaf_value", "base_score")
        }
        out["mask_lo"] = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out["mask_hi"] = (bits >> np.uint64(32)).astype(np.uint32)
        return out


def slice_trees(ens: TreeEnsemble, start: int, stop: int) -> TreeEnsemble:
    """Sub-ensemble of trees [start, stop) — used to split at a sentinel."""
    base = ens.base_score if start == 0 else torch.zeros_like(ens.base_score)
    return TreeEnsemble(
        feature=ens.feature[start:stop],
        threshold=ens.threshold[start:stop],
        left=ens.left[start:stop],
        right=ens.right[start:stop],
        mask=ens.mask[start:stop],
        leaf_value=ens.leaf_value[start:stop],
        base_score=base,
    )


def concat_ensembles(parts: Sequence[TreeEnsemble]) -> TreeEnsemble:
    """The trees of ``parts`` in order, with the first part's base score."""
    return TreeEnsemble(
        feature=torch.cat([p.feature for p in parts]),
        threshold=torch.cat([p.threshold for p in parts]),
        left=torch.cat([p.left for p in parts]),
        right=torch.cat([p.right for p in parts]),
        mask=torch.cat([p.mask for p in parts]),
        leaf_value=torch.cat([p.leaf_value for p in parts]),
        base_score=parts[0].base_score,
    )


def _leaf_spans(left: np.ndarray, right: np.ndarray, n_nodes: int):
    """In-order leaf numbering: for each internal node return (lo, mid, hi) —
    its subtree covers leaves [lo, hi), left child covers [lo, mid)."""
    spans = np.zeros((n_nodes, 3), dtype=np.int64)
    counter = [0]

    def visit(node: int) -> tuple[int, int]:
        if node < 0:  # leaf
            i = counter[0]
            counter[0] += 1
            return i, i + 1
        lo, mid = visit(int(left[node]))
        _, hi = visit(int(right[node]))
        spans[node] = (lo, mid, hi)
        return lo, hi

    visit(0)
    return spans, counter[0]


def _span_mask(lo: int, hi: int) -> int:
    """64-bit pattern with zeros on bits [lo, hi), as a signed int64 value."""
    bits = ((1 << hi) - 1) ^ ((1 << lo) - 1)
    inv = (~bits) & ((1 << 64) - 1)
    return inv - (1 << 64) if inv >= 1 << 63 else inv


def from_numpy(
    arrays: dict[str, np.ndarray], device: str | torch.device | None = None
) -> TreeEnsemble:
    """The weight converter: build a port ensemble from the reference's
    fields given as numpy arrays (``feature``, ``threshold``, ``left``,
    ``right``, ``mask_lo``, ``mask_hi``, ``leaf_value``, ``base_score``).
    The two uint32 mask lanes merge into one int64 bit pattern."""
    dev = resolve_device(device)
    lo = np.asarray(arrays["mask_lo"]).astype(np.uint64)
    hi = np.asarray(arrays["mask_hi"]).astype(np.uint64)
    mask = ((hi << np.uint64(32)) | lo).view(np.int64)
    as_t = lambda name, dtype: torch.as_tensor(
        np.array(arrays[name], dtype=dtype), device=dev
    )
    return TreeEnsemble(
        feature=as_t("feature", np.int32),
        threshold=as_t("threshold", np.float32),
        left=as_t("left", np.int32),
        right=as_t("right", np.int32),
        mask=torch.as_tensor(np.array(mask), device=dev),
        leaf_value=as_t("leaf_value", np.float32),
        base_score=as_t("base_score", np.float32).reshape(()),
    )


def from_arrays(
    features: list[np.ndarray],
    thresholds: list[np.ndarray],
    lefts: list[np.ndarray],
    rights: list[np.ndarray],
    leaf_values: list[np.ndarray],
    base_score: float = 0.0,
    n_nodes: int | None = None,
    n_leaves: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> TreeEnsemble:
    """Build a padded ensemble from per-tree structure arrays (irregular trees).

    Per-tree convention: internal nodes indexed 0..n_int-1 (root = 0); child
    entries < 0 encode leaf ``-(leaf_slot+1)`` into that tree's
    ``leaf_values``. Leaf slots are renumbered here to in-order so the
    QuickScorer mask rule holds regardless of input numbering.
    """
    dev = resolve_device(device)
    T = len(features)
    n_nodes = n_nodes or max(int(f.shape[0]) for f in features)
    n_leaves = n_leaves or max(int(lv.shape[0]) for lv in leaf_values)
    if n_leaves > 64:
        raise ValueError(f"bitmask encoding requires <=64 leaves, got {n_leaves}")

    feat = np.zeros((T, n_nodes), dtype=np.int32)
    thr = np.full((T, n_nodes), np.float32(np.inf))  # padded → always-true node
    left = np.full((T, n_nodes), -1, dtype=np.int32)
    right = np.full((T, n_nodes), -1, dtype=np.int32)
    mask = np.full((T, n_nodes), ALL_ONES, dtype=np.int64)
    lv = np.zeros((T, n_leaves), dtype=np.float32)

    for t in range(T):
        n_int = int(features[t].shape[0])
        feat[t, :n_int] = features[t]
        thr[t, :n_int] = thresholds[t]
        lt, rt = lefts[t].astype(np.int64), rights[t].astype(np.int64)
        spans, n_leaf_t = _leaf_spans(lt, rt, n_int)
        # Renumber leaves to in-order: walk again mapping old slot → in-order id.
        order = np.zeros(n_leaf_t, dtype=np.int64)  # in-order id → old slot
        counter = [0]

        def visit(node: int):
            if node < 0:
                order[counter[0]] = -(node + 1)
                counter[0] += 1
                return
            visit(int(lt[node]))
            visit(int(rt[node]))

        visit(0)
        lv[t, :n_leaf_t] = leaf_values[t][order]
        # Children re-encoded with in-order leaf ids.
        old2new = np.zeros(n_leaf_t, dtype=np.int64)
        old2new[order] = np.arange(n_leaf_t)
        for n in range(n_int):
            for arr_in, arr_out in ((lt, left), (rt, right)):
                c = int(arr_in[n])
                arr_out[t, n] = c if c >= 0 else -(int(old2new[-(c + 1)]) + 1)
            lo, mid, _hi = spans[n]
            mask[t, n] = _span_mask(int(lo), int(mid))

    return TreeEnsemble(
        feature=torch.as_tensor(feat, device=dev),
        threshold=torch.as_tensor(thr, device=dev),
        left=torch.as_tensor(left, device=dev),
        right=torch.as_tensor(right, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        leaf_value=torch.as_tensor(lv, device=dev),
        base_score=torch.tensor(base_score, dtype=torch.float32, device=dev),
    )


def from_complete_arrays(
    feature: np.ndarray,     # [T, 2**D - 1] heap-ordered internal nodes
    threshold: np.ndarray,   # [T, 2**D - 1]
    leaf_value: np.ndarray,  # [T, 2**D] left-to-right leaves
    base_score: float = 0.0,
    *,
    device: str | torch.device | None = None,
) -> TreeEnsemble:
    """Complete depth-D trees in heap layout (the GBDT output).

    Heap node ``n`` has children ``2n+1`` / ``2n+2``; leaves are already
    left-to-right, so masks come from closed-form spans.
    """
    dev = resolve_device(device)
    T, n_int = feature.shape
    depth = int(np.log2(n_int + 1))
    left = np.zeros((T, n_int), dtype=np.int32)
    right = np.zeros((T, n_int), dtype=np.int32)
    mask = np.zeros((T, n_int), dtype=np.int64)
    for n in range(n_int):
        d = int(np.floor(np.log2(n + 1)))
        # Heap node n is the (n - (2**d - 1))-th node of level d; its
        # subtree spans 2**(depth - d) leaves starting at that offset.
        pos = n - ((1 << d) - 1)
        span = 1 << (depth - d)
        lo = pos * span
        mid = lo + span // 2
        l_child, r_child = 2 * n + 1, 2 * n + 2
        left[:, n] = l_child if l_child < n_int else -(lo + 1)
        right[:, n] = r_child if r_child < n_int else -(mid + 1)
        mask[:, n] = _span_mask(lo, mid)
    return TreeEnsemble(
        feature=torch.as_tensor(feature.astype(np.int32), device=dev),
        threshold=torch.as_tensor(threshold.astype(np.float32), device=dev),
        left=torch.as_tensor(left, device=dev),
        right=torch.as_tensor(right, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        leaf_value=torch.as_tensor(leaf_value.astype(np.float32), device=dev),
        base_score=torch.tensor(base_score, dtype=torch.float32, device=dev),
    )


def random_ensemble(
    seed: int,
    n_trees: int,
    depth: int,
    n_features: int,
    leaf_scale: float = 0.1,
    *,
    device: str | torch.device | None = None,
) -> TreeEnsemble:
    """Random complete-tree ensemble — used by tests and kernel sweeps.

    Draws from numpy's ``default_rng(seed)`` in the reference's order, so
    the same seed gives the same trees as
    ``repro.forest.ensemble.random_ensemble`` (a test pins this).
    """
    rng = np.random.default_rng(seed)
    n_int = (1 << depth) - 1
    feature = rng.integers(0, n_features, size=(n_trees, n_int))
    threshold = rng.normal(size=(n_trees, n_int)).astype(np.float32)
    leaf_value = (
        leaf_scale * rng.normal(size=(n_trees, 1 << depth))
    ).astype(np.float32)
    return from_complete_arrays(feature, threshold, leaf_value, device=device)
