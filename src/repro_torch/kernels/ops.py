"""Dispatch around the forest-scoring kernels: padding, caching, counting.

The port of :mod:`repro.kernels.ops`. :func:`padded_forest` builds the
kernel-aligned buffers of an ensemble once and caches them on the
:class:`~repro_torch.forest.ensemble.TreeEnsemble` (LRU, keyed by segment
boundaries × tree-block size × leaf-gather path). Each segment (cascade
sentinels need not be tree-block aligned) is padded on its own with no-op
trees — threshold ``+inf`` ⇒ always true ⇒ all-ones mask, leaf values 0 —
so every segment starts on a block boundary, and head and tail of a cascade
score from one buffer set through a tree-block range. The buffers are the
reference's, value for value (masks as one int64 instead of two uint32).

Leaf layout: ``leaf_gather="select"`` pads the leaf axis to a power of two
(``leaf_layout="pow2"``), as the reference's select-tree gather needs; the
other paths keep the native axis. On the card every path is one direct
leaf load, so the choice changes the buffer layout only — the results are
bit-identical, as they are in the reference.

Launch accounting: :func:`launch_counts` counts the dispatches the engine
makes, split ``plain`` / ``segmented`` / ``gated`` as in the reference.
The reference counts per *trace*; this eager port counts per *call*, so
one cascade step's run moves the counters by what one reference trace
stages (fused = 1 segmented + ≤1 plain). These counters move on the CPU
path too; the CUDA launches themselves are counted per kernel in
:data:`repro_torch.kernels.build.KERNEL_LAUNCHES`.
"""

from __future__ import annotations

import dataclasses
import os
import typing

import torch

from repro_torch.kernels.build import FIRST_TOUCHES
from repro_torch.kernels.forest_score import (
    ALL_ONES,
    _next_pow2,
    forest_score_kernel,
    forest_score_segments_kernel,
    pack_leaves,
    pack_nodes,
)

if typing.TYPE_CHECKING:
    from repro_torch.forest.ensemble import TreeEnsemble


def env_int(name: str, default: int, *, minimum: int = 1) -> int:
    """Integer tuning constant from the environment, read at import time:
    unset or empty → ``default``; a non-integer or a value below
    ``minimum`` raises (a silently ignored typo is worse than a crash)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


# The reference's doc-block size. The CUDA kernel has no doc blocks of this
# size (a CTA holds a tile of 32-128 documents), but decision-time pricing
# (repro_torch.metrics.speedup.progressive_cost_model) quotes the same
# block-rounded survivor counts as the reference, so the mode picks agree.
ENGINE_BLOCK_B = 256

# Bound on cached buffer layouts per ensemble (LRU).
PADDED_CACHE_MAX = env_int("REPRO_PADDED_CACHE_MAX", 8)

# Auto leaf-gather policy cutoff (select up to this many padded leaves).
LEAF_SELECT_MAX = env_int("REPRO_LEAF_SELECT_MAX", 64)


def resolve_leaf_gather(n_leaves: int) -> str:
    """Concrete leaf-gather path for ``"auto"``: select for small leaf axes
    (after power-of-two padding), MXU contraction for wide ones."""
    return "select" if _next_pow2(n_leaves) <= LEAF_SELECT_MAX else "mxu"


_LAUNCH_COUNTS = {"plain": 0, "segmented": 0, "gated": 0}


def reset_launch_counts() -> None:
    """Zero the dispatch counters."""
    for kind in _LAUNCH_COUNTS:
        _LAUNCH_COUNTS[kind] = 0


def launch_counts() -> dict[str, int]:
    """Kernel dispatches since the last reset, keyed ``plain`` /
    ``segmented`` / ``gated`` (the query-exit tail, one per step with query
    exit on, whatever its survivor count)."""
    return dict(_LAUNCH_COUNTS)


def effective_block_b(block_b: int, n_rows: int) -> int:
    """The reference's doc-block policy: the requested block, shrunk to
    the padded row count for small batches. The cost model prices staged
    stages with it."""
    return min(block_b, _next_pow2(max(int(n_rows), 8)))


@dataclasses.dataclass(frozen=True)
class PaddedForest:
    """Kernel-aligned buffers for one ensemble + segment layout.

    Segment ``k`` occupies padded tree blocks
    ``[seg_block_starts[k], seg_block_starts[k] + seg_blocks[k])``.
    """

    feature: torch.Tensor     # [T_pad, N_pad] i32
    threshold: torch.Tensor   # [T_pad, N_pad] f32
    mask: torch.Tensor        # [T_pad, N_pad] i64
    leaf_value: torch.Tensor  # [T_pad, L_layout] f32
    base_score: torch.Tensor  # [] f32
    boundaries: tuple[int, ...]        # cumulative tree-unit segment ends
    seg_block_starts: tuple[int, ...]  # per-segment start, in blocks
    seg_blocks: tuple[int, ...]        # per-segment length, in blocks
    block_t: int
    leaf_gather: str = "onehot"
    leaf_layout: str = "native"
    # The ensemble's own node tests and leaves per tree, before padding.
    n_nodes: int = 0
    n_leaves: int = 0
    # The CUDA kernels' copies of the same tables: 16-byte node records
    # [T_pad, N_pad, 4] i32 (kernels.forest_score.pack_nodes) and leaf rows
    # padded to a multiple of 4 [T_pad, L4] f32 (pack_leaves).
    nodes: torch.Tensor | None = None
    leaves: torch.Tensor | None = None

    @property
    def packed(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        return None if self.nodes is None else (self.nodes, self.leaves)

    @property
    def n_segments(self) -> int:
        return len(self.boundaries)

    @property
    def n_trees(self) -> int:
        return self.boundaries[-1]


def _pad_to(
    x: torch.Tensor, axis: int, multiple: int, value: float | int = 0
) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], axis)


def padded_forest(
    ens: TreeEnsemble,
    boundaries: tuple[int, ...] | None = None,
    block_t: int = 16,
    leaf_gather: str = "auto",
) -> PaddedForest:
    """Pad once, score many: cached kernel-aligned buffers for ``ens``.

    ``boundaries`` are cumulative segment ends in tree units (ascending,
    last == ``ens.n_trees``); ``None`` means one segment.
    """
    T, N = ens.feature.shape
    boundaries = tuple(int(b) for b in boundaries) if boundaries is not None else (T,)
    if (
        boundaries[-1] != T or boundaries[0] <= 0
        or list(boundaries) != sorted(set(boundaries))
    ):
        raise ValueError(f"boundaries {boundaries} must ascend to n_trees={T}")
    block_t = min(block_t, _next_pow2(max(T, 1)))
    if leaf_gather == "auto":
        leaf_gather = resolve_leaf_gather(ens.n_leaves)

    cache = ens._padded_cache
    key = (boundaries, block_t, leaf_gather)
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    FIRST_TOUCHES["padded_forest"] += 1

    n_pad = _next_pow2(max(N, 2))
    inf = float("inf")
    feat = _pad_to(ens.feature, 1, n_pad)
    thr = _pad_to(ens.threshold.float(), 1, n_pad, inf)
    mask = _pad_to(ens.mask, 1, n_pad, ALL_ONES)
    leaf = ens.leaf_value.float()
    leaf_layout = "native"
    if leaf_gather == "select":
        # Pad values are 0 and unreachable (every exit leaf index is below
        # the real leaf count).
        leaf = _pad_to(leaf, 1, _next_pow2(max(ens.n_leaves, 1)))
        leaf_layout = "pow2"

    parts = {name: [] for name in ("feat", "thr", "mask", "leaf")}
    seg_block_starts, seg_blocks = [], []
    start = offset = 0
    for end in boundaries:
        parts["feat"].append(_pad_to(feat[start:end], 0, block_t))
        parts["thr"].append(_pad_to(thr[start:end], 0, block_t, inf))
        parts["mask"].append(_pad_to(mask[start:end], 0, block_t, ALL_ONES))
        parts["leaf"].append(_pad_to(leaf[start:end], 0, block_t))
        nb = parts["feat"][-1].shape[0] // block_t
        seg_block_starts.append(offset)
        seg_blocks.append(nb)
        offset += nb
        start = end

    feature = torch.cat(parts["feat"]).contiguous()
    threshold = torch.cat(parts["thr"]).contiguous()
    mask = torch.cat(parts["mask"]).contiguous()
    leaf_value = torch.cat(parts["leaf"]).contiguous()
    pf = PaddedForest(
        feature=feature,
        threshold=threshold,
        mask=mask,
        leaf_value=leaf_value,
        base_score=ens.base_score,
        boundaries=boundaries,
        seg_block_starts=tuple(seg_block_starts),
        seg_blocks=tuple(seg_blocks),
        block_t=block_t,
        leaf_gather=leaf_gather,
        leaf_layout=leaf_layout,
        n_nodes=N,
        n_leaves=ens.n_leaves,
        nodes=pack_nodes(feature, threshold, mask),
        leaves=pack_leaves(leaf_value),
    )
    cache[key] = pf
    while len(cache) > PADDED_CACHE_MAX:
        cache.popitem(last=False)
    return pf


def forest_score_range(
    pf: PaddedForest,
    X: torch.Tensor,
    seg_lo: int = 0,
    seg_hi: int | None = None,
    *,
    count_as: str = "plain",
    n_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Score ``X: [B, F]`` through segments ``[seg_lo, seg_hi)`` — 1 launch.

    ``base_score`` is added when the range starts at segment 0, and an
    explicit ``0.0`` otherwise, as the reference does. ``n_valid`` (a
    one-element int32 tensor on ``X``'s device) gates the launch on the
    device: the kernel writes 0 for rows at or past it and does no tree
    work for them. The engine passes it on every compacted block, the
    count of its compaction; ``count_as`` only says how the launch is
    counted (``gated``: the query-exit tail, as in the reference).
    """
    seg_hi = pf.n_segments if seg_hi is None else seg_hi
    if not 0 <= seg_lo < seg_hi <= pf.n_segments:
        raise ValueError(f"segment range [{seg_lo}, {seg_hi}) of {pf.n_segments}")
    if count_as not in ("plain", "gated"):
        raise ValueError(count_as)
    _LAUNCH_COUNTS[count_as] += 1
    scores = forest_score_kernel(
        X.float().contiguous(), pf.feature, pf.threshold, pf.mask, pf.leaf_value,
        block_t=pf.block_t,
        tree_block_offset=pf.seg_block_starts[seg_lo],
        n_tree_blocks=sum(pf.seg_blocks[seg_lo:seg_hi]),
        leaf_gather=pf.leaf_gather,
        packed=pf.packed,
        n_valid=n_valid,
    )
    base = pf.base_score if seg_lo == 0 else torch.zeros_like(pf.base_score)
    return scores + base


def forest_score_segments(
    pf: PaddedForest, X: torch.Tensor, n_segments: int | None = None
) -> torch.Tensor:
    """Per-segment partial scores ``[B, S]`` for segments ``[0, S)`` — 1
    launch. Prefix scores are ``seg[:, 0] + base``, then ``+ seg[:, k]``
    left to right."""
    S = pf.n_segments if n_segments is None else n_segments
    if not 0 < S <= pf.n_segments:
        raise ValueError(f"n_segments {S} of {pf.n_segments}")
    _LAUNCH_COUNTS["segmented"] += 1
    return forest_score_segments_kernel(
        X.float().contiguous(), pf.feature, pf.threshold, pf.mask, pf.leaf_value,
        seg_block_starts=pf.seg_block_starts[:S],
        n_tree_blocks=pf.seg_block_starts[S - 1] + pf.seg_blocks[S - 1],
        block_t=pf.block_t,
        leaf_gather=pf.leaf_gather,
        packed=pf.packed,
    )


def forest_score(
    ens: TreeEnsemble,
    X: torch.Tensor,
    *,
    block_t: int = 16,
    leaf_gather: str = "auto",
) -> torch.Tensor:
    """Score ``X: [B, F]`` through the whole ensemble — 1 launch."""
    pf = padded_forest(ens, block_t=block_t, leaf_gather=leaf_gather)
    return forest_score_range(pf, X)
