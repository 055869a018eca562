"""Forest-scoring kernels: CUDA for the card, plain PyTorch for the CPU.

The port of :mod:`repro.kernels.forest_score`. Two kernels, each a wrapper
with a launch counter and a plain PyTorch version beside it:

- :func:`forest_score_kernel` (replaces ``forest_score_pallas``): scores
  ``x [B, F]`` through one contiguous range of tree blocks → ``[B]``. With
  ``n_valid`` (a one-element int32 tensor on the device, the survivor count
  of a compacted block) rows at or past the count are 0 and cost no tree
  work; the kernel reads the count itself, so the host never waits.
- :func:`forest_score_segments_kernel` (replaces
  ``forest_score_segments_pallas``): scores tree blocks ``[0, n)`` and adds
  each block's partial into the column of its segment → ``[B, S]``.

The CUDA source is ``repro_torch/csrc/forest_score.cu``; its header says
what bounds the kernels on an H100 and how the design answers it. The
kernels read the tables as packed records (:func:`pack_nodes`,
:func:`pack_leaves`), which :func:`repro_torch.kernels.ops.padded_forest`
builds once per buffer set and passes as ``packed``; a call without them
packs on the fly. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises. It never falls back. Given
``meta`` tensors (the dry run, which computes nothing) it shapes its result
through the plain version's ops.

The wrappers' operands carry ``Tensor["dims", dtype]`` annotations
(:mod:`repro_torch.typecheck`); :func:`repro_torch.typecheck.shape_checked`
enforces them in the tests, and production calls stay unwrapped.

Both versions keep the reference kernel's order of summation, so they are
bit-exact with it and with each other on finite inputs: per tree block the
``block_t`` leaf values are summed by the contiguous-halves chain of
``_pairwise_tree_sum``, and the blocks are added in order into an
accumulator that starts at 0. Leaf values are gathered directly; the
reference's three leaf-gather variants move the same values, so
``leaf_gather`` only selects the buffer layout (:mod:`.ops`).

The feature gather is a true gather (as in ``repro.kernels.ref`` and
``score_bitvector``), not the Pallas kernel's one-hot matmul: a NaN or inf
feature affects only the nodes that test it. Masks are int64 bit patterns
(see :mod:`repro_torch.forest.ensemble`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels.build import (  # noqa: F401 -- set_build_dir: kept importable here
    FIRST_TOUCHES,
    KERNEL_LAUNCHES,
    on_device,
    set_build_dir,
)
from repro_torch.typecheck import Tensor

ALL_ONES = -1
LEAF_GATHERS = ("onehot", "select", "mxu")
CUDA_BLOCK_TS = (1, 2, 4, 8, 16, 32)  # the kernel's block_t instantiations
CUDA_MAX_SEGMENTS = 16    # kMaxSegments in forest_score.cu
NODE_BYTES = 16           # one packed node record {feature, threshold, mask}

# The decomposition forced on the CUDA launches, as (warps on documents,
# warps on the trees of a block, tree blocks per CTA); 0 lets the launcher
# choose from B and n_blocks. For tests that pin a decomposition, and for
# tuning.
GRID_PLAN = (0, 0, 0)

# Bound on the [B, trees, N] working set of one step of the plain version.
_PLAIN_CHUNK_ELEMS = 1 << 22

# Scratch of the kernels' last-CTA reduction, per (device, stream), grown
# as needed: the per-block partial sums (f32) and the arrival counters
# (int32, which the kernel leaves zeroed). Launches in order on one stream
# share them.
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

# cuda_max_features per (device, N, L, block_t), as the library reports it.
_MAX_FEATURES: dict[tuple[int, int, int, int], int] = {}


def first_touches() -> dict[str, int]:
    """First-touch counts since the process started:
    :data:`repro_torch.kernels.build.FIRST_TOUCHES` and ``plans``, the
    launch plans the library has made (0 before it is loaded). Serving a
    warmed shape moves none of them."""
    lib = build.loaded("forest_score")
    return {**FIRST_TOUCHES, "plans": 0 if lib is None else lib.forest_score_plan_count()}


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _bind(lib: build.Library) -> None:
    """Declare the forest library's C functions' types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forest_score_range.argtypes = [
        p, i, i, p, p, i, i, i, i, i, i, p, p, p, p, i, i, i, p,
    ]
    lib.forest_score_segments.argtypes = [
        p, i, i, p, p, i, i, i, i, i, p, i, p, p, p, i, i, i, p,
    ]
    lib.forest_score_plan.argtypes = [i, i, i, i, i, i, i, i, i, i, i, p]
    lib.forest_score_max_features.argtypes = [i, i, i, p]
    lib.forest_score_plan_count.argtypes = []
    for fn in (
        lib.forest_score_range, lib.forest_score_segments, lib.forest_score_plan,
        lib.forest_score_max_features, lib.forest_score_plan_count,
    ):
        fn.restype = i


def library() -> build.Library:
    """The forest kernel library (compiled at first use, then cached)."""
    return build.load("forest_score", _bind)


def pack_nodes(
    feature: torch.Tensor,    # [T, N] i32
    threshold: torch.Tensor,  # [T, N] f32
    mask: torch.Tensor,       # [T, N] i64
) -> torch.Tensor:
    """The kernel's node records ``[T, N, 4]`` i32: per node 16 bytes,
    ``{feature, threshold bits, mask low word, mask high word}`` — the
    kernel's ``Node`` (an ``int4``) in ``forest_score.cu`` (little-endian)."""
    words = mask.contiguous().view(torch.int32).reshape(*mask.shape, 2)
    return torch.stack(
        [feature, threshold.contiguous().view(torch.int32), words[..., 0], words[..., 1]],
        dim=-1,
    ).contiguous()


def pack_leaves(leaf_value: torch.Tensor) -> torch.Tensor:
    """Leaf rows ``[T, L4]`` f32, the leaf axis zero-padded to a multiple of
    4 so a tree block's row is whole 16-byte units (one bulk copy)."""
    T, L = leaf_value.shape
    pad = (-L) % 4
    if pad == 0:
        return leaf_value.contiguous()
    zeros = torch.zeros(T, pad, dtype=leaf_value.dtype, device=leaf_value.device)
    return torch.cat([leaf_value, zeros], dim=1).contiguous()


def cuda_max_features(N: int, L: int, block_t: int, device: int | None = None) -> int:
    """The widest ``x`` (features) the CUDA kernels take for these tables on
    ``device`` (default: the current card), as the library reports it: the
    shared-memory document tile of the narrowest CTA beside the tree-block
    ring (``forest_score_max_features`` in the source)."""
    dev = torch.cuda.current_device() if device is None else device
    key = (dev, N, L, block_t)
    max_f = _MAX_FEATURES.get(key)
    if max_f is None:
        out = ctypes.c_int()
        with torch.cuda.device(dev):
            _launch(
                library().forest_score_max_features, N, L + (-L) % 4, block_t,
                ctypes.cast(ctypes.pointer(out), ctypes.c_void_p),
            )
        max_f = _MAX_FEATURES[key] = out.value
        FIRST_TOUCHES["max_features"] += 1
    return max_f


def check_cuda_shapes(
    F: int, N: int, L: int, block_t: int, n_seg: int = 1, device: int | None = None
) -> None:
    """Raise ``ValueError`` for what the CUDA kernels cannot take: a
    ``block_t`` without an instantiation, more than 16 segments, an ``x``
    wider than the shared document tile holds (:func:`cuda_max_features`)."""
    if block_t not in CUDA_BLOCK_TS:
        raise ValueError(
            f"CUDA forest kernel: block_t={block_t} must be one of {CUDA_BLOCK_TS}"
        )
    if not 1 <= n_seg <= CUDA_MAX_SEGMENTS:
        raise ValueError(
            f"CUDA segmented kernel: {n_seg} segments, at most {CUDA_MAX_SEGMENTS}"
        )
    max_f = cuda_max_features(N, L, block_t, device)
    if not 1 <= F <= max_f:
        raise ValueError(
            f"CUDA forest kernel: F={F} features outside [1, {max_f}], what the "
            f"shared-memory document tile holds beside block_t={block_t} x N={N} "
            f"x L={L} tables"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version: the CPU path, and what the kernels are held to.
# ---------------------------------------------------------------------------


def _and_reduce(m: torch.Tensor) -> torch.Tensor:
    """AND over the last axis by contiguous halves (order-free for AND)."""
    n = m.shape[-1]
    while n > 1:
        half = n // 2
        red = m[..., :half] & m[..., half:2 * half]
        if n % 2:
            red = torch.cat([red, m[..., 2 * half:]], dim=-1)
        m = red
        n = m.shape[-1]
    return m[..., 0]


def ctz64(m: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of nonzero int64 bit patterns.

    Works on the two 32-bit halves so no step overflows: ``v & -v`` of a
    half is an exact power of two below 2**32, and ``frexp`` reads its
    exponent exactly.
    """
    lo = m & 0xFFFFFFFF
    hi = (m >> 32) & 0xFFFFFFFF
    lo_nz = lo != 0
    v = torch.where(lo_nz, lo, hi)
    low = (v & -v).to(torch.float64)
    bit = torch.frexp(low).exponent.to(torch.int64) - 1
    return torch.where(lo_nz, bit, bit + 32)


def exit_leaves(
    x: torch.Tensor,          # [B, F] f32
    feature: torch.Tensor,    # [T, N] i32
    threshold: torch.Tensor,  # [T, N] f32
    mask: torch.Tensor,       # [T, N] i64
) -> torch.Tensor:
    """Exit leaf per (doc, tree) by QuickScorer mask AND → ``[B, T]`` i64."""
    pred = x[:, feature.long()] <= threshold            # NaN → False → mask
    m = torch.where(pred, torch.full_like(mask, ALL_ONES), mask)
    return ctz64(_and_reduce(m))


def pairwise_tree_sum(per_tree: torch.Tensor) -> torch.Tensor:
    """Contiguous-halves sum over the last axis, the reference's
    ``_pairwise_tree_sum`` order (odd lengths carry the trailing element)."""
    n = per_tree.shape[-1]
    while n > 1:
        half = n // 2
        summed = per_tree[..., :half] + per_tree[..., half:2 * half]
        if n % 2:
            summed = torch.cat([summed, per_tree[..., 2 * half:]], dim=-1)
        per_tree = summed
        n = per_tree.shape[-1]
    return per_tree[..., 0]


def _block_partials(
    x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
    mask: torch.Tensor, leaf_value: torch.Tensor, block_t: int, block_lo: int,
    n_blocks: int,
) -> torch.Tensor:
    """Per-tree-block partial sums ``[B, n_blocks]`` of blocks
    ``[block_lo, block_lo + n_blocks)``, a bounded chunk of blocks at a time."""
    B, N = x.shape[0], feature.shape[1]
    per_chunk = max(1, _PLAIN_CHUNK_ELEMS // max(B * block_t * N, 1))
    parts = []
    for j0 in range(0, n_blocks, per_chunk):
        c = min(per_chunk, n_blocks - j0)
        t0 = (block_lo + j0) * block_t
        t1 = t0 + c * block_t
        leaves = exit_leaves(x, feature[t0:t1], threshold[t0:t1], mask[t0:t1])
        rows = torch.arange(t1 - t0, device=x.device)
        vals = leaf_value[t0:t1][rows[None, :], leaves]      # [B, c·block_t]
        parts.append(pairwise_tree_sum(vals.reshape(B, c, block_t)))
    return torch.cat(parts, dim=1)


def _accumulate(partials: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``0 + p[lo] + p[lo+1] + …`` left to right, as the kernel accumulates."""
    acc = torch.zeros(partials.shape[0], dtype=torch.float32, device=partials.device)
    for j in range(lo, hi):
        acc = acc + partials[:, j]
    return acc


def forest_score_plain(
    x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
    mask: torch.Tensor, leaf_value: torch.Tensor, *,
    block_t: int, tree_block_offset: int, n_tree_blocks: int,
    n_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`forest_score_kernel` → ``[B]``; rows at or
    past ``n_valid`` are 0."""
    partials = _block_partials(
        x, feature, threshold, mask, leaf_value,
        block_t, tree_block_offset, n_tree_blocks,
    )
    out = _accumulate(partials, 0, n_tree_blocks)
    if n_valid is None:
        return out
    rows = torch.arange(out.shape[0], device=out.device)
    return torch.where(rows < n_valid.reshape(()), out, torch.zeros_like(out))


def forest_score_segments_plain(
    x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
    mask: torch.Tensor, leaf_value: torch.Tensor, *,
    block_t: int, seg_block_starts: tuple[int, ...], n_tree_blocks: int,
) -> torch.Tensor:
    """Plain version of :func:`forest_score_segments_kernel` → ``[B, S]``."""
    partials = _block_partials(
        x, feature, threshold, mask, leaf_value, block_t, 0, n_tree_blocks,
    )
    ends = (*seg_block_starts[1:], n_tree_blocks)
    return torch.stack(
        [_accumulate(partials, lo, hi) for lo, hi in zip(seg_block_starts, ends)],
        dim=1,
    )


# ---------------------------------------------------------------------------
# Wrappers: check, then the plain version on the CPU or the kernel on the card.
# ---------------------------------------------------------------------------


def _expect(
    t: torch.Tensor, dtype: torch.dtype, shape: tuple[int, ...], device: torch.device
) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"forest kernel: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"forest kernel: tensors on {t.device} and {device}")
    if not t.is_contiguous():
        raise ValueError("forest kernel: inputs must be contiguous")


def _check(
    x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
    mask: torch.Tensor, leaf_value: torch.Tensor, block_t: int, block_lo: int,
    n_blocks: int, leaf_gather: str,
) -> None:
    B, F = x.shape
    T, N = feature.shape
    L = leaf_value.shape[1]
    _expect(x, torch.float32, (B, F), x.device)
    _expect(feature, torch.int32, (T, N), x.device)
    _expect(threshold, torch.float32, (T, N), x.device)
    _expect(mask, torch.int64, (T, N), x.device)
    _expect(leaf_value, torch.float32, (T, L), x.device)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"forest kernel: unsupported device {x.device}")
    if T % block_t or N & (N - 1):
        raise ValueError(
            f"forest kernel: T={T} must be a multiple of block_t={block_t} "
            f"and N={N} a power of two"
        )
    if not 0 <= block_lo or not 0 < n_blocks <= T // block_t - block_lo:
        raise ValueError(
            f"forest kernel: tree blocks [{block_lo}, {block_lo + n_blocks}) "
            f"outside [0, {T // block_t})"
        )
    if leaf_gather not in LEAF_GATHERS:
        raise ValueError(f"forest kernel: leaf_gather {leaf_gather!r}")
    if leaf_gather == "select" and L & (L - 1):
        raise ValueError(
            f"leaf_gather='select' needs a power-of-two leaf axis, got {L} — "
            "use repro_torch.kernels.ops.padded_forest (it pads the leaf axis)"
        )


def _cuda_operands(
    x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
    mask: torch.Tensor, leaf_value: torch.Tensor,
    packed: tuple[torch.Tensor, torch.Tensor] | None, n_blocks: int,
) -> tuple:
    """The kernels' operands beyond ``x``: packed tables (given or packed
    now), the stream's scratch (partials and arrival counters) and the
    stream."""
    T, N = feature.shape
    L = leaf_value.shape[1]
    if packed is None:
        packed = (pack_nodes(feature, threshold, mask), pack_leaves(leaf_value))
    nodes, leaves = packed
    L4 = L + (-L) % 4
    if (
        nodes.dtype is not torch.int32 or leaves.dtype is not torch.float32
        or nodes.shape != (T, N, NODE_BYTES // 4) or leaves.shape != (T, L4)
        or nodes.device != x.device or leaves.device != x.device
        or not (nodes.is_contiguous() and leaves.is_contiguous())
    ):
        raise ValueError(
            f"forest kernel: packed tables {nodes.dtype} {tuple(nodes.shape)} and "
            f"{leaves.dtype} {tuple(leaves.shape)} on {nodes.device}/{leaves.device}, "
            f"expected contiguous int32 {(T, N, NODE_BYTES // 4)} and float32 "
            f"{(T, L4)} on {x.device}"
        )
    B = x.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device.index, stream)
    partials, arrivals = _SCRATCH.get(key, (None, None))
    tiles = -(-B // 32)  # at least the most tiles any plan launches
    if partials is None or partials.numel() < n_blocks * B:
        partials = torch.empty(n_blocks * B, dtype=torch.float32, device=x.device)
        FIRST_TOUCHES["scratch"] += 1
    if arrivals is None or arrivals.numel() < tiles:
        arrivals = torch.zeros(max(tiles, 64), dtype=torch.int32, device=x.device)
        FIRST_TOUCHES["scratch"] += 1
    _SCRATCH[key] = (partials, arrivals)
    return (nodes, leaves, L4, partials, arrivals, stream)


def _launch(fn: ctypes._CFuncPtr, *args: int) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"forest kernel launch failed: cudaError_t {err}")


def launch_plan(
    B: int, F: int, N: int, L: int, block_t: int, n_blocks: int,
    segmented: bool = False,
) -> dict[str, int]:
    """The grid the CUDA launcher picks for these sizes (under
    :data:`GRID_PLAN`): warps on documents and on trees, documents per
    tile, tree blocks per chunk, grid x (tiles) and y (chunks), resident
    CTAs per SM."""
    out = (ctypes.c_int * 7)()
    _launch(
        library().forest_score_plan, B, F, N, L, L + (-L) % 4, block_t, n_blocks,
        int(segmented), *GRID_PLAN, ctypes.cast(out, ctypes.c_void_p),
    )
    keys = ("warps_d", "warps_t", "tile", "chunk", "tiles", "chunks", "ctas_per_sm")
    return dict(zip(keys, out))


def _annotate_plan(
    B: int, F: int, N: int, L: int, block_t: int, n_blocks: int, segmented: bool,
) -> None:
    """While recording, set the launch's plan on the innermost open span
    (``tile_rows``: documents a CTA's tile; ``tree_warps``; ``ctas_per_sm``):
    the library's cached plan of the launch just made, read on the host."""
    sp = tracing.active()
    if sp is not None:
        p = launch_plan(B, F, N, L, block_t, n_blocks, segmented)
        sp.set(tile_rows=p["tile"], tree_warps=p["warps_t"], ctas_per_sm=p["ctas_per_sm"])


def forest_score_kernel(
    x: Tensor["b f", torch.float32],
    feature: Tensor["t n", torch.int32],     # T % block_t == 0, N power of two
    threshold: Tensor["t n", torch.float32],
    mask: Tensor["t n", torch.int64],
    leaf_value: Tensor["t l", torch.float32],
    *,
    block_t: int = 16,
    tree_block_offset: int = 0,
    n_tree_blocks: int | None = None,
    leaf_gather: str = "onehot",
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
    n_valid: torch.Tensor | None = None,
) -> Tensor["b", torch.float32]:
    """Score ``x`` through tree blocks ``[offset, offset + n)`` → ``[B]``.

    ``packed``: the same tables as (:func:`pack_nodes`, :func:`pack_leaves`),
    which the CUDA kernel reads; packed per call when omitted. ``n_valid``:
    a one-element int32 tensor on ``x``'s device; rows at or past its value
    are 0, the rows below it equal the ungated call's. The kernel reads it
    on the device, in stream order.
    """
    T = feature.shape[0]
    if n_tree_blocks is None:
        n_tree_blocks = T // block_t - tree_block_offset
    _check(x, feature, threshold, mask, leaf_value, block_t,
           tree_block_offset, n_tree_blocks, leaf_gather)
    if n_valid is not None and (
        n_valid.dtype is not torch.int32 or n_valid.numel() != 1
        or n_valid.device != x.device
    ):
        raise ValueError(
            f"forest kernel: n_valid must be one int32 on {x.device}, got "
            f"{n_valid.dtype} {tuple(n_valid.shape)} on {n_valid.device}"
        )
    if x.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
        return forest_score_plain(
            x, feature, threshold, mask, leaf_value, block_t=block_t,
            tree_block_offset=tree_block_offset, n_tree_blocks=n_tree_blocks,
            n_valid=n_valid,
        )
    B, F = x.shape
    N, L = feature.shape[1], leaf_value.shape[1]
    with on_device(x):
        check_cuda_shapes(F, N, L, block_t, device=x.device.index)
        out = torch.empty(B, dtype=torch.float32, device=x.device)
        if B == 0:
            return out
        nodes, leaves, L4, partials, arrivals, stream = _cuda_operands(
            x, feature, threshold, mask, leaf_value, packed, n_tree_blocks
        )
        _launch(
            library().forest_score_range,
            x.data_ptr(), B, F, nodes.data_ptr(), leaves.data_ptr(), N, L, L4,
            block_t, tree_block_offset, n_tree_blocks, partials.data_ptr(),
            arrivals.data_ptr(), out.data_ptr(),
            None if n_valid is None else n_valid.data_ptr(), *GRID_PLAN, stream,
        )
        _annotate_plan(B, F, N, L, block_t, n_tree_blocks, segmented=False)
    KERNEL_LAUNCHES["forest_score"] += 1
    return out


def forest_score_segments_kernel(
    x: Tensor["b f", torch.float32],
    feature: Tensor["t n", torch.int32],
    threshold: Tensor["t n", torch.float32],
    mask: Tensor["t n", torch.int64],
    leaf_value: Tensor["t l", torch.float32],
    *,
    seg_block_starts: tuple[int, ...],  # ascending, seg_block_starts[0] == 0
    n_tree_blocks: int,                 # launch covers blocks [0, n)
    block_t: int = 16,
    leaf_gather: str = "onehot",
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tensor["b s", torch.float32]:
    """Per-segment partial scores ``[B, S]`` in one launch.

    Segment ``k`` covers tree blocks ``[seg_block_starts[k],
    seg_block_starts[k+1])`` (the last runs to ``n_tree_blocks``); prefix
    scores at sentinel ``k`` are the left-to-right sum of columns ``0..k``.
    ``packed`` as for :func:`forest_score_kernel`.
    """
    _check(x, feature, threshold, mask, leaf_value, block_t, 0,
           n_tree_blocks, leaf_gather)
    starts = tuple(int(s) for s in seg_block_starts)
    if (
        not starts or starts[0] != 0 or list(starts) != sorted(set(starts))
        or starts[-1] >= n_tree_blocks
    ):
        raise ValueError(
            f"seg_block_starts {starts} must ascend from 0 below {n_tree_blocks}"
        )
    if x.device.type in ("cpu", "meta"):
        return forest_score_segments_plain(
            x, feature, threshold, mask, leaf_value, block_t=block_t,
            seg_block_starts=starts, n_tree_blocks=n_tree_blocks,
        )
    B, F = x.shape
    S = len(starts)
    N, L = feature.shape[1], leaf_value.shape[1]
    with on_device(x):
        check_cuda_shapes(F, N, L, block_t, S, device=x.device.index)
        out = torch.empty((B, S), dtype=torch.float32, device=x.device)
        if B == 0:
            return out
        nodes, leaves, L4, partials, arrivals, stream = _cuda_operands(
            x, feature, threshold, mask, leaf_value, packed, n_tree_blocks
        )
        c_starts = (ctypes.c_int * S)(*starts)
        _launch(
            library().forest_score_segments,
            x.data_ptr(), B, F, nodes.data_ptr(), leaves.data_ptr(), N, L, L4,
            block_t, n_tree_blocks, ctypes.cast(c_starts, ctypes.c_void_p), S,
            partials.data_ptr(), arrivals.data_ptr(), out.data_ptr(), *GRID_PLAN,
            stream,
        )
        _annotate_plan(B, F, N, L, block_t, n_tree_blocks, segmented=True)
    KERNEL_LAUNCHES["forest_score_segments"] += 1
    return out
