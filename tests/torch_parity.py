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


# ---------------------------------------------------------------------------
# The tie rule of GBDT training parity.
#
# Two trainers that add the same gradients in different orders build
# histograms that differ in the last bits, so a split whose gain ties
# another within that noise may go either way, and every later node and tree
# follows it. The rule: walk the trees in boosting order; where the two
# structures are equal, the leaf values agree within ``leaf_tol``; at every
# node where they differ, the split taken by ``got`` has a gain within
# ``rel`` (relative) of that node's best gain, both recomputed in float64
# from ``want``'s histogram (``want``'s rows and gradients). Below such a
# node, and in every later round, the two trainings no longer compare.
# ---------------------------------------------------------------------------


def tree_bins(feature, threshold, edges) -> np.ndarray:
    """Bin-space split of each node of real-threshold trees ``[T, n_int]``:
    ``b`` with ``threshold == edges[feature, b]``; ``+inf`` is the dead
    node's sentinel bin ``n_edges``."""
    feature = np.asarray(feature)
    threshold = np.asarray(threshold, np.float32)
    n_edges = edges.shape[1]
    out = np.full(feature.shape, n_edges, dtype=np.int64)
    for idx in zip(*np.nonzero(np.isfinite(threshold))):
        row = edges[feature[idx]]
        b = int(np.searchsorted(row, threshold[idx], side="left"))
        assert row[b] == threshold[idx], (idx, threshold[idx])
        out[idx] = b
    return out


def _level_gains(Xb, g, h, node, n_nodes, params) -> np.ndarray:
    """Float64 split gains ``[n_nodes, F · n_bins]`` of one level, with
    invalid splits at -inf, as the trainer's formula computes them."""
    N, F = Xb.shape
    nb = params.n_bins
    key = ((node[:, None] * F + np.arange(F)[None, :]) * nb + Xb).reshape(-1)
    size = n_nodes * F * nb
    gl, hl = (
        np.cumsum(np.bincount(key, np.repeat(v, F), minlength=size).reshape(n_nodes, F, nb), 2)
        for v in (g, h)
    )
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]
    gr, hr = gt - gl, ht - hl
    lam = params.reg_lambda
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - gt * gt / (ht + lam)
    valid = (hl >= params.min_child_hess) & (hr >= params.min_child_hess)
    valid &= np.arange(nb)[None, None, :] < nb - 1
    return np.where(valid, gain, -np.inf).reshape(n_nodes, F * nb)


def check_tree_tie_rule(Xb, g, h, got, want, params, *, leaf_tol=1e-6, rel=1e-5) -> bool:
    """One tree: ``got`` and ``want`` are ``(feature, bin, leaf_value)`` in
    heap order; ``g``/``h`` the gradients ``want`` was fit on. Raises
    ``AssertionError`` where the rule fails; returns whether the structures
    are equal."""
    Xb = np.asarray(Xb, np.int64)
    g, h = np.asarray(g, np.float64), np.asarray(h, np.float64)
    fa, ba, la = (np.asarray(a) for a in got)
    fb, bb, lb = (np.asarray(a) for a in want)
    N = Xb.shape[0]
    node = np.zeros(N, dtype=np.int64)
    comparable = np.ones(1, dtype=bool)
    equal = True
    for level in range(params.depth):
        n_nodes = 1 << level
        lo = n_nodes - 1
        f_a, b_a = fa[lo:lo + n_nodes], ba[lo:lo + n_nodes]
        f_b, b_b = fb[lo:lo + n_nodes], bb[lo:lo + n_nodes]
        differ = comparable & ((f_a != f_b) | (b_a != b_b))
        if differ.any():
            equal = False
            gains = _level_gains(Xb, g, h, node, n_nodes, params)
            for n in np.nonzero(differ)[0]:
                best = gains[n].max()
                chosen = gains[n, f_a[n] * params.n_bins + b_a[n]]
                if best == -np.inf:
                    assert chosen == -np.inf, (level, n, chosen)
                    continue
                assert chosen >= best - rel * abs(best), (
                    f"level {level} node {n}: split ({f_a[n]}, {b_a[n]}) gain {chosen!r} "
                    f"is not within {rel} of the best {best!r} (taken: ({f_b[n]}, {b_b[n]}))"
                )
        go_right = Xb[np.arange(N), f_b[node]] > b_b[node]
        node = 2 * node + go_right
        comparable = np.repeat(comparable & ~differ, 2)
    if equal:
        np.testing.assert_allclose(la, lb, rtol=leaf_tol, atol=leaf_tol)
    return equal


def check_training_tie_rule(Xb, grads, got, want, params, **kw) -> int:
    """Trees in boosting order (``got``/``want``: ``(feature [T, n_int],
    bin [T, n_int], leaf_value [T, L])``; ``grads``: ``want``'s ``(g, h)``
    per round). Returns the number of leading rounds with equal structure;
    the first round that differs is checked by the tie rule, and the
    trainings no longer compare after it."""
    for t, (g, h) in enumerate(grads):
        tree = lambda trees: tuple(a[t] for a in trees)
        if not check_tree_tie_rule(Xb, g, h, tree(got), tree(want), params, **kw):
            return t
    return len(grads)
