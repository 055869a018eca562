"""The plain reference of the LEAR cascade that ``correct`` is judged by.

Plain PyTorch; it imports nothing of the program and takes nothing the
program made: it reads the raw weight arrays of :mod:`lear_bench.weights`
and the request batches of :mod:`lear_bench.generator`, and works out
everything else again (no padded layout, no packed tables, no bitmasks).

What it computes, for one request ``X [Q, D, F]``, ``mask [Q, D]``, with the
exit stages' sentinels ``s_1 < ... < s_S`` (one or two) and one
confidence threshold:

1. tree traversal: each document walks each tree from the root to a leaf
   (``x[feature] <= threshold`` goes left), and a forest's score is the sum
   of its leaves;
2. the prefix score at each sentinel (the head's partial score);
3. LEAR's four sentinel-time features over the documents still alive at
   the stage: the prefix score, its rank in the query (higher score first,
   the lower slot first among equal scores), the per-query min-max
   normalised prefix (clipped to [0, 1]), and the count of alive documents;
4. the classifier's exit rule: a document continues iff
   ``sigmoid(logit) >= threshold``, i.e. ``logit >= log(t / (1 - t))``;
5. the final score: the prefix of the stage that exited the document, or
   the whole ensemble's score for the last stage's survivors;
6. the top-k of the real documents.

The judge runs it in float64 and, beside the value its own decisions give,
keeps every value a correct float32 program may return: a decision is
*fragile* where a test on the classifier's path, or the exit rule itself,
lies within what an error of ``eps`` in the prefix scores can move: each
appended feature is bounded by interval arithmetic (the prefix within
``eps``, its rank over the documents whose prefixes lie within ``2 eps``,
the normalised prefix over the query's min and max within ``eps``, the
logit within :data:`LOGIT_EPS`). A fragile document may exit or continue;
at a later stage the alive set is then known only between the documents
certainly present and those possibly present, and the features' bounds
widen to cover both. The control runs it in bfloat16 without ``eps`` and
returns its own decisions' values.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG = -1e30          # the masked-document fill of the sentinel features
LOGIT_EPS = 1e-5     # float32 rounding of a 10-leaf logit and its sigmoid
BLOCK_QUERIES = 256  # queries a block: bounds the [q, D, D] rank compare
CHUNK_ELEMS = 1 << 22  # rows x trees a traversal step


@dataclasses.dataclass
class Result:
    """The reference's answer for one request.

    ``scores``: ``[Q, D]`` the values of its own decisions (in its dtype);
    ``options``: ``[Q, D, S + 1]`` float64, at ``k < S`` the prefix at
    sentinel ``k`` where the document may exit there, at ``S`` the whole
    score where it may survive every stage, NaN elsewhere; ``top``:
    ``[Q, k]`` its own top-k; ``real``: real documents; ``survivors``: its
    own decisions' survivors of each stage; ``fragile``: documents with
    more than one option; ``first_logits``: ``[Q, D]`` the first stage's
    classifier logits (what a threshold for a continue share is read from).
    """

    scores: torch.Tensor
    options: torch.Tensor
    top: torch.Tensor
    real: int
    survivors: list[int]
    fragile: int
    first_logits: torch.Tensor


def depth_of(n_internal: int) -> int:
    """The depth of a complete tree of ``n_internal`` internal nodes."""
    return (n_internal + 1).bit_length() - 1


def forest_sum(
    rows: torch.Tensor, forest: dict, lo: int, hi: int, dtype: torch.dtype
) -> torch.Tensor:
    """Sum of the leaves of trees ``[lo, hi)`` for ``rows [B, F]`` → ``[B]``."""
    feature = forest["feature"][lo:hi]
    threshold = forest["threshold"][lo:hi].to(dtype)
    leaf = forest["leaf_value"][lo:hi].to(dtype)
    T, n_int = feature.shape
    B = rows.shape[0]
    x = rows.to(dtype)
    out = torch.zeros(B, dtype=dtype, device=rows.device)
    if B == 0:
        return out
    per = max(1, CHUNK_ELEMS // B)
    for t0 in range(0, T, per):
        t1 = min(T, t0 + per)
        tid = torch.arange(t1 - t0, device=rows.device)[None, :]
        f, th, lv = feature[t0:t1], threshold[t0:t1], leaf[t0:t1]
        node = torch.zeros((B, t1 - t0), dtype=torch.int64, device=rows.device)
        for _ in range(depth_of(n_int)):
            go_right = ~(x.gather(1, f[tid, node]) <= th[tid, node])
            node = 2 * node + 1 + go_right.long()
        out += lv[tid, node - n_int].sum(dim=1)
    return out


def classify(
    x_aug: torch.Tensor, lo: torch.Tensor | None, hi: torch.Tensor | None,
    forest: dict, n_features: int, dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The classifier's logit for ``x_aug [B, F + 4]`` and whether a test on
    its path can go either way when the four appended features lie anywhere
    in ``[lo, hi]`` (``[B, 4]``; ``None``: no interval)."""
    feature = forest["feature"]
    threshold = forest["threshold"].to(dtype)
    leaf = forest["leaf_value"].to(dtype)
    T, n_int = feature.shape
    B = x_aug.shape[0]
    tid = torch.arange(T, device=x_aug.device)[None, :]
    node = torch.zeros((B, T), dtype=torch.int64, device=x_aug.device)
    fragile = torch.zeros(B, dtype=torch.bool, device=x_aug.device)
    for _ in range(depth_of(n_int)):
        f, th = feature[tid, node], threshold[tid, node]
        x = x_aug.gather(1, f)
        if lo is not None:
            aug = f >= n_features
            a = (f - n_features).clamp_min(0)
            x_lo = torch.where(aug, lo.gather(1, a), x)
            x_hi = torch.where(aug, hi.gather(1, a), x)
            fragile |= ((x_lo <= th) != (x_hi <= th)).any(dim=1)
        node = 2 * node + 1 + (~(x <= th)).long()
    return leaf[tid, node - n_int].sum(dim=1), fragile


def stage_features(
    prefix: torch.Tensor, alive: torch.Tensor, eps: float | None,
    certain: torch.Tensor | None = None, possible: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """The four sentinel-time features ``[q, D, 4]`` over the alive
    documents (0 elsewhere), and with ``eps`` the interval ``[lo, hi]`` each
    may take in a float32 program whose alive set holds every ``certain``
    document and no document outside ``possible`` (both default to
    ``alive``) and whose prefixes lie within ``eps`` of these."""
    q, D = prefix.shape
    dtype = prefix.dtype
    s = torch.where(alive, prefix, torch.full_like(prefix, NEG))
    idx = torch.arange(D, device=prefix.device)
    col, row = s[:, None, :], s[:, :, None]           # [q, i, j]: j against i
    beats = (col > row) | ((col == row) & (idx[None, None, :] < idx[None, :, None]))
    rank = beats.sum(dim=-1).to(dtype)
    lo_p, hi_p = _min_max(prefix, alive)
    norm = _norm(prefix, lo_p, hi_p)
    n = alive.sum(dim=-1, keepdim=True).to(dtype).expand(q, D)
    aug = torch.stack([prefix, rank, norm, n], dim=-1)
    aug = torch.where(alive[..., None], aug, torch.zeros_like(aug))
    if eps is None:
        return aug, None, None
    certain = alive if certain is None else certain
    possible = alive if possible is None else possible
    other = idx[None, None, :] != idx[None, :, None]
    col, row = prefix[:, None, :], prefix[:, :, None]
    rank_lo = (certain[:, None, :] & other & (col > row + 2 * eps)).sum(dim=-1).to(dtype)
    rank_hi = (possible[:, None, :] & other & (col >= row - 2 * eps)).sum(dim=-1).to(dtype)
    # The normalised prefix falls as the query's min or max rises.
    lo_min, hi_max = _min_max(prefix, possible)
    lo_max, hi_min = _min_max(prefix, certain)
    norm_lo = _norm(prefix - eps, lo_max + eps, hi_max + eps)
    norm_hi = _norm(prefix + eps, lo_min - eps, hi_min - eps)
    n_lo = certain.sum(dim=-1, keepdim=True).to(dtype).expand(q, D)
    n_hi = possible.sum(dim=-1, keepdim=True).to(dtype).expand(q, D)
    lo = torch.stack([prefix - eps, rank_lo, norm_lo, n_lo], dim=-1)
    hi = torch.stack([prefix + eps, rank_hi, norm_hi, n_hi], dim=-1)
    return aug, lo, hi


def _min_max(prefix: torch.Tensor, member: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query min and max ``[q, 1]`` of the members' prefixes (an empty
    query gives ``inf`` and ``-inf``)."""
    lo = torch.where(member, prefix, torch.full_like(prefix, math.inf)).amin(-1, keepdim=True)
    hi = torch.where(member, prefix, torch.full_like(prefix, -math.inf)).amax(-1, keepdim=True)
    return lo, hi


def _norm(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """LEAR's min-max normalised prefix, clipped to [0, 1]."""
    return torch.clamp((p - lo) / torch.clamp_min(hi - lo, 1e-9), 0.0, 1.0)


def _grid_sum(
    rows: torch.Tensor, take: torch.Tensor, forest: dict, lo: int, hi: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Trees ``[lo, hi)`` summed for the rows where ``take [q, D]``, 0 elsewhere."""
    out = torch.zeros(take.numel(), dtype=dtype, device=rows.device)
    sel = take.reshape(-1).nonzero().squeeze(1)
    out[sel] = forest_sum(rows[sel], forest, lo, hi, dtype)
    return out.reshape(take.shape)


def cascade_block(
    X: torch.Tensor, mask: torch.Tensor, ranker: dict, classifiers: list[dict],
    sentinels: tuple[int, ...], threshold: float, dtype: torch.dtype,
    eps: float | None,
) -> tuple[torch.Tensor, torch.Tensor, list[int], int, torch.Tensor]:
    """The cascade on ``q`` queries: (own scores ``[q, D]``, options
    ``[q, D, S + 1]``, own survivors of each stage, fragile documents, the
    first stage's logits ``[q, D]``)."""
    q, D, F = X.shape
    T = ranker["feature"].shape[0]
    rows = X.reshape(q * D, F).to(dtype)
    logit_th = math.log(threshold / (1.0 - threshold))
    S = len(sentinels)
    ends = (*sentinels, T)
    options = torch.full((q, D, S + 1), math.nan, dtype=torch.float64, device=X.device)
    prefix = _grid_sum(rows, mask, ranker, 0, ends[0], dtype)
    scores = prefix.clone()
    alive = mask.clone()        # the reference's own decisions
    reach = mask.clone()        # may reach this stage under some rounding
    had_free = torch.zeros_like(mask)   # a free decision at an earlier stage
    survivors = []
    for k in range(S):
        # Off the reference's path a document may have left (a free decision
        # it passed) or stayed (a free decision that exited it): the alive
        # set, and with it every feature, is known only within these.
        maybe_in = reach & ~alive
        aug, lo, hi = stage_features(prefix, alive, eps, alive & ~had_free, alive | maybe_in)
        x_aug = torch.cat([rows, aug.reshape(q * D, 4)], dim=1)
        flat = lambda t: None if t is None else t.reshape(q * D, 4)
        logit, fragile = classify(x_aug, flat(lo), flat(hi), classifiers[k], F, dtype)
        logit, fragile = logit.reshape(q, D), fragile.reshape(q, D)
        if k == 0:
            first_logits = logit
        cont = alive & (logit >= logit_th)
        if eps is None:
            free = torch.zeros_like(alive)
        else:
            free = alive & (fragile | ((logit.double() - logit_th).abs() <= LOGIT_EPS))
            free |= maybe_in
            had_free |= free
        may_exit = reach & (~cont | free)
        options[..., k] = torch.where(may_exit, prefix.double(), options[..., k])
        reach = reach & (cont | free)
        alive = cont
        survivors.append(int(alive.sum()))
        prefix = prefix + _grid_sum(rows, reach, ranker, ends[k], ends[k + 1], dtype)
        scores = torch.where(alive, prefix, scores)
    options[..., S] = torch.where(reach, prefix.double(), options[..., S])
    fragile_docs = int(((~options.isnan()).sum(-1) > 1).sum())
    return scores, options, survivors, fragile_docs, first_logits


def reference(
    X: torch.Tensor, mask: torch.Tensor, ranker: dict, classifiers: list[dict],
    sentinels: tuple[int, ...], threshold: float, top_k: int,
    dtype: torch.dtype = torch.float64, eps: float | None = None,
) -> Result:
    """The cascade on one request, in blocks of :data:`BLOCK_QUERIES`."""
    Q, D, _ = X.shape
    scores, options, logits, survivors, fragile = [], [], [], [0] * len(sentinels), 0
    for q0 in range(0, Q, BLOCK_QUERIES):
        s, o, n, fr, lg = cascade_block(
            X[q0:q0 + BLOCK_QUERIES], mask[q0:q0 + BLOCK_QUERIES], ranker, classifiers,
            sentinels, threshold, dtype, eps,
        )
        scores.append(s)
        options.append(o)
        logits.append(lg)
        survivors = [a + b for a, b in zip(survivors, n)]
        fragile += fr
    scores_t = torch.cat(scores)
    return Result(
        scores=scores_t, options=torch.cat(options), top=top_k_of(scores_t, mask, top_k),
        real=int(mask.sum()), survivors=survivors, fragile=fragile,
        first_logits=torch.cat(logits),
    )


def top_k_of(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``min(k, D)`` slots by descending score among the real
    documents (padding last, the lower slot first among equal scores)."""
    s = scores.float()
    masked = torch.where(mask, s, torch.full_like(s, -math.inf))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    return order[:, : min(k, scores.shape[1])]
