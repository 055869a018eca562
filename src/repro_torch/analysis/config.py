"""Repo-contract knobs for the static-analysis pass.

Every rule that encodes a *project* decision (rather than a generic
PyTorch fact) reads its names from here, so the contracts stay greppable in
one place. The port of :mod:`repro.analysis.config`, re-aimed at eager
PyTorch. There is no jit in the port; its counterpart of "jit scope" is
**device scope**: everything the serving step runs between the request
block's arrival on the card and the one packed read, which must never wait
for the card. That is the region a CUDA graph will capture. The contracts:

- the progressive engine (``CascadeRanker.rank_progressive``), the kernel
  dispatch (``kernels/ops.py`` ``forest_score_range`` /
  ``forest_score_segments``), the exit strategies, the LEAR classifier and
  the dense scorer are device-scope roots: nothing they reach may sync;
- tree-axis totals in the kernels' plain versions (what the CUDA kernels
  are held to, bit for bit) go through ``pairwise_tree_sum``, and so do
  those of tree reordering;
- the engine is owned by the batcher's worker thread; only the worker run
  loop (and the post-join drain) may call into it;
- ``RankingService.rank_batch`` makes exactly ONE explicit read per batch,
  through ``repro_torch.utils.device_get``.
"""

from __future__ import annotations

# --- device scope ------------------------------------------------------
# Roots of device scope, matched as suffixes of the analyzer's
# fully-qualified ids (``module:Qual.Name``). Functions decorated with (or
# passed to) ``torch.compile`` / ``torch.jit.script`` /
# ``torch.cuda.make_graphed_callables`` are roots as well.
DEVICE_ROOT_SUFFIXES: tuple[str, ...] = (
    # the engine step
    "CascadeRanker.rank_progressive",
    # kernel dispatch: both forest kernels' wrappers are reached from here
    ":forest_score_range",
    ":forest_score_segments",
    # the per-stage strategy the service hands the engine, and the family
    # of strategies it may be
    "RankingService._make_strategy.strategy",
    ":ert_continue",
    ":ept_continue",
    ":ideal_continue",
    ":dense_keep_fraction",
    ":query_converged",
    # LEAR classifier evaluation inside the step
    "LearClassifier.prob_continue",
    "LearClassifier.continue_mask",
    # the hybrid's dense gate
    "DenseScorer.forward",
    ":dense_score",
)

# Functions that ARE the sanctioned device→host read: a call of one is a
# transfer site (TS006 counts it), and no walk descends into its body.
TRANSFER_PRIMITIVE_SUFFIXES: tuple[str, ...] = (":device_get",)

# --- TS003: sanctioned tree-axis reducers ------------------------------
# The one reducer allowed over the tree axis: contiguous halves, the
# reference kernel's order, so the plain versions stay bit-exact with the
# CUDA kernels and a reordered ensemble with the identity order.
TREE_SUM_ALLOWED: tuple[str, ...] = ("pairwise_tree_sum",)

# TS003 checks everything reachable from these roots: the kernels' plain
# versions and the tree-reordering path (host-side float64 order learning
# is exempt by construction — it never touches scores).
TREE_SUM_ROOT_SUFFIXES: tuple[str, ...] = (
    ":forest_score_plain",
    ":forest_score_segments_plain",
    ":per_tree_contributions",
    ":full_from_contributions",
    ":prefix_residual",
    ":reorder_trees",
)

# --- TS005: thread discipline ------------------------------------------
# serve/ classes whose methods face client threads, mapped to the ONLY
# methods allowed to call into the engine. ``ContinuousBatcher._run`` is
# the worker loop; ``_flush`` is called from the loop and once more from
# ``stop()`` after the worker has been joined. ``ServingTier.start`` warms
# the service before the worker exists.
SERVE_CLASS_ALLOWED_METHODS: dict[str, frozenset[str]] = {
    "ContinuousBatcher": frozenset({"_run", "_flush"}),
    "ServingTier": frozenset({"start"}),
}

# Engine entry points: calling any of these hands work to the engine and
# is only legal from the allowlisted methods above.
ENGINE_METHOD_NAMES: frozenset[str] = frozenset(
    {"rank_batch", "rank", "rank_progressive", "rank_compacted"}
)
ENGINE_FUNCTION_SUFFIXES: tuple[str, ...] = (":warmup_service",)

# --- TS007: bounded serving loops --------------------------------------
# serve/ classes that own (or supervise) the worker loop: no unbounded
# buffer and no blind ``except`` inside them without a
# ``# repro: noqa(TS007) -- why``.
WORKER_LOOP_CLASSES: frozenset[str] = frozenset(
    {"ContinuousBatcher", "WorkerSupervisor"}
)

# --- TS006: the single-transfer contract -------------------------------
# Host walk starts here; at most ONE explicit device→host transfer site
# may be reachable per call.
SINGLE_TRANSFER_ROOT_SUFFIXES: tuple[str, ...] = (
    "RankingService.rank_batch",
)
