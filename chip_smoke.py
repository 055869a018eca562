#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the LEAR serving path, its training
pipeline, the model cells, the LM serving and training paths, NequIP, the
several-card train and serving steps, the serving placements and the dry
run once on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit (``nvcc`` in ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``
or on ``PATH``)::

    python3 chip_smoke.py

Phases, each of which must pass:

- ``build``: compile ``src/repro_torch/csrc/forest_score.cu`` and
  ``sentinel_features.cu`` with nvcc for sm_90a into ``build/repro_torch/``
  and print the compiler's register and shared-memory report.
- ``serve``: a :class:`repro_torch.RankingService` over a random (seeded)
  ``lear-msn1`` ranker and classifiers, threshold 0.5, serving batches of
  8 × 256 with ragged masks: single sentinel 50, then sentinels (50, 150)
  fused, staged and ``auto`` (the service's default; its line says which
  mode it picked for each batch and the per-stage compaction capacities).
  Each run must launch its kernels (the launch counts are zeroed just
  before it and read just after), give finite scores that equal the same
  service's on the CPU within 1e-5, and the same top-k except where scores
  tie within 1e-5. A short torch.profiler window after each run prints the
  card's busy share and the top ops on card and host.
- ``tier``: :class:`repro_torch.serve.ServingTier` over the same
  ``lear-msn1`` ranker (single sentinel 50, threshold 0.4) with the
  reference bench's degradation ladder (``benchmarks/bench_serve.py``
  ``DEGRADE_RUNGS``: threshold 0.6, then 0.8 with a query-exit margin of
  2.0), doc counts (64, 128, 256) and ``BucketPolicy(max_queries=8,
  max_wait_ms=2.0, min_docs=8)``: 12 ``(Q, D)`` buckets × 3 rungs warmed.
  Two threads submit 200 single queries of 64–256 candidates (open loop,
  exponential gaps of mean 2 ms per thread). Every response must equal the
  same query ranked alone by the CPU service at the rung that served it
  (1e-5; top-k equal except ties), the warmed tier must make no first
  touch (``repro_torch.kernels.forest_score.first_touches``) and overflow
  nothing, and no future may be left unresolved after ``stop()``. Then
  rungs 1 and 2 each serve two 8 × 256 batches against the CPU service at
  the same rung, and rung 2 two more batches in which half of the queries
  carry documents that pass its threshold: those queries do not converge,
  the rest exit, and the gated tail runs with a survivor count between 0
  and its rows (checked: 0 < query_exit_rate < 1, survivors > 0).
- ``kernels``: at the ``lear-msn1`` shapes (1,047 trees of depth 6, 136
  features, 8 queries × 256 documents; the 10-tree depth-5 classifier on
  140 features), and for the ranker's compacted launches also at the
  capacities the serve runs used, call each kernel's wrapper on the card
  and hold it to its plain PyTorch version on the same inputs — max abs
  diff must be 0 — and to the numpy traversal oracle on a small input
  (1e-5). Print each kernel's time (200 back-to-back launches between one
  pair of CUDA events, after warm-up, behind a sleep kernel so the host's
  call time stays out of the window; tables warm in L2 as between serving
  batches), the plain version's, the least time the card could take and
  the launch grid. The gated tail (the range kernel given a survivor
  count) is held to its plain version at B = 1024 and 2048 with counts 0,
  1, 33, B/2 and B, and timed at counts 0 and B. The sentinel-features
  kernel is held bit for bit to its plain version at the bulk cells'
  shapes (4,096 queries × 256 slots, F = 136; × 512, F = 220) and timed
  beside it (50 launches; the plain version 3) and its bytes bound.

- ``hybrid``: the hybrid cascade (a dense stage-0 gate, keep fraction 0.35
  as the reference bench chose, ``BENCH_kernels.json`` → ``hybrid``).
  The dense scorer (``n_vec`` 4, ``vec_dim`` 16, ``hidden`` 32) is
  distilled on the card against the ``lear-msn1`` ranker on a 32 × 256
  N(0, 1) block (seed 300; 400 steps, lr 3e-3, seed 7, as
  ``benchmarks/bench_kernels.py`` ``_bench_hybrid``), and its loss must
  fall. Its parameters go to the card's and the CPU's services as numpy
  arrays. fp32 matmuls must run in full fp32 (no TF32). The hybrid service
  serves the ``serve`` batches: sentinel 50 fused, sentinels (50, 150)
  fused and staged, each held to the CPU service by the boundary rule —
  dense scores within 1e-5; every document except those within that
  tolerance of its query's keep boundary (counted and printed; none
  expected) scored within 1e-5; top-k equal except ties and those
  documents — and beside the all-trees service on the same batches
  (latency, trees traversed), with the dense scorer's device time and a
  ``[profile]`` window. Then ``ServingTier`` on a hybrid service (sentinel
  50, threshold 0.4) whose rung 1 narrows the gate to 0.2 and whose rung 2
  adds the ``tier`` ladder's rung 2: 12 buckets × 3 rungs warmed, 100
  queries from two threads, each held to the CPU service at its rung by
  the same rule, 0 first touches (the dense scorer's included), 0
  overflow, no future unresolved; then one 8 × 256 batch at each rung.
  ``kernels`` then also holds both kernels to their plain versions at the
  capacities the hybrid runs used, on blocks compacted as the dense gate
  compacts them (survivors, then padding rows).

- ``train``: the LEAR training pipeline at ``lear-msn1`` width on the
  card. ``make_letor_dataset("msn1", n_queries=1000, max_docs=256,
  seed=0)`` (136 features, ~120 real documents a query, splits 600 / 200 /
  50 / 150), made on the host and moved to the card once. λ-MART
  (``train_lambdamart``, 1,047 rounds of depth 6, learning rate 0.1, 256
  bins, NDCG@10 lambdas: 153,600 rows a round) must beat random scores'
  test NDCG@10 by more than 0.15; a second run of 20 rounds must be
  bit-equal to the first 20 trees (its rounds are timed), a
  ``[profile]`` window covers 3 rounds, and 8 rounds trained by the port
  on the CPU must meet the tie rule of ``tests/torch_parity.py`` against
  the card's first 8 (equal trees, or a split that differs only where its
  gain ties the best within 1e-5, recomputed in float64; past the first
  such split the two trainings no longer compare). Each of those 8 card
  rounds is also refit on the CPU from the card's own predictions and held
  to the card's tree by the same rule, so every round is checked.
  ``train_lear`` (sentinel 50, k 15, 10 trees of depth 5) scores the
  classifier split through the segments kernel (B = 51,200) and trains the
  classifier; the CPU from the same ranker must build bit-equal features,
  labels and weights and a classifier that meets the tie rule, free
  running and refit round by round. ``reordered_ensemble`` learns a greedy order on the tune
  split (≤ 4,096 documents), and the prefix residual at tree 50 is printed
  for it and for the identity order. The trained ranker and classifier
  then serve the test split through ``RankingService`` in 8 × 256 batches
  at sentinel 50 and thresholds 0.1, 0.3 and 0.5, each response held to
  the CPU service on the same weights (1e-5; top-k equal except ties);
  printed: NDCG@10, its loss against all trees, speedup in trees traversed,
  continue rate, the classifier's Continue/Exit precision and recall, and
  batch p50 beside ``serve``'s on random weights. ``kernels`` also holds
  the segments kernel to its plain version at ``train_lear``'s launch.

- ``cells``: the model-cell path (``repro_torch.models.api.make_cell``).
  First both launchers at the reference's defaults (smoke configs):
  ``launch.serve`` for ``dlrm-rm2`` and ``lear-msn1`` (9 forest kernel
  launches), ``launch.train`` for ``dlrm-rm2`` (20 steps, checkpoints at
  10 and 20 in a temporary directory under ``build/``), and
  ``launch.train`` for ``lear-msn1``, which must exit as the reference's
  does. Then each cell at full width and its published shapes, one cell at
  a time, each printing its peak memory (``max_memory_allocated``) and its
  step time (CUDA events, median after one warm step): DLRM-RM2 with
  45.56 GB of tables trains 5 steps on one batch of 65,536 (row-wise
  Adagrad on sparse rows, in place; the loss must fall), and step 1's loss
  and touched rows are held to the CPU port on a compact copy of the rows
  the batch touches (1e-5; rows touched by a sample whose ReLU decisions
  differ between card and CPU are set aside and counted), with sampled
  untouched rows bit-unchanged; its three serving shapes use the trained
  tables and hold their first 64 requests or 4,096 candidates to the CPU
  port on a compact copy. DeepFM, DIN and BERT4Rec train (loss falling)
  and serve (finite, of the declared shape); DIN's retrieval sweeps its
  candidates in chunks, and DIN resumes bit-exactly from a checkpoint at
  full width; BERT4Rec's two cuts are printed with their arithmetic. The
  ``lear-msn1`` cell at ``rank_xl`` (4,096 × 256 = 1,048,576 rows) and
  ``rank_online`` must launch the forest kernel 3 times a step, equal the
  same step through the kernel's plain version on the card (0 difference)
  and, for its first 64 queries, the CPU port (1e-5, documents whose
  Continue probability is within 1e-5 of the threshold set aside);
  ``kernels`` also holds its three ``rank_xl`` launches to their plain
  versions and times them.

- ``lm``: the LM serving path (``repro_torch.models.transformer``,
  ``models.moe``, ``serve.lm_serve``) at full width and depth, bfloat16
  weights drawn on the card from a device generator: Qwen3-4B (4.41 B
  parameters) and DeepSeek-MoE-16B (16.38 B; 64 experts top-6, 2 shared).
  For each: its first layers (Qwen3-4B's 2; DeepSeek's dense layer and
  first MoE layer) with the full embedding and lm_head, on the card and
  on the CPU port (prefill 2 × 64, 4 greedy steps, the CPU fed the
  card's tokens), held by ``tests/lm_parity.py`` (bfloat16 logits and
  caches within 0.125; greedy tokens equal except at a top-2 gap within
  that; a step's logits set aside where its token was re-routed at a
  near tie, margin < 0.1); the same 2 × 512 prefill twice, bit-equal;
  ``prefill_32k`` at B = 1 (cut from 32: the caches would take 154.62 /
  240.52 GB), timed against its bound, with one layer's attention timed
  alone (DeepSeek: a second prefill counts capacity drops and must equal
  the first bit for bit); ``decode_32k`` at B = 8 / 4 (cut from 128)
  against a 32,768-token cache drawn on the card, timed, with a
  ``[profile]`` window; ``generate`` (B = 2, 128-token prompts, 16
  greedy steps); then float32 weights drawn anew for prefill(512)
  against prefill(511) + ``decode_step`` at 511 (2e-4; DeepSeek with
  capacity_factor E / top_k, so no token is dropped on either path).
  Then ``launch.serve --arch qwen3-4b`` (smoke config) on the card, and
  Qwen2.5-14B, Minitron-4B and Llama-4-Maverick by shape on ``meta``.
  Values must be finite, TF32 and reduced-precision bf16 reductions off,
  and no forest kernel launched.

- ``lm_train``: the LM training path (``transformer.loss_fn``: chunked
  cross-entropy, per-layer remat, the MoE aux loss; the train cells,
  AdamW from the config) for Qwen3-4B and DeepSeek-MoE-16B at full width
  and the ``train_4k`` sequence length of 4,096. First a compact copy of
  each (2 layers of full width, DeepSeek's dense layer and one MoE layer;
  batch 2 × 256) takes one train step on the card and on the CPU port from
  the same parameters and batch: loss within 0.02, grad norm within 2%,
  every gradient within 1/16 of its leaf's max; MoE routes that differ
  must sit at a near tie (``tests/lm_parity.py``, margin < 0.1) and the
  CPU then replays the card's routing; and the card's optimizer step on
  the CPU's gradients must give the CPU's parameters within one bfloat16
  unit and its m and v within 1e-6. On the card the compact loss and
  every gradient must be bit-equal with remat ``nothing`` twice, ``dots``
  and no remat, and Qwen3-4B's compact train state (9.8 GB) must save and
  restore bit-equal through ``train/checkpoint.py``. Then full width with
  depth and batch cut so a functional AdamW step fits (printed: Qwen3-4B
  36 → 12 layers, DeepSeek 28 → 3; batch 256 / microbatch 32 → 4 / 2):
  3 steps on one batch, the loss finite and falling, step time, tokens/s
  and peak memory beside their bound and the reckoned 26 bytes a
  parameter. Then ``launch.train --arch qwen3-4b --steps 4 --ckpt-every
  2`` on the card and again with ``--steps 6``, which must resume from
  step 4.
- ``guards`` (after ``hybrid``): ``repro_torch.utils.count_host_transfers``
  around the ``serve`` models at full width — single sentinel, (50, 150)
  fused, staged and auto, the hybrid (a random dense gate at keep 0.35,
  seed 0) and query exit (threshold 0.8, k 10, margin 2.0) — each warmed
  with two 8 × 256 batches on two identical services, then three batches
  served by one unguarded and by the other under the guard, with
  ``torch.cuda.set_sync_debug_mode("warn")`` on: one explicit read
  (``device_get``) a batch, 0 implicit syncs, no sync-debug warning
  outside ``device_get``, responses bit-equal to the unguarded twin's and
  the same forest launches. Then a ``ServingTier`` (doc count 256, warmed)
  takes 50 queries under the guard: one explicit read per flushed batch,
  0 implicit, on the worker thread too. Controls: ``.item()``, a
  boolean-mask index and ``torch.nonzero`` must each count.
- ``retrieval`` (inside ``cells``, on DLRM-RM2's trained tables):
  ``TwoStageCascade`` (``examples/cascade_retrieval.py``: the cheap score
  is the candidate's embedding · the bottom-MLP vector, the full score
  DLRM's interaction) over ``retrieval_cand``'s 1,000,448 candidate ids
  at keep 1%, 5% and 20%: cascade and full-scoring times (CUDA events),
  recall of the full top 100, peak memory; the survivors must be the
  stable top-k of the cheap scores and their full scores within 1e-5 of
  the full scoring at the same positions; on a compact copy of the first
  65,536 candidates' rows, the CPU port within 1e-5 with the same
  survivors but for ties within 1e-5 at the keep boundary.
- ``shapes`` (after ``kernels``): ``repro_torch.typecheck.shape_checked``
  around both kernel wrappers on card tensors at the lear-msn1 (50, 150)
  layout, B = 2,048: bit-equal to the unwrapped calls; a wrong dtype, a
  wrong rank and a node axis that disagrees across arguments rejected.
- ``nequip``: the full NequIP config (5 layers, d_hidden 32, l_max 2,
  n_rbf 8, cutoff 5.0). ``molecule`` on a batch of its shape built as 128
  molecules of 30 atoms (``tests/nequip_parity.py``): energies, forces,
  loss and every gradient on the card within 1e-4 of the CPU port's
  (relative to each tensor's max), a rerun bit-equal, rotation
  equivariance at ``tests/test_property.py``'s tolerances, one train step.
  ``minibatch_lg`` (N 170,496, E 169,472, forces and the double backward)
  and ``full_graph_sm`` train on their synthesized inputs (loss finite;
  step time and peak printed; loss-and-gradient reruns compared);
  ``ogb_products`` by shape on ``meta``.
- ``parallel_train`` (after ``nequip``): the several-card train step on
  ``make_local_mesh(cuda:0)`` (a one-rank NCCL group) under
  ``single_pod_rules``. (a) DLRM-RM2, DeepFM and DIN ``train_batch``
  (65,536), BERT4Rec (256, the ``cells`` cut), NequIP ``minibatch_lg``
  with forces, and Qwen3-4B (12 layers) and DeepSeek-MoE-16B (3 layers)
  ``train_4k`` at ``lm_train``'s cuts, their states placed as DTensors by
  ``remesh`` (RecSys and NequIP step on their local shards: on one rank
  the row-sharded lookups and the edge and node splits must be the
  identity):
  three steps under the rules and three without, from the
  same init; losses, norms and every leaf of the final state (digests of
  its bits) must be equal; both timed with CUDA events (median of steps
  2–3) beside each one's peak memory. (b) DLRM-RM2's batch in 2 and 8
  rank shares in one process: each share's coalesced gradients reduced
  by ``reduce_sparse_rows``; a table's reduced rows no farther from the
  float64 sum of the whole batch's terms than the one-process rows plus
  1e-6 of its max (a hot row sums ~20,000 float32 terms, ROADMAP C16),
  dense leaves within 1e-6 of the one-process gradient, two runs
  bit-equal. (c) BERT4Rec with an uneven mask in 2 shares, each
  divided by the whole batch's masked count: their mean equals the
  one-process loss within 1e-6.
- ``parallel_serve`` (after ``parallel_train``): every serving cell's step
  on ``make_local_mesh(cuda:0)`` under ``single_pod_rules``
  (``models.api``'s cells through ``train.trainer.make_serve_step``), its
  state placed by ``remesh``: the four RecSys families' ``serve_p99`` and
  ``retrieval_cand`` at ``cells``' shapes and full width (DLRM-RM2's
  45.56 GB of tables, 1,000,448 candidates), Qwen3-4B (4 of 36 layers)
  and DeepSeek-MoE-16B (2 of 28: its dense layer and one MoE layer) at
  full width, prefill 1 x 4,096 and decode at ``lm``'s batches against a
  32,768-token cache drawn on the card (the placed run's caches placed by
  ``remesh`` too), and lear-msn1 ``rank_online``. Each one warm step and
  three timed each way (CUDA events); the outputs (a decode step's caches
  included) must be bit-equal to the step without rules, and the forest
  cell must launch its kernel as often (three a step).
- ``placement`` (after ``guards``): ``repro_torch.serve.placement`` at
  lear-msn1 full width, sentinels (50, 150), 8 × 256 batches, fused and
  staged: ``single_device()``, ``local()`` (the (1, 1) ``DeviceMesh``),
  ``data_parallel()`` over the visible cards, and ``data_parallel`` over
  cuda:0 named 2 and 8 times (the batch split into 2 and 8 shards along
  its queries). Scores and top-k bit-equal to ``single_device()``'s; each
  shard makes the single batch's forest launches; one explicit host read
  a batch and 0 implicit syncs under ``count_host_transfers``. A
  ``ServingTier`` of 50 queries on two shards (``health()["n_devices"]``
  2; each response equal to the query served alone). Then
  ``repro_torch.train.remesh`` moves Qwen3-4B's full-width parameters
  (8.8 GB, bfloat16) from host numpy onto ``make_local_mesh(cuda:0)``, a
  one-rank NCCL group: every leaf bit-equal; a one-rank NCCL all-reduce.
  The shards' kernel shapes join ``kernels``.
- ``dryrun`` (after ``nequip``; traced in a process of its own, started
  after ``cells``): ``repro_torch.launch.dryrun.run_cell`` for the three
  hillclimb cells (lear-msn1 ``rank_xl``, qwen2.5-14b ``train_4k``,
  nequip ``ogb_products``), dlrm-rm2 ``train_batch`` and the serving cells
  dlrm-rm2 ``retrieval_cand`` and qwen3-4b ``decode_32k`` on a fake 16 × 16
  process group, printing each cell's roofline terms, per-device memory,
  ``trace_s`` and its activation collectives, by kind and by mesh axis
  (the row lookups' sums, the node gathers and the node aggregates'
  reduce-scatters over "data" and sums over "model", the candidates'
  exchange, the decode's merged softmax); then every
  step that ``cells``, ``lm`` and ``lm_train`` timed, traced on ``meta``
  at its own config and shape, with its ``chips=1`` H100 roofline beside
  the measured time and the phase's own bound. No measured time may be
  below its compute term (the memory term is printed only: L2 can beat an
  HBM reckoning).
- ``examples`` (after ``dryrun``): the five ``examples/torch_*.py`` with
  ``--smoke`` on the card, each in a process of its own, all at once;
  each must exit 0.

The last lines are a one-line summary of the tier, the gated tail, the
hybrid, the guards, the placements, the training, the cell (with the
retrieval cascade), the LM and the NequIP runs, the several-card train
and serving steps, the dry run and the examples, the
card's name and power limit, one JSON line with the kernels' numbers, and
``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that last line, as does a machine without a card or a
directory without the repository's ``src/repro_torch``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# The card's peak rates are repro_torch.launch.roofline's (NVIDIA's H100
# SXM data sheet): HBM_BW, BF16_FLOPS, F32_FLOPS, and ALU_OPS, one 32-bit
# instruction per lane per cycle (the node tests hold no FMA).
# Per (doc, tree, node): feature load, x load, compare, select, and the
# 64-bit AND as two 32-bit ones.
OPS_PER_NODE_TEST = 6

Q, D = 8, 256            # one serving batch: 8 queries × max_docs 256
N_BATCHES = 5            # per serve run; the first includes buffer set-up
SENTINELS_2 = (50, 150)  # second sentinel: repro/launch/hillclimb.py:45 (A2)
THRESHOLD = 0.5
SEED = 0
TOL = 1e-5
DEVICE = "cuda"

# The [tier] phase: the reference bench's serving setup
# (benchmarks/bench_serve.py: baseline threshold 0.4, DEGRADE_RUNGS).
TIER_THRESHOLD = 0.4
TIER_DOC_COUNTS = (64, 128, 256)
TIER_QUERIES = 200
TIER_GAP_MS = 2.0        # mean exponential gap between one thread's submits
GATED_BS = (1024, 2048)  # the tail's serving capacity, and the full batch

# The [hybrid] phase: the reference bench's hybrid setup
# (benchmarks/bench_kernels.py _bench_hybrid: distillation at lr 3e-3, seed
# 7, 400 steps; BENCH_kernels.json → hybrid.dense_stage0: keep_frac 0.35).
HYBRID_KEEP = 0.35
HYBRID_RUNG_KEEP = 0.2   # the hybrid tier's rungs 1 and 2
HYBRID_DISTILL_QD = (32, 256)
HYBRID_TIER_QUERIES = 100

# The [train] phase: lear-msn1 width (136 features, depth 6, 256 bins,
# D = 256), the paper's splits 600 / 200 / 50 / 150 queries.
TRAIN_DATA = dict(preset="msn1", n_queries=1000, max_docs=256, seed=0)
TRAIN_ROUNDS = 1047           # never below 300 (benchmarks/common.py:39-42)
TRAIN_K = 10                  # λ-MART's NDCG@k
TRAIN_SENTINEL = 50
LEAR_K = 15
TRAIN_DETERMINISM_ROUNDS = 20
TRAIN_CPU_ROUNDS = 8
TRAIN_THRESHOLDS = (0.1, 0.3, 0.5)


# Steps timed on the card for [dryrun]'s chips=1 roofline: label, config,
# shape, measured ms and the phase's own bound (ms, or None).
TIMED: list[dict] = []


def _timed(label: str, cfg, shape, ms: float, hand_ms: float | None = None) -> None:
    TIMED.append({"label": label, "cfg": cfg, "shape": shape, "ms": ms, "hand_ms": hand_ms})


def _rf():
    """repro_torch.launch.roofline: the card's peak rates (imported once
    ``src`` is on the path)."""
    from repro_torch.launch import roofline

    return roofline


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build() -> float:
    import torch

    from repro_torch.kernels import build

    seconds = 0.0
    for name in ("forest_score", "sentinel_features"):
        t0 = time.perf_counter()
        path, report = build.build(name)
        seconds += time.perf_counter() - t0
        log(f"[build] {path.name}: {time.perf_counter() - t0:.2f} s (nvcc "
            f"{' '.join(build.NVCC_FLAGS)}; python {sys.version.split()[0]}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")
        for line in report.splitlines():
            if "ptxas info" in line:
                log(f"[build]   {line.strip()}")
    return seconds


def _models(device, sentinels):
    from repro_torch.configs.lear_msn1 import config
    from repro_torch.core.features import N_AUG
    from repro_torch.core.lear import LearClassifier
    from repro_torch.forest.ensemble import random_ensemble

    cfg = config()
    ranker = random_ensemble(
        SEED, cfg.n_trees, cfg.depth, cfg.n_features, device=device
    )
    clfs = [
        LearClassifier(
            forest=random_ensemble(
                SEED + 1 + i, cfg.classifier_trees, cfg.classifier_depth,
                cfg.n_features + N_AUG, device=device,
            ),
            sentinel=s,
        )
        for i, s in enumerate(sentinels)
    ]
    return cfg, ranker, clfs


def _bound(B: int, F: int, pf, seg_lo: int, seg_hi: int, S: int = 1,
           n_valid: int | None = None) -> tuple[float, str]:
    """The least time for the work a launch over segments [seg_lo, seg_hi)
    needs: the ensemble's own trees there (the layout's padding trees and
    node slots left out), ``pf.n_nodes`` node tests each, on ``B`` rows
    (``n_valid`` of them for the gated tail, which reads its count); bytes:
    the rows' features, the trees' 16-byte node records and leaves, each
    read once, and ``B × S`` outputs written once."""
    trees = pf.boundaries[seg_hi - 1] - (pf.boundaries[seg_lo - 1] if seg_lo else 0)
    rows = B if n_valid is None else n_valid
    tables = trees * (pf.n_nodes * (4 + 4 + 8) + pf.n_leaves * 4) if rows else 0
    nbytes = rows * F * 4 + tables + B * S * 4 + (0 if n_valid is None else 4)
    ops = OPS_PER_NODE_TEST * rows * trees * pf.n_nodes
    t_bytes, t_ops = nbytes / _rf().HBM_BW, ops / _rf().ALU_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def phase_kernels(tail_cases, hybrid_cases=(), train_cases=(), cell_cases=(),
                  placement_cases=()) -> dict:
    """Each kernel against its plain version and timed, at B = Q·D and at
    the compaction capacities of ``tail_cases`` (``(layout, seg_lo,
    seg_hi, B)`` as the serve runs launched them), and of ``hybrid_cases``
    (``(kernel, layout, seg_lo, seg_hi, B)`` as the hybrid runs launched
    them) on a block compacted as the dense gate compacts it: the rows of a
    keep fraction of the batch, then padding rows that repeat row 0; and
    the forest cell's launches ``cell_cases`` (``(label, padded forest,
    X, seg_lo, seg_hi)``) on the cell's own inputs; and the data-parallel
    shards' launches ``placement_cases`` (``(kind, seg_lo, seg_hi, B)`` on
    the (50, 150) layout)."""
    import numpy as np
    import torch

    from repro_torch.core.compaction import compact_indices_cumsum
    from repro_torch.forest.scoring import score_numpy_oracle
    from repro_torch.forest.ensemble import random_ensemble
    from repro_torch.kernels import forest_score as fs
    from repro_torch.kernels.ops import forest_score, padded_forest
    from repro_torch.utils import device_ms

    dev = torch.device(DEVICE)
    cfg, ranker, clfs = _models(dev, SENTINELS_2)
    T, B = cfg.n_trees, Q * D
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.normal(size=(B, cfg.n_features)).astype(np.float32), device=dev)
    x_aug = torch.as_tensor(
        rng.normal(size=(B, cfg.n_features + 4)).astype(np.float32), device=dev
    )
    pf1 = padded_forest(ranker, boundaries=(cfg.sentinel, T))
    pf2 = padded_forest(ranker, boundaries=(*SENTINELS_2, T))
    pfc = padded_forest(clfs[0].forest)

    def tables(pf):
        return pf.feature, pf.threshold, pf.mask, pf.leaf_value

    def range_case(label, pf, xs, seg_lo, seg_hi):
        kw = dict(
            block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[seg_lo],
            n_tree_blocks=sum(pf.seg_blocks[seg_lo:seg_hi]), leaf_gather=pf.leaf_gather,
        )
        return (
            "forest_score", label, pf, xs, kw["n_tree_blocks"], (seg_lo, seg_hi, 1),
            lambda: fs.forest_score_kernel(xs, *tables(pf), packed=pf.packed, **kw),
            lambda: fs.forest_score_plain(
                xs, *tables(pf), block_t=kw["block_t"],
                tree_block_offset=kw["tree_block_offset"],
                n_tree_blocks=kw["n_tree_blocks"],
            ),
        )

    def seg_case(label, pf, xs, S):
        n_seg_blocks = pf.seg_block_starts[S - 1] + pf.seg_blocks[S - 1]
        seg_kw = dict(
            seg_block_starts=pf.seg_block_starts[:S], n_tree_blocks=n_seg_blocks,
            block_t=pf.block_t,
        )
        return (
            "forest_score_segments", label, pf, xs, n_seg_blocks, (0, S, S),
            lambda: fs.forest_score_segments_kernel(
                xs, *tables(pf), leaf_gather=pf.leaf_gather, packed=pf.packed, **seg_kw
            ),
            lambda: fs.forest_score_segments_plain(xs, *tables(pf), **seg_kw),
        )

    layouts = {"S=1": pf1, "S=2": pf2}
    cases = [
        range_case("ranker head [0,1)", pf1, x, 0, 1),
        range_case("ranker tail [1,2)", pf1, x, 1, 2),
        range_case("classifier [0,1)", pfc, x_aug, 0, 1),
        *(
            range_case(f"ranker {layout} [{lo},{hi}) B={cap}", layouts[layout], x[:cap], lo, hi)
            for layout, lo, hi, cap in sorted(tail_cases)
        ),
        seg_case(f"ranker head S={len(SENTINELS_2)} {SENTINELS_2}", pf2, x, len(SENTINELS_2)),
    ]
    keep = torch.zeros(B, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(rng.choice(B, int(HYBRID_KEEP * B), replace=False), device=dev)] = True
    for name, layout, lo, hi, cap in sorted(hybrid_cases):
        xs = x[compact_indices_cumsum(keep, cap)[0]]
        label = f"hybrid ranker {layout} [{lo},{hi}) B={cap} ({int(keep.sum())} kept of {B})"
        if name == "forest_score":
            cases.append(range_case(label, layouts[layout], xs, lo, hi))
        else:
            cases.append(seg_case(label, layouts[layout], xs, hi))

    # train_lear's segmented launch on the classifier split, trained ranker.
    cases += [seg_case(label, pf, xs, pf.n_segments) for label, pf, xs in train_cases]
    cases += [range_case(label, pf, xs, lo, hi) for label, pf, xs, lo, hi in cell_cases]
    for kind, lo, hi, rows in sorted(placement_cases):
        label = f"placement shard {kind} [{lo},{hi}) B={rows}"
        cases.append(range_case(label, pf2, x[:rows], lo, hi) if kind == "range"
                     else seg_case(label, pf2, x[:rows], hi))

    results: dict[str, dict] = {}
    for name, label, pf, xs, n_blocks, (lo, hi, S_out), kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} or non-finite")
        err = float((got - want).abs().max())
        k_ms = device_ms(kernel, reps=200)
        p_ms = device_ms(plain, reps=5, warmup=1)
        b_ms, b_by = _bound(xs.shape[0], xs.shape[1], pf, lo, hi, S_out)
        n_trees = pf.boundaries[hi - 1] - (pf.boundaries[lo - 1] if lo else 0)
        plan = fs.launch_plan(
            xs.shape[0], xs.shape[1], pf.feature.shape[1], pf.leaf_value.shape[1],
            pf.block_t, n_blocks, segmented=name == "forest_score_segments",
        )
        log(
            f"[kernels] {name} {label}: B={xs.shape[0]} F={xs.shape[1]} "
            f"trees={n_trees} ({n_blocks * pf.block_t} padded) N={pf.n_nodes} "
            f"({pf.feature.shape[1]} padded) L={pf.n_leaves} max_abs_err={err:.3g} kernel={k_ms:.4f} ms "
            f"plain={p_ms:.3f} ms bound={b_ms:.5f} ms ({b_by}) "
            f"x{k_ms / b_ms:.1f} bound; grid {plan['tiles']}x{plan['chunks']} "
            f"(tile {plan['tile']} docs, {plan['warps_d']}x{plan['warps_t']} warps "
            f"on docs x trees, chunk {plan['chunk']} blocks, "
            f"{plan['ctas_per_sm']} CTAs/SM)"
        )
        if err != 0.0:
            raise AssertionError(f"{name} {label}: kernel differs from plain by {err}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append({
            "case": label, "B": xs.shape[0], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "grid": plan,
        })

    # An independent oracle on a small input: per-document traversal.
    small = random_ensemble(SEED + 7, 37, 6, 21, device=dev)
    xs = rng.normal(size=(100, 21)).astype(np.float32)
    got = forest_score(small, torch.as_tensor(xs, device=dev)).cpu().numpy()
    oracle_err = float(np.abs(got - score_numpy_oracle(small, xs)).max())
    log(f"[kernels] forest_score vs numpy traversal oracle (37 trees, 100 docs): max_abs_err={oracle_err:.3g}")
    if not oracle_err <= TOL:
        raise AssertionError(f"forest_score vs oracle: {oracle_err}")
    return results


# Launch counts of the hand-written kernels (repro_torch.kernels.build's
# one registry). Each phase zeroes them before the work it counts and reads
# them after; the timing loops of [kernels] are left out.
def reset_launches() -> None:
    from repro_torch.kernels import build

    build.reset_kernel_launches()


def kernel_launches() -> dict[str, int]:
    from repro_torch.kernels import build

    return build.kernel_launches()


def no_launches() -> dict[str, int]:
    return dict.fromkeys(kernel_launches(), 0)


def _batches(n_features: int):
    import numpy as np

    rng = np.random.default_rng(SEED + 100)
    out = []
    for _ in range(N_BATCHES):
        X = rng.normal(size=(Q, D, n_features)).astype(np.float32)
        n_docs = rng.integers(D // 4, D + 1, size=Q)
        mask = np.arange(D)[None, :] < n_docs[:, None]
        out.append((X, mask))
    return out


def _topk_agree(top_a, top_b, scores) -> bool:
    """Same top-k, except positions whose scores tie within TOL."""
    return all(
        a == b or abs(scores[q, a] - scores[q, b]) <= TOL
        for q in range(top_a.shape[0])
        for a, b in zip(top_a[q], top_b[q])
    )


def serve_run(label: str, sentinels, mode: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    cfg, ranker, clfs = _models(DEVICE, sentinels)
    svc = RankingService(
        ranker, clfs[0],
        ServiceConfig(threshold=THRESHOLD, execution_mode=mode),
        extra_classifiers=clfs[1:], device=DEVICE,
    )
    batches = _batches(cfg.n_features)
    ops.reset_launch_counts()
    reset_launches()
    outs, lat = [], []
    for X, mask in batches:
        t0 = time.perf_counter()
        outs.append(svc.rank_batch(X, mask))  # ends in the one host read
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    dispatches = ops.launch_counts()

    # The same service on the CPU (plain PyTorch path), same inputs.
    cfg, ranker_c, clfs_c = _models("cpu", sentinels)
    svc_cpu = RankingService(
        ranker_c, clfs_c[0],
        ServiceConfig(
            threshold=THRESHOLD, execution_mode=mode,
            launch_overhead_trees=svc.launch_overhead_trees,
        ),
        extra_classifiers=clfs_c[1:], device="cpu",
    )
    max_err = 0.0
    for (X, mask), (top, scores) in zip(batches, outs):
        top_c, scores_c = svc_cpu.rank_batch(X, mask)
        if scores.shape != (Q, D) or top.shape != top_c.shape:
            raise AssertionError(f"{label}: shapes {scores.shape} {top.shape}")
        if not np.isfinite(scores).all():
            raise AssertionError(f"{label}: non-finite scores")
        max_err = max(max_err, float(np.abs(scores - scores_c).max()))
        if not _topk_agree(top, top_c, scores_c):
            raise AssertionError(f"{label}: top-k differs from the CPU run")
    if max_err > TOL:
        raise AssertionError(f"{label}: scores differ from the CPU run by {max_err}")
    if svc.stats.batches_staged != svc_cpu.stats.batches_staged:
        raise AssertionError(f"{label}: mode picks differ from the CPU run")

    p50 = statistics.median(lat[1:])
    docs_per_batch = float(np.mean([m.sum() for _, m in batches]))
    st = svc.stats
    log(
        f"[serve] {label}: mode={mode} sentinels={tuple(sentinels)} batches={st.batches} "
        f"(fused {st.batches_fused}, staged {st.batches_staged}) "
        f"p50 latency={p50:.3f} ms (first {lat[0]:.3f} ms) "
        f"docs/s={docs_per_batch / (p50 / 1e3):.0f} continue_rate={st.continue_rate:.4f} "
        f"speedup={st.speedup:.3f}x overflow={st.overflow_docs} "
        f"capacities={dict(st.capacities)} "
        f"kernel_launches={launches} dispatches={dispatches} "
        f"max|score-cpu|={max_err:.3g}"
    )
    return {"launches": launches, "service": svc, "batches": batches, "p50": p50}


def _launched_ranges(sentinels, stats) -> set[tuple[str, int, int, int]]:
    """The ranker's compacted launches of one serve run, as ``(layout,
    seg_lo, seg_hi, B)``: the tail after the last sentinel at the last
    stage's capacity, and, where a batch ran staged, each middle segment
    at its stage's capacity."""
    S = len(sentinels)
    layout = f"S={S}"
    out = set()
    for caps in stats.capacities:
        out.add((layout, S, S + 1, caps[-1]))
        if stats.batches_staged:
            out.update((layout, k + 1, k + 2, caps[k]) for k in range(S - 1))
    return out


def profile_window(label: str, svc, batches) -> None:
    """Where one run's time goes: torch.profiler over a few more batches
    (after the timed and checked ones)."""
    def run():
        for X, mask in batches:
            svc.rank_batch(X, mask)

    profiled(label, run, f"{len(batches)} batches")


def profiled(label: str, fn, what: str, n_top: int = 6) -> None:
    """torch.profiler over one call of ``fn``: the window's wall time, the
    card's busy time in it (the device events' summed time: kernels,
    copies, sets; an operator's own device time repeats its kernels', so
    operators are left out) and the top device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        log(f"[profile] {label}: device time not measured (the profiler saw none)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n_top]
    log(
        f"[profile] {label}: {what}, window {wall_us / 1e3:.3f} ms "
        f"(traced), device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%); top: "
        + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top
        )
    )
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:n_top]
    log(
        f"[profile] {label}: host self time top: "
        + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in host)
    )


def phase_serve() -> tuple[dict[str, int], set, float]:
    runs = (
        ("single-sentinel", (50,), "auto", ("forest_score", "sentinel_features")),
        ("fused-2", SENTINELS_2, "fused",
         ("forest_score", "forest_score_segments", "sentinel_features")),
        ("staged-2", SENTINELS_2, "staged", ("forest_score", "sentinel_features")),
        ("auto-2", SENTINELS_2, "auto", ("forest_score", "sentinel_features")),
    )
    total = no_launches()
    tail_cases = set()
    for label, sentinels, mode, needed in runs:
        r = serve_run(label, sentinels, mode)
        tail_cases |= _launched_ranges(sentinels, r["service"].stats)
        for name in needed:
            if r["launches"][name] == 0:
                raise AssertionError(f"{label}: kernel {name} was never launched")
        profile_window(label, r["service"], r["batches"][1:4])
        for name, n in r["launches"].items():
            total[name] += n
        if label == "single-sentinel":
            single_p50 = r["p50"]
    return total, tail_cases, single_p50


def _tier_rungs():
    from repro_torch.core.strategies import QueryExitConfig
    from repro_torch.serve.degradation import ExitRung

    # benchmarks/bench_serve.py:211-217
    return (
        ExitRung("tight", threshold=0.6),
        ExitRung("tightest", threshold=0.8, query_exit=QueryExitConfig(k=10, margin=2.0)),
    )


def _tier_service(device, launch_overhead_trees="auto"):
    from repro_torch.configs.lear_msn1 import config
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    cfg, ranker, clfs = _models(device, (config().sentinel,))
    svc = RankingService(
        ranker, clfs[0],
        ServiceConfig(threshold=TIER_THRESHOLD, launch_overhead_trees=launch_overhead_trees),
        device=device,
    )
    return cfg, svc


def _cpu_rank(svc_cpu, X, mask):
    """The CPU service's response with the bucket's peaks seeded at Q·D,
    as the tier's warmup seeds them (no cold-start overflow)."""
    Qb, Db = mask.shape
    state = svc_cpu.bucket_state(Qb, Db)
    if state.peaks is None:
        state.peaks = [Qb * Db] * svc_cpu.n_stages
    return svc_cpu.rank_batch(X, mask)


def _drive_tier(label: str, svc, n_features: int, rungs, n_queries: int, seed: int) -> dict:
    """Stand a ServingTier up on ``svc`` (warmup of every bucket × rung),
    have two threads submit ``n_queries`` single queries of 64-256
    candidates, stop it, and fail on a first touch after warmup, an
    overflow, an unresolved future or a forest kernel never launched. The
    launch counts are zeroed just before the traffic and read just after."""
    import threading

    import numpy as np

    from repro_torch.kernels import forest_score as fs
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        BatcherHooks,
        BucketPolicy,
        DegradationPolicy,
        ServingTier,
        TierConfig,
    )

    # On the worker thread: the rung that served each future, and each
    # flush's time from the pop of its bucket to its first response.
    served_at, flush_ms, flush_t0 = {}, [], []

    def on_flush(db, n_reqs):
        flush_t0.append(time.perf_counter())

    def on_result(fut):
        served_at[id(fut)] = svc.rung_level
        if flush_t0:
            flush_ms.append((time.perf_counter() - flush_t0.pop()) * 1e3)

    tier = ServingTier(
        svc, n_features,
        TierConfig(doc_counts=TIER_DOC_COUNTS, degradation=DegradationPolicy(rungs=rungs)),
        policy=BucketPolicy(max_queries=8, max_wait_ms=2.0, min_docs=8),
        hooks=BatcherHooks(on_flush=on_flush, on_result=on_result),
    )
    tier.start()
    rep = tier.warmup_report
    log(
        f"[{label}] warmup: {len(rep.buckets)} buckets x {rep.rungs_warmed} rungs in "
        f"{rep.total_seconds:.3f} s; seconds per bucket: "
        + ", ".join(f"{q}x{d} {t:.3f}" for (q, d), t in rep.seconds_per_bucket.items())
    )

    rng = np.random.default_rng(seed)
    sizes = rng.integers(64, 257, size=n_queries)
    queries = [rng.normal(size=(int(n), n_features)).astype(np.float32) for n in sizes]
    gaps = rng.exponential(TIER_GAP_MS / 1e3, size=n_queries)
    futs = [None] * n_queries

    def submit(idx):
        for i in idx:
            time.sleep(gaps[i])
            futs[i] = tier.submit(queries[i])

    touches = fs.first_touches()
    ops.reset_launch_counts()
    reset_launches()
    threads = [threading.Thread(target=submit, args=(range(k, n_queries, 2),)) for k in (0, 1)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError(f"{label}: a submitting thread did not finish")
    offered = n_queries / (time.perf_counter() - t0)
    results = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    tier.stop()
    launches, dispatches = kernel_launches(), ops.launch_counts()
    new_touches = {k: v - touches[k] for k, v in fs.first_touches().items() if v != touches[k]}
    health, stats = tier.health(), tier.stats()
    if not all(f.done() for f in futs):
        raise AssertionError(f"{label}: a future is unresolved after stop()")
    if new_touches:
        raise AssertionError(f"{label}: first touches after warmup: {new_touches}")
    if stats["service"]["overflow_docs"] != 0:
        raise AssertionError(f"{label}: overflow {stats['service']['overflow_docs']}")
    if launches["forest_score"] == 0:
        raise AssertionError(f"{label}: kernel forest_score was never launched")
    return {
        "queries": queries, "results": results, "rungs": [served_at[id(f)] for f in futs],
        "launches": launches, "dispatches": dispatches, "health": health,
        "batcher": stats["batcher"], "wall": wall, "offered": offered, "flush_ms": flush_ms,
    }


def _tier_line(run: dict) -> str:
    """The tier run's numbers, for its log line."""
    import numpy as np

    b, health, flush_ms = run["batcher"], run["health"], run["flush_ms"]
    flushes = b["flushes_full"] + b["flushes_deadline"] + b["flushes_drain"]
    return (
        f"{b['completed']} queries of 64-256 docs from 2 threads in "
        f"{run['wall']:.3f} s (offered {run['offered']:.0f} queries/s); p50 latency="
        f"{health['p50_ms']:.3f} ms p99={health['p99_ms']:.3f} ms; flushes={flushes} "
        f"(full {b['flushes_full']}, deadline {b['flushes_deadline']}, drain "
        f"{b['flushes_drain']}) mean padded Q="
        f"{(b['completed'] + b['padded_query_slots']) / max(flushes, 1):.3f}; "
        f"flush to first response median={statistics.median(flush_ms):.3f} ms "
        f"p90={float(np.percentile(flush_ms, 90)):.3f} ms; "
        f"served at rungs {dict(sorted(collections.Counter(run['rungs']).items()))} "
        f"(degradation {health['degradation']}); "
        f"first touches after warmup=0 overflow=0 failed={b['failed']}; "
        f"kernel_launches={run['launches']} dispatches={run['dispatches']}"
    )


def phase_tier(card: str) -> dict:
    """The serving tier at full width on the card against the CPU service."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import ServiceStats

    cfg, svc = _tier_service(DEVICE)
    run = _drive_tier("tier", svc, cfg.n_features, _tier_rungs(), TIER_QUERIES, SEED + 200)
    queries, results, rungs = run["queries"], run["results"], run["rungs"]
    launches, dispatches, health, b = (
        run["launches"], run["dispatches"], run["health"], run["batcher"]
    )

    # Each response against the query ranked alone on the CPU, at its rung.
    _, svc_cpu = _tier_service("cpu", svc.launch_overhead_trees)
    svc_cpu.install_rungs(_tier_rungs())
    max_err = 0.0
    for q, (top, scores), rung in zip(queries, results, rungs):
        svc_cpu.set_rung(rung)
        top_c, scores_c = _cpu_rank(svc_cpu, q[None], np.ones((1, len(q)), bool))
        if scores.shape != (len(q),) or not np.isfinite(scores).all():
            raise AssertionError(f"tier: scores {scores.shape} or non-finite")
        max_err = max(max_err, float(np.abs(scores - scores_c[0]).max()))
        if not _topk_agree(top[None], top_c, scores_c):
            raise AssertionError("tier: top-k differs from the CPU service")
    if max_err > TOL:
        raise AssertionError(f"tier: scores differ from the CPU service by {max_err}")
    log(
        f"[tier] {cfg.name} {cfg.n_trees} trees depth {cfg.depth} F {cfg.n_features}, "
        f"sentinel {cfg.sentinel} ({card}): {_tier_line(run)}; "
        f"max|score-cpu|={max_err:.3g}"
    )

    # Rungs 1 and 2 on 8 x 256 batches against the CPU service at the rung.
    # Rung 2 also serves batches in which only some queries converge, so
    # its gated tail runs with 0 < n_valid < B on the card.
    gated, rung_err = 0, 0.0
    mixed = _mixed_batches(cfg.n_features, svc.stage_classifiers[0].forest)
    for level in (1, 2):
        svc.set_rung(level)
        svc_cpu.set_rung(level)
        reset_launches()
        err, n_gated, parts = 0.0, 0, []
        sets = [("random", _batches(cfg.n_features)[:2])]
        if level == 2:
            sets.append(("mixed", mixed))
        for part, batches in sets:
            svc.stats = ServiceStats()
            for X, mask in batches:
                ops.reset_launch_counts()
                top, scores = svc.rank_batch(X, mask)
                n_gated += ops.launch_counts()["gated"]  # the card's, not the CPU's
                top_c, scores_c = _cpu_rank(svc_cpu, X, mask)
                err = max(err, float(np.abs(scores - scores_c).max()))
                if not np.isfinite(scores).all() or not _topk_agree(top, top_c, scores_c):
                    raise AssertionError(f"tier rung {level}: differs from the CPU service")
            st = svc.stats
            if part == "mixed":
                mixed_rate, mixed_survivors = st.query_exit_rate, st.docs_continued
            parts.append(
                f"{part}: query_exit_rate={st.query_exit_rate:.4f} "
                f"continue_rate={st.continue_rate:.4f} survivors={st.docs_continued}"
            )
            if part == "mixed" and not (0.0 < st.query_exit_rate < 1.0 and st.docs_continued > 0):
                raise AssertionError(
                    f"tier rung 2: mixed batches exited {st.query_exit_rate} of the queries "
                    f"with {st.docs_continued} survivors; the gated tail saw no partial count"
                )
        if err > TOL:
            raise AssertionError(f"tier rung {level}: scores differ from the CPU by {err}")
        n_batches = sum(len(batches) for _, batches in sets)
        if n_gated != (n_batches if level == 2 else 0):
            raise AssertionError(f"tier rung {level}: {n_gated} gated dispatches")
        gated += n_gated
        rung_err = max(rung_err, err)
        log(
            f"[tier] rung {level} ({svc.rung_names[level]}): {n_batches} batches of {Q}x{D}, "
            + "; ".join(parts)
            + f"; gated dispatches={n_gated} kernel_launches={kernel_launches()} "
            f"max|score-cpu|={err:.3g}"
        )
    svc.set_rung(0)
    summary = (
        f"tier {b['completed']} queries p50={health['p50_ms']:.3f} ms "
        f"p99={health['p99_ms']:.3f} ms, first touches 0, overflow 0, "
        f"max|score-cpu|={max_err:.3g}; rungs 1-2 max|score-cpu|={rung_err:.3g}, "
        f"rung 2 mixed query_exit_rate={mixed_rate:.4f} survivors={mixed_survivors}"
    )
    return {"launches": launches, "gated": dispatches["gated"] + gated, "summary": summary}


def _within(got, want) -> bool:
    """``got`` agrees with ``want`` within TOL, relative and absolute."""
    import numpy as np

    return bool(np.all(np.abs(got - want) <= TOL + TOL * np.abs(want)))


def _keep_boundary_docs(scores, keep, mask):
    """``[Q, D]`` bool: the valid documents within tolerance of their
    query's keep boundary — those with a valid document on the other side
    of the keep decision closer than ``2·(TOL + TOL·max|score|)``: two
    scores that each move by up to TOL on the card can swap order only then."""
    import numpy as np

    scores = np.asarray(scores, np.float64)
    gap = np.abs(scores[:, :, None] - scores[:, None, :])
    scale = np.maximum(np.abs(scores[:, :, None]), np.abs(scores[:, None, :]))
    across = (keep[:, :, None] != keep[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    return mask & ((gap <= 2 * (TOL + TOL * scale)) & across).any(axis=-1)


def _hybrid_agree(label, X, mask, out, out_c, scorer, scorer_cpu, keep_frac):
    """The hybrid's rule against the CPU service: dense scores within TOL;
    every document but those within TOL of its query's keep boundary (on
    the CPU's dense scores) scored within TOL; the top-k equal except ties
    and those documents. Returns (max dense diff, max score diff off the
    boundary, boundary documents)."""
    import numpy as np
    import torch

    from repro_torch.core.strategies import dense_keep_fraction

    (top, scores), (top_c, scores_c) = out, out_c
    flat = X.reshape(-1, X.shape[-1])
    with torch.no_grad():
        d_cpu = scorer_cpu(torch.as_tensor(flat)).reshape(mask.shape)
        d_card = scorer(torch.as_tensor(flat, device=DEVICE)).reshape(mask.shape).cpu().numpy()
    d_np = d_cpu.numpy()
    if scores.shape != scores_c.shape or top.shape != top_c.shape:
        raise AssertionError(f"{label}: shapes {scores.shape} {top.shape}")
    if not np.isfinite(scores).all() or not np.isfinite(d_card).all():
        raise AssertionError(f"{label}: non-finite scores")
    if not _within(d_card[mask], d_np[mask]):
        raise AssertionError(f"{label}: dense scores differ from the CPU beyond {TOL}")
    keep = dense_keep_fraction(d_cpu, torch.as_tensor(mask), keep_frac).numpy()
    boundary = _keep_boundary_docs(d_np, keep, mask)
    ok = mask & ~boundary
    if not _within(scores[ok], scores_c[ok]):
        raise AssertionError(f"{label}: scores differ from the CPU service beyond {TOL}")
    for q in range(top.shape[0]):
        for a, b in zip(top[q], top_c[q]):
            if a != b and abs(scores_c[q, a] - scores_c[q, b]) > TOL and not (
                boundary[q, a] or boundary[q, b]
            ):
                raise AssertionError(f"{label}: top-k differs from the CPU service")
    return (
        float(np.abs(d_card - d_np)[mask].max()),
        float(np.abs(scores - scores_c)[ok].max()),
        int(boundary.sum()),
    )


def _hybrid_service(device, params, sentinels, mode, threshold, launch_overhead_trees="auto"):
    import functools

    from repro_torch.core.stage import DenseStage
    from repro_torch.core.strategies import dense_keep_fraction
    from repro_torch.models.dense_scorer import dense_params_from_numpy
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    cfg, ranker, clfs = _models(device, sentinels)
    dense = DenseStage(
        dense_params_from_numpy(params, device),
        functools.partial(dense_keep_fraction, keep_frac=HYBRID_KEEP),
    )
    svc = RankingService(
        ranker, clfs[0],
        ServiceConfig(
            threshold=threshold, execution_mode=mode,
            launch_overhead_trees=launch_overhead_trees, dense_stage=dense,
        ),
        extra_classifiers=clfs[1:], device=device,
    )
    return cfg, svc


def _distill_on_card() -> dict:
    """Distil the dense scorer against the lear-msn1 ranker on the card;
    its folded parameters as numpy arrays."""
    import numpy as np
    import torch

    from repro_torch.train.distill import distill_dense_scorer, teacher_scores

    from repro_torch.configs.lear_msn1 import config

    cfg, ranker, _ = _models(DEVICE, (config().sentinel,))
    Qd, Dd = HYBRID_DISTILL_QD
    X = np.random.default_rng(300).normal(size=(Qd, Dd, cfg.n_features)).astype(np.float32)
    mask = np.ones((Qd, Dd), bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = distill_dense_scorer(ranker, X, mask, steps=400, lr=3e-3, seed=7, log_every=50)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    teacher = teacher_scores(ranker, torch.as_tensor(X, device=DEVICE))
    h = out.history
    log(
        f"[hybrid] distillation on the card against {cfg.name} ({cfg.n_trees} trees): "
        f"{Qd}x{Dd} block, 400 steps, lr 3e-3, seed 7 in {seconds:.3f} s; loss "
        f"{h[0]['loss']:.5f} (step 0) -> {h[-1]['loss']:.5f} (step {h[-1]['step']}); "
        f"teacher_rmse={out.teacher_rmse:.5f} (teacher std {float(teacher.std()):.5f}) "
        f"pair_accuracy={out.pair_accuracy:.5f}"
    )
    if not h[-1]["loss"] < h[0]["loss"]:
        raise AssertionError(f"hybrid: distillation loss did not fall: {h}")
    return out.scorer.to_numpy()


def _hybrid_launched(sentinels, mode, stats) -> set[tuple[str, str, int, int, int]]:
    """The ranker's launches of one hybrid run on compacted blocks, as
    ``(kernel, layout, seg_lo, seg_hi, B)``: the head on the dense block
    (segmented when fused with several sentinels), staged middle segments
    at their stage's capacity, the tail at the last one."""
    S = len(sentinels)
    layout = f"S={S}"
    out = set()
    for caps in stats.capacities:
        if mode == "fused" and S > 1:
            out.add(("forest_score_segments", layout, 0, S, caps[0]))
        else:
            out.add(("forest_score", layout, 0, 1, caps[0]))
        if mode == "staged":
            out.update(("forest_score", layout, k + 1, k + 2, caps[1 + k]) for k in range(S - 1))
        out.add(("forest_score", layout, S, S + 1, caps[-1]))
    return out


def hybrid_serve_run(label: str, sentinels, mode: str, params: dict) -> dict:
    """The hybrid service on the card against the CPU service (the rule of
    :func:`_hybrid_agree`) and against the all-trees service on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig
    from repro_torch.utils import device_ms

    cfg, svc = _hybrid_service(DEVICE, params, sentinels, mode, THRESHOLD)
    batches = _batches(cfg.n_features)
    ops.reset_launch_counts()
    reset_launches()
    outs, lat = [], []
    for X, mask in batches:
        t0 = time.perf_counter()
        outs.append(svc.rank_batch(X, mask))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches, dispatches = kernel_launches(), ops.launch_counts()

    _, ranker, clfs = _models(DEVICE, sentinels)
    base = RankingService(
        ranker, clfs[0],
        ServiceConfig(
            threshold=THRESHOLD, execution_mode=mode,
            launch_overhead_trees=svc.launch_overhead_trees,
        ),
        extra_classifiers=clfs[1:], device=DEVICE,
    )
    base_lat = []
    for X, mask in batches:
        t0 = time.perf_counter()
        base.rank_batch(X, mask)
        base_lat.append((time.perf_counter() - t0) * 1e3)

    _, svc_cpu = _hybrid_service("cpu", params, sentinels, mode, THRESHOLD, svc.launch_overhead_trees)
    dense_err, err, n_boundary = 0.0, 0.0, 0
    for (X, mask), out in zip(batches, outs):
        d, e, nb = _hybrid_agree(
            f"hybrid {label}", X, mask, out, svc_cpu.rank_batch(X, mask),
            svc.dense_stage.scorer, svc_cpu.dense_stage.scorer, HYBRID_KEEP,
        )
        dense_err, err, n_boundary = max(dense_err, d), max(err, e), n_boundary + nb
    st, st_c = svc.stats, svc_cpu.stats
    if n_boundary == 0 and (st.trees_traversed, st.overflow_docs, st.capacities) != (
        st_c.trees_traversed, st_c.overflow_docs, st_c.capacities
    ):
        raise AssertionError(f"hybrid {label}: stats differ from the CPU service")

    x = torch.as_tensor(batches[0][0].reshape(Q * D, cfg.n_features), device=DEVICE)
    with torch.no_grad():
        dense_ms = device_ms(lambda: svc.dense_stage.scorer(x), reps=200)
    p50, base_p50 = statistics.median(lat[1:]), statistics.median(base_lat[1:])
    docs_per_batch = float(np.mean([m.sum() for _, m in batches]))
    per_batch = {k: v / N_BATCHES for k, v in launches.items()}
    log(
        f"[hybrid] {label}: mode={mode} sentinels={tuple(sentinels)} keep={HYBRID_KEEP} "
        f"batches={st.batches} p50 latency={p50:.3f} ms (first {lat[0]:.3f} ms) "
        f"docs/s={docs_per_batch / (p50 / 1e3):.0f}; all-trees service, same batches: "
        f"p50 {base_p50:.3f} ms; dense scorer device time={dense_ms:.4f} ms per {Q}x{D} "
        f"batch; per batch: kernel_launches={per_batch} "
        f"dispatches={ {k: v / N_BATCHES for k, v in dispatches.items()} }; "
        f"capacities={dict(st.capacities)}; trees traversed={st.trees_traversed:.0f} "
        f"vs all-trees {base.stats.trees_traversed:.0f} "
        f"(x{st.trees_traversed / base.stats.trees_traversed:.4f}, all-trees overflow "
        f"{base.stats.overflow_docs}); "
        f"continue_rate={st.continue_rate:.4f} overflow={st.overflow_docs}; "
        f"max|dense-cpu|={dense_err:.3g} max|score-cpu| off the boundary={err:.3g} "
        f"boundary documents={n_boundary}"
    )
    return {
        "launches": launches, "service": svc, "batches": batches, "boundary": n_boundary,
        "cases": _hybrid_launched(sentinels, mode, st), "p50": p50, "base_p50": base_p50,
        "dense_ms": dense_ms, "ratio": st.trees_traversed / base.stats.trees_traversed,
    }


def _hybrid_rungs():
    from repro_torch.core.strategies import QueryExitConfig
    from repro_torch.serve.degradation import ExitRung

    # Rung 1 narrows the dense gate; rung 2 adds the [tier] ladder's rung 2.
    return (
        ExitRung("dense-narrow", dense_keep_frac=HYBRID_RUNG_KEEP),
        ExitRung(
            "dense-narrow+tightest", threshold=0.8,
            query_exit=QueryExitConfig(k=10, margin=2.0), dense_keep_frac=HYBRID_RUNG_KEEP,
        ),
    )


def phase_hybrid(card: str, params: dict) -> dict:
    """The hybrid cascade on the card: three serve paths, then the tier."""
    import numpy as np
    import torch

    from repro_torch.configs.lear_msn1 import config
    from repro_torch.kernels import ops

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("hybrid: fp32 matmuls must run in full fp32 (TF32 is on)")
    runs = (
        ("single-sentinel fused", (config().sentinel,), "fused", ("forest_score",)),
        ("fused-2", SENTINELS_2, "fused", ("forest_score", "forest_score_segments")),
        ("staged-2", SENTINELS_2, "staged", ("forest_score",)),
    )
    launches = no_launches()
    cases, lines, boundary = set(), [], 0
    for label, sentinels, mode, needed in runs:
        r = hybrid_serve_run(label, sentinels, mode, params)
        for name in needed:
            if r["launches"][name] == 0:
                raise AssertionError(f"hybrid {label}: kernel {name} was never launched")
        profile_window(f"hybrid {label}", r["service"], r["batches"][1:4])
        for name, n in r["launches"].items():
            launches[name] += n
        cases |= r["cases"]
        boundary += r["boundary"]
        lines.append(
            f"{label} p50 {r['p50']:.3f} ms (all-trees {r['base_p50']:.3f}), "
            f"trees x{r['ratio']:.4f}"
        )

    # The tier on the hybrid service, its ladder narrowing the dense gate.
    keeps = (HYBRID_KEEP, HYBRID_RUNG_KEEP, HYBRID_RUNG_KEEP)
    cfg, svc = _hybrid_service(DEVICE, params, (config().sentinel,), "auto", TIER_THRESHOLD)
    run = _drive_tier(
        "hybrid tier", svc, cfg.n_features, _hybrid_rungs(), HYBRID_TIER_QUERIES, SEED + 500
    )
    for name, n in run["launches"].items():
        launches[name] += n
    _, svc_cpu = _hybrid_service(
        "cpu", params, (cfg.sentinel,), "auto", TIER_THRESHOLD, svc.launch_overhead_trees
    )
    svc_cpu.install_rungs(_hybrid_rungs())
    scorer, scorer_cpu = svc.dense_stage.scorer, svc_cpu.dense_stage.scorer
    err, n_b = 0.0, 0
    for q, (top, scores), rung in zip(run["queries"], run["results"], run["rungs"]):
        svc_cpu.set_rung(rung)
        mask = np.ones((1, len(q)), bool)
        _, e, nb = _hybrid_agree(
            "hybrid tier", q[None], mask, (top[None], scores[None]),
            _cpu_rank(svc_cpu, q[None], mask), scorer, scorer_cpu, keeps[rung],
        )
        err, n_b = max(err, e), n_b + nb
    log(
        f"[hybrid] tier {cfg.name} sentinel {cfg.sentinel} keep {HYBRID_KEEP} ({card}): "
        f"{_tier_line(run)}; max|score-cpu| off the boundary={err:.3g} "
        f"boundary documents={n_b}"
    )
    boundary += n_b

    # One 8 x 256 batch at each rung against the CPU service at the rung.
    rung_parts, gated = [], run["dispatches"]["gated"]
    for level, (X, mask) in enumerate(_batches(cfg.n_features)[:3]):
        svc.set_rung(level)
        svc_cpu.set_rung(level)
        reset_launches()
        ops.reset_launch_counts()
        out = svc.rank_batch(X, mask)
        gated += ops.launch_counts()["gated"]  # the card's, not the CPU's
        _, e, nb = _hybrid_agree(
            f"hybrid tier rung {level}", X, mask, out,
            _cpu_rank(svc_cpu, X, mask), scorer, scorer_cpu, keeps[level],
        )
        boundary += nb
        rung_parts.append(
            f"rung {level} ({svc.rung_names[level]}, keep {keeps[level]}): "
            f"max|score-cpu|={e:.3g} boundary={nb} kernel_launches={kernel_launches()}"
        )
    svc.set_rung(0)
    log(f"[hybrid] tier rungs, one {Q}x{D} batch each: " + "; ".join(rung_parts))
    h = run["health"]
    summary = (
        "hybrid " + "; ".join(lines)
        + f"; tier {run['batcher']['completed']} queries p50={h['p50_ms']:.3f} ms "
        f"p99={h['p99_ms']:.3f} ms, first touches 0 (dense included), overflow 0; "
        f"boundary documents {boundary}"
    )
    return {"launches": launches, "gated": gated, "cases": cases, "summary": summary}


def _query_batches(X, mask):
    """``[n, D, F]`` queries in batches of Q; the last batch is filled up
    with copies of its own first queries (their results are dropped)."""
    out = []
    for q0 in range(0, X.shape[0], Q):
        idx = list(range(q0, min(q0 + Q, X.shape[0])))
        n_real = len(idx)
        idx += idx[: Q - n_real] if n_real < Q else []
        while len(idx) < Q:
            idx.append(idx[0])
        out.append((X[idx], mask[idx], n_real))
    return out


def _tree_arrays(ens, edges):
    """(feature, bin, leaf_value) numpy arrays of a trained ensemble."""
    from torch_parity import tree_bins

    feat = ens.feature.cpu().numpy()
    return feat, tree_bins(feat, ens.threshold.cpu().numpy(), edges), ens.leaf_value.cpu().numpy()


def _cpu_tie_rule(label, Xb, grads, card, cpu, params, n_rounds) -> int:
    """The card's first ``n_rounds`` trees against the CPU's by the tie rule
    of ``tests/torch_parity.py``; the number of leading rounds with equal
    trees."""
    from torch_parity import check_training_tie_rule

    head = tuple(a[:n_rounds] for a in card)
    try:
        return check_training_tie_rule(Xb, grads, head, cpu, params)
    except AssertionError as e:
        raise AssertionError(f"{label}: card against CPU breaks the tie rule: {e}") from None


def _replay_rounds(label, Xb, card, preds_before, grad_fn, params) -> tuple[int, float]:
    """Each of the card's first rounds refit on the CPU from the card's own
    predictions before it (``preds_before[t]``; ``grad_fn`` gives the CPU's
    gradients from them), held to the card's tree by the tie rule. Returns
    the rounds with equal trees and the largest leaf difference among them."""
    import numpy as np
    import torch

    from repro_torch.forest.gbdt import _fit_tree
    from torch_parity import check_tree_tie_rule

    Xb_t = torch.as_tensor(Xb)
    equal, leaf_diff = 0, 0.0
    for t, prev in enumerate(preds_before):
        g, h = grad_fn(torch.as_tensor(prev))
        want = tuple(a.numpy() for a in _fit_tree(Xb_t, g, h, params)[:3])
        got = tuple(a[t] for a in card)
        try:
            same = check_tree_tie_rule(Xb, g.numpy(), h.numpy(), got, want, params)
        except AssertionError as e:
            raise AssertionError(f"{label} round {t}: card against CPU refit: {e}") from None
        if same:
            equal += 1
            leaf_diff = max(leaf_diff, float(np.abs(got[2] - want[2]).max()))
    return equal, leaf_diff


def _train_ranker(tr, params, dev):
    """λ-MART on the card, timed; then the 20-round determinism rerun (timed
    per round) and the first rounds on the CPU, each checked."""
    import numpy as np
    import torch

    from repro_torch.forest import binning
    from repro_torch.forest.gbdt import train_lambdamart
    from repro_torch.forest.lambdamart import lambda_grad_hess

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranker = train_lambdamart(tr.X, tr.labels, tr.mask, params, k=TRAIN_K, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0

    Qn, Dn, F = tr.X.shape
    flat = tr.X.reshape(Qn * Dn, F)
    edges = binning.quantile_bins(flat[tr.mask.reshape(-1)], params.n_bins)
    card = _tree_arrays(ranker, edges)

    # Determinism: a second run of the first rounds is bit-equal.
    stamps, card_preds = [], []

    def on_round(t, preds):
        stamps.append(time.perf_counter())
        card_preds.append(preds)

    short = dataclasses.replace(params, n_trees=TRAIN_DETERMINISM_ROUNDS)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    again = train_lambdamart(
        tr.X, tr.labels, tr.mask, short, k=TRAIN_K, device=dev, callback=on_round,
    )
    rounds_s = np.diff(stamps)
    for a, b, name in zip(_tree_arrays(again, edges), card, ("feature", "bin", "leaf_value")):
        if not np.array_equal(a, b[:TRAIN_DETERMINISM_ROUNDS]):
            raise AssertionError(f"train: a second card run differs in {name}")
    log(
        f"[train] ranker: train_lambdamart {params.n_trees} rounds x "
        f"{tr.X.shape[0] * tr.X.shape[1]} rows on the card in {total:.3f} s (median round "
        f"{np.median(rounds_s) * 1e3:.3f} ms over a {TRAIN_DETERMINISM_ROUNDS}-round rerun, "
        f"first {rounds_s[0] * 1e3:.3f} ms); the rerun is bit-equal"
    )
    profiled(
        "train", lambda: train_lambdamart(
            tr.X, tr.labels, tr.mask, dataclasses.replace(params, n_trees=3), k=TRAIN_K,
            edges=edges, device=dev,
        ), "3 λ-MART rounds (binning on the card and the host read of the trees included)",
        n_top=8,
    )

    # The card against the CPU: the first rounds at full width.
    cpu_preds = []
    t1 = time.perf_counter()
    on_cpu = train_lambdamart(
        tr.X, tr.labels, tr.mask, dataclasses.replace(params, n_trees=TRAIN_CPU_ROUNDS),
        k=TRAIN_K, device="cpu", callback=lambda t, preds: cpu_preds.append(preds),
    )
    cpu_s = time.perf_counter() - t1
    Xb = binning.apply_bins(torch.as_tensor(flat), torch.as_tensor(edges)).numpy()
    lab, mask = torch.as_tensor(tr.labels).float(), torch.as_tensor(tr.mask)
    w = mask.reshape(-1).float()

    def grad_fn(prev):
        g, h = lambda_grad_hess(prev, lab, mask, k=TRAIN_K)
        return g.reshape(-1) * w, h.reshape(-1) * w

    grads, prev = [], torch.zeros(lab.shape)
    for preds in cpu_preds:
        grads.append(tuple(a.numpy() for a in grad_fn(prev)))
        prev = torch.as_tensor(preds)
    equal = _cpu_tie_rule("train ranker", Xb, grads, card, _tree_arrays(on_cpu, edges),
                          params, TRAIN_CPU_ROUNDS)
    # Each card round refit on the CPU from the card's own predictions.
    before = [np.zeros(lab.shape, np.float32), *card_preds[:TRAIN_CPU_ROUNDS - 1]]
    replay = _replay_rounds("train ranker", Xb, card, before, grad_fn, params)
    return ranker, {
        "total_s": total, "round_median_s": float(np.median(rounds_s)),
        "cpu_s": cpu_s, "cpu_equal_rounds": equal,
        "replay": replay,
    }


def _train_classifier(cl, ranker, dev):
    """``train_lear`` on the card (its segments launches counted), then on
    the CPU from the same ranker, held to it by the tie rule."""
    import numpy as np
    import torch

    from repro_torch.core.lear import continue_training_set, train_lear
    from repro_torch.forest import binning
    from repro_torch.forest.gbdt import GBDTParams, grad_hess_logistic, train_gbdt
    from repro_torch.forest.reorder import per_tree_contributions
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = train_lear(cl.X, cl.labels, cl.mask, ranker, sentinel=TRAIN_SENTINEL, k=LEAR_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dispatches = kernel_launches(), ops.launch_counts()
    if launches["forest_score_segments"] == 0:
        raise AssertionError("train: train_lear never launched the segments kernel")

    # The same on the CPU: train_lear is continue_training_set, then
    # train_gbdt; the pieces give the CPU's gradients for the tie rule.
    ranker_cpu = ranker.to("cpu")
    t1 = time.perf_counter()
    X_aug, y, w = continue_training_set(
        cl.X, cl.labels, cl.mask, ranker_cpu, TRAIN_SENTINEL, LEAR_K
    )
    card_set = continue_training_set(cl.X, cl.labels, cl.mask, ranker, TRAIN_SENTINEL, LEAR_K)
    for a, b, name in zip(card_set, (X_aug, y, w), ("features", "labels", "weights")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"train: the classifier's {name} differ between card and CPU")
    params = GBDTParams(n_trees=10, depth=5, learning_rate=0.2, reg_lambda=1.0)
    preds = []
    clf_cpu = train_gbdt(X_aug.numpy(), y.numpy(), params, "logistic", weights=w.numpy(),
                         device="cpu", callback=lambda t, p: preds.append(p))
    cpu_s = time.perf_counter() - t1
    edges = binning.quantile_bins(X_aug.numpy(), params.n_bins)
    Xb = binning.apply_bins(X_aug, torch.as_tensor(edges)).numpy()
    grads, prev = [], torch.zeros_like(y)
    for p in preds:
        grads.append(tuple(a.numpy() for a in grad_hess_logistic(prev, y, w)))
        prev = torch.as_tensor(p)
    card = _tree_arrays(clf.forest, edges)
    equal = _cpu_tie_rule("train classifier", Xb, grads, card,
                          _tree_arrays(clf_cpu, edges), params, params.n_trees)
    # The card's predictions before each round: its trees' leaf values
    # added in order, as training added them.
    contrib = per_tree_contributions(clf.forest, card_set[0]).cpu()
    before = [torch.zeros_like(y)]
    for t in range(params.n_trees - 1):
        before.append(before[-1] + contrib[:, t])
    replay = _replay_rounds("train classifier", Xb, card, before,
                            lambda prev: grad_hess_logistic(prev, y, w), params)
    return clf, {
        "seconds": seconds, "cpu_s": cpu_s, "cpu_equal_rounds": equal, "replay": replay,
        "launches": launches, "dispatches": dispatches, "rows": int(X_aug.shape[0]),
    }


def _serve_trained(ranker, clf, te, full_ndcg):
    """The trained cascade through RankingService on the card at each
    threshold, every response against the CPU service on the same weights."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.metrics.ranking import ndcg_at_k
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    batches = _query_batches(te.X, te.mask)
    labels, mask = torch.as_tensor(te.labels), torch.as_tensor(te.mask)
    out, launches = {}, no_launches()
    ranker_cpu = ranker.to("cpu")
    for th in TRAIN_THRESHOLDS:
        svc = RankingService(ranker, clf, ServiceConfig(threshold=th), device=DEVICE)
        ops.reset_launch_counts()
        reset_launches()
        outs, lat = [], []
        for X, m, _ in batches:
            t0 = time.perf_counter()
            outs.append(svc.rank_batch(X, m))
            lat.append((time.perf_counter() - t0) * 1e3)
        for k, v in kernel_launches().items():
            launches[k] += v
        svc_cpu = RankingService(
            ranker_cpu, clf, ServiceConfig(
                threshold=th, launch_overhead_trees=svc.launch_overhead_trees,
            ), device="cpu",
        )
        max_err, scores_all = 0.0, []
        for (X, m, n_real), (top, scores) in zip(batches, outs):
            top_c, scores_c = svc_cpu.rank_batch(X, m)
            if scores.shape != (Q, D) or not np.isfinite(scores).all():
                raise AssertionError(f"train serve {th}: scores {scores.shape} or non-finite")
            max_err = max(max_err, float(np.abs(scores - scores_c).max()))
            if not _topk_agree(top, top_c, scores_c):
                raise AssertionError(f"train serve {th}: top-k differs from the CPU service")
            scores_all.append(scores[:n_real])
        if max_err > TOL:
            raise AssertionError(f"train serve {th}: scores differ from the CPU by {max_err}")
        st = svc.stats
        lear = float(ndcg_at_k(torch.as_tensor(np.concatenate(scores_all)), labels, mask).mean())
        out[th] = {
            "ndcg": lear, "loss": full_ndcg - lear, "speedup": st.speedup,
            "continue_rate": st.continue_rate, "p50": statistics.median(lat[1:]),
            "max_err": max_err, "overflow": st.overflow_docs,
        }
    if launches["forest_score"] == 0:
        raise AssertionError("train serve: kernel forest_score was never launched")
    return out, launches


def phase_train(card: str, serve_p50: float) -> dict:
    """Train the LEAR pipeline on the card at lear-msn1 width and serve it."""
    import numpy as np
    import torch

    from repro_torch.configs.lear_msn1 import config
    from repro_torch.core.lear import continue_training_set
    from repro_torch.data import make_letor_dataset
    from repro_torch.forest.gbdt import GBDTParams
    from repro_torch.forest.reorder import (
        per_tree_contributions,
        prefix_residual,
        reordered_ensemble,
    )
    from repro_torch.kernels.ops import forest_score, padded_forest
    from repro_torch.metrics import mean_ndcg, precision_recall

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    dev = torch.device(DEVICE)
    cfg = config()
    t_phase = time.perf_counter()
    data = make_letor_dataset(**TRAIN_DATA)
    parts = data.splits()
    tr, cl, tune, te = (parts[k] for k in ("train", "classifier", "tune", "test"))
    log(
        f"[train] data: make_letor_dataset{tuple(TRAIN_DATA.items())} in "
        f"{time.perf_counter() - t_phase:.3f} s: F={data.X.shape[-1]}, D={data.X.shape[1]}, "
        f"mean real docs/query {data.mask.sum(1).mean():.2f}, splits "
        + "/".join(str(p.n_queries) for p in parts.values())
    )
    if TRAIN_ROUNDS < cfg.n_trees:
        log(f"[train] reduced: {TRAIN_ROUNDS} boosting rounds of {cfg.n_trees} "
            "(widths unchanged: 136 features, depth 6, 256 bins, D = 256)")
    params = GBDTParams(n_trees=TRAIN_ROUNDS, depth=cfg.depth, learning_rate=0.1, n_bins=256)
    ranker, r = _train_ranker(tr, params, dev)
    log(
        f"[train] ranker against the CPU: {TRAIN_CPU_ROUNDS} rounds on the CPU in "
        f"{r['cpu_s']:.3f} s: equal trees in {r['cpu_equal_rounds']} of {TRAIN_CPU_ROUNDS} "
        f"rounds, the tie rule held; each of the card's first {TRAIN_CPU_ROUNDS} rounds "
        f"refit on the CPU from the card's predictions: equal trees in {r['replay'][0]} of "
        f"{TRAIN_CPU_ROUNDS} (max leaf diff {r['replay'][1]:.3g}), the tie rule held in all "
        f"({card})"
    )

    # Quality sanity: the trained ranker against random scores on the test split.
    Qt, Dt, F = te.X.shape
    x_te = torch.as_tensor(te.X.reshape(Qt * Dt, F), device=dev)
    labels, mask = torch.as_tensor(te.labels), torch.as_tensor(te.mask)
    full_scores = forest_score(ranker, x_te).reshape(Qt, Dt).cpu()
    full_ndcg = float(mean_ndcg(full_scores, labels, mask))
    rand = torch.as_tensor(np.random.default_rng(SEED).normal(size=(Qt, Dt)).astype(np.float32))
    rand_ndcg = float(mean_ndcg(rand, labels, mask))
    log(f"[train] ranker NDCG@10 on the test split {full_ndcg:.5f} (random scores {rand_ndcg:.5f})")
    if not full_ndcg > rand_ndcg + 0.15:
        raise AssertionError(f"train: NDCG@10 {full_ndcg} is not above random {rand_ndcg} + 0.15")

    clf, c = _train_classifier(cl, ranker, dev)
    log(
        f"[train] classifier: train_lear(sentinel={TRAIN_SENTINEL}, k={LEAR_K}) on "
        f"{c['rows']} rows in {c['seconds']:.3f} s on the card, kernel_launches="
        f"{c['launches']} dispatches={c['dispatches']}; on the CPU from the same ranker "
        f"in {c['cpu_s']:.3f} s: features, labels and weights bit-equal, equal trees in "
        f"{c['cpu_equal_rounds']} of 10 rounds, the tie rule held; each card round refit on "
        f"the CPU from the card's predictions: equal trees in {c['replay'][0]} of 10 (max "
        f"leaf diff {c['replay'][1]:.3g}), the tie rule held in all"
    )

    # Reordering on the tune split.
    x_tune = torch.as_tensor(tune.X[tune.mask], device=dev)
    t0 = time.perf_counter()
    reordered, order = reordered_ensemble(ranker, x_tune, "greedy", max_docs=4096)
    reorder_s = time.perf_counter() - t0
    stride = -(-x_tune.shape[0] // 4096)
    contrib = per_tree_contributions(ranker, x_tune[::stride]).cpu().numpy()
    greedy = prefix_residual(contrib, order)[TRAIN_SENTINEL - 1]
    ident = prefix_residual(contrib, np.arange(ranker.n_trees))[TRAIN_SENTINEL - 1]
    diff = float((forest_score(reordered, x_te) - forest_score(ranker, x_te)).abs().max())
    log(
        f"[train] reorder: greedy order from {contrib.shape[0]} tune documents in "
        f"{reorder_s:.3f} s; prefix residual at tree {TRAIN_SENTINEL}: greedy {greedy:.6g}, "
        f"identity {ident:.6g}; reordered scores within {diff:.3g} of the original"
    )
    if diff > 1e-4:
        raise AssertionError(f"train: the reordered ensemble's scores moved by {diff}")

    # Classifier precision/recall on the test split, then the served cascade.
    X_aug, cont, _ = continue_training_set(te.X, te.labels, te.mask, ranker, TRAIN_SENTINEL, LEAR_K)
    prob = torch.sigmoid(forest_score(clf.forest, X_aug))
    flat_mask = mask.reshape(-1).to(dev)
    served, launches = _serve_trained(ranker, clf, te, full_ndcg)
    lines = []
    for th, s in served.items():
        pr = precision_recall(prob >= th, cont.bool(), flat_mask)
        lines.append(
            f"threshold {th}: NDCG@10 {s['ndcg']:.5f} (loss {s['loss']:.5f} against all "
            f"trees), speedup {s['speedup']:.3f}x, continue_rate {s['continue_rate']:.4f}, "
            "Continue P/R {continue_precision:.4f}/{continue_recall:.4f}, "
            "Exit P/R {exit_precision:.4f}/{exit_recall:.4f}".format(**pr)
            + f", batch p50 {s['p50']:.3f} ms, max|score-cpu| {s['max_err']:.3g}, "
            f"overflow {s['overflow']}"
        )
        log(f"[train] served, {lines[-1]}")
    for k, v in c["launches"].items():
        launches[k] += v
    log(
        f"[train] batch p50 with trained weights at threshold 0.5: {served[0.5]['p50']:.3f} ms; "
        f"[serve] single-sentinel on random weights: {serve_p50:.3f} ms; kernel launches of "
        f"the phase (train_lear and serving) {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s"
    )
    pf = padded_forest(ranker, boundaries=(TRAIN_SENTINEL, ranker.n_trees))
    x_cl = torch.as_tensor(cl.X.reshape(-1, F), device=dev)
    summary = (
        f"train {TRAIN_ROUNDS} rounds {r['total_s']:.1f} s, NDCG@10 {full_ndcg:.4f}; "
        + "; ".join(
            f"th {th} NDCG {s['ndcg']:.4f} x{s['speedup']:.2f} cont {s['continue_rate']:.3f}"
            for th, s in served.items()
        )
    )
    return {
        "launches": launches, "summary": summary,
        "cases": [(f"train_lear head S=2 ({TRAIN_SENTINEL}, {ranker.n_trees})", pf, x_cl)],
    }


def _leaf_paths(feature, threshold, depth: int) -> list[list[tuple[int, float, bool]]]:
    """Each leaf of one complete heap-ordered tree, left to right, as its
    path of ``(feature, threshold, goes_left)``; left is ``x <= threshold``."""
    paths = []
    for leaf in range(1 << depth):
        n, path = 0, []
        for d in range(depth):
            bit = (leaf >> (depth - 1 - d)) & 1
            path.append((int(feature[n]), float(threshold[n]), bit == 0))
            n = 2 * n + 1 + bit
        paths.append(path)
    return paths


def _hot_documents(forest, n_features: int, rng, n: int):
    """``n`` documents that the LEAR classifier ``forest`` scores high.

    Rung 2's threshold of 0.8 lets no normal random document through the
    seeded classifier, so every query would exit at once and the gated tail
    would only ever see a count of 0. Per tree, greedily, this takes the
    highest leaf whose path agrees with the bounds already taken (the four
    sentinel features assumed at a middle rank of 256 candidates), and
    draws documents inside the bounds.
    """
    import numpy as np

    feature = forest.feature.cpu().numpy()
    threshold = forest.threshold.cpu().numpy()
    leaves = forest.leaf_value.cpu().numpy()
    depth = int(np.log2(feature.shape[1] + 1))
    aug_guess = (0.0, 100.0, 0.5, 256.0)  # partial, rank, normalized partial, candidates
    lo = np.full(n_features, -np.inf)
    hi = np.full(n_features, np.inf)

    def agrees(path) -> bool:
        for f, t, left in path:
            if f >= n_features:
                if (aug_guess[f - n_features] <= t) != left:
                    return False
            elif (left and lo[f] >= t) or (not left and hi[f] <= t):
                return False
        return True

    for tree in np.argsort(-leaves.max(axis=1)):
        paths = _leaf_paths(feature[tree], threshold[tree], depth)
        for leaf in np.argsort(-leaves[tree]):
            if agrees(paths[leaf]):
                for f, t, left in paths[leaf]:
                    if f < n_features:
                        if left:
                            hi[f] = min(hi[f], t)
                        else:
                            lo[f] = max(lo[f], t)
                break
    x = rng.normal(size=(n, n_features))
    both = np.isfinite(lo) & np.isfinite(hi)
    x[:, both] = (lo[both] + hi[both]) / 2
    x = np.where(np.isfinite(lo) & ~both, np.maximum(x, lo + 0.5), x)
    x = np.where(np.isfinite(hi) & ~both, np.minimum(x, hi - 0.5), x)
    return x.astype(np.float32)


def _mixed_batches(n_features: int, clf_forest, n_hot: int = 20):
    """Two 8 x 256 batches whose first half of queries each carry ``n_hot``
    documents that pass rung 2's threshold (more than its query-exit k of
    10, so those queries do not converge) and whose second half carry none
    (those exit)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 400)
    out = []
    for X, mask in _batches(n_features)[2:4]:
        X = X.copy()
        for q in range(Q // 2):
            X[q, :n_hot] = _hot_documents(clf_forest, n_features, rng, n_hot)
        out.append((X, mask))
    return out


def phase_gated() -> dict:
    """The gated tail against its plain version, and timed at counts 0, B."""
    import numpy as np
    import torch

    from repro_torch.configs.lear_msn1 import config
    from repro_torch.kernels import forest_score as fs
    from repro_torch.kernels.ops import padded_forest
    from repro_torch.utils import device_ms

    dev = torch.device(DEVICE)
    cfg, ranker, _ = _models(dev, (config().sentinel,))
    pf = padded_forest(ranker, boundaries=(cfg.sentinel, cfg.n_trees))
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    kw = dict(block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[1],
              n_tree_blocks=pf.seg_blocks[1])
    rng = np.random.default_rng(SEED + 300)
    out = {"max_abs_err": 0.0, "cases": []}
    for B in GATED_BS:
        x = torch.as_tensor(rng.normal(size=(B, cfg.n_features)).astype(np.float32), device=dev)
        for count in (0, 1, 33, B // 2, B):
            n = torch.tensor(count, dtype=torch.int32, device=dev)
            kernel = lambda x=x, n=n: fs.forest_score_kernel(
                x, *tables, packed=pf.packed, leaf_gather=pf.leaf_gather, n_valid=n, **kw
            )
            plain = lambda x=x, n=n: fs.forest_score_plain(x, *tables, n_valid=n, **kw)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or got[count:].any():
                raise AssertionError(f"gated tail B={B} n_valid={count}: differs by {err}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if count not in (0, B):
                continue
            k_ms = device_ms(kernel, reps=200)
            p_ms = device_ms(plain, reps=5, warmup=1)
            b_ms, b_by = _bound(B, cfg.n_features, pf, 1, 2, n_valid=count)
            log(
                f"[kernels] forest_score gated tail B={B} n_valid={count}: "
                f"trees={cfg.n_trees - cfg.sentinel} max_abs_err={err:.3g} "
                f"kernel={k_ms:.4f} ms plain={p_ms:.3f} ms bound={b_ms:.3g} ms ({b_by})"
            )
            out["cases"].append({
                "case": f"gated tail B={B} n_valid={count}", "B": B, "n_valid": count,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            })
    log(f"[kernels] gated tail equals its plain version at B in {GATED_BS}, "
        f"n_valid in (0, 1, 33, B/2, B): max_abs_err={out['max_abs_err']:.3g}")
    return out


# The bulk cells' sentinel stage: (queries, slots, features, mean real a
# query) of lear_bench's msn1 and istella traffic.
SENTINEL_SHAPES = ((4096, 256, 136, 120), (4096, 512, 220, 317))


def phase_sentinel() -> dict:
    """The sentinel-features kernel against its plain version at the bulk
    cells' shapes (bit for bit), timed beside it and its bytes bound."""
    import numpy as np
    import torch

    from repro_torch.core import features
    from repro_torch.kernels import sentinel_features as sf
    from repro_torch.utils import device_ms

    dev = torch.device(DEVICE)
    out = {"cases": []}
    for Q, D, F, real in SENTINEL_SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + D)
        X = torch.randn(Q, D, F, generator=gen, device=dev)
        partial = torch.round(torch.randn(Q, D, generator=gen, device=dev) * 64) / 64
        n_real = torch.as_tensor(
            np.clip(np.random.default_rng(SEED + D).poisson(real, size=(Q, 1)), 8, D), device=dev
        )
        mask = torch.arange(D, device=dev)[None, :] < n_real
        kernel = lambda X=X, partial=partial, mask=mask: sf.sentinel_features_kernel(
            X, partial, mask)
        plain = lambda X=X, partial=partial, mask=mask: features.augment_features_plain(
            X, partial, mask)
        before = kernel_launches()["sentinel_features"]
        got = kernel()
        launches = kernel_launches()["sentinel_features"] - before
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"sentinel_features {Q}x{D} F={F}: differs from plain")
        del got, want
        k_ms = device_ms(kernel, reps=50)
        p_ms = device_ms(plain, reps=3, warmup=1)
        nbytes = Q * D * (2 * F + 4) * 4 + Q * D * 5    # X, X_aug; partial, mask
        b_ms = nbytes / _rf().HBM_BW * 1e3
        label = f"Q={Q} D={D} F={F} (Poisson({real}) real)"
        log(f"[kernels] sentinel_features {label}: bit-equal to plain; kernel={k_ms:.4f} ms "
            f"plain={p_ms:.3f} ms bound={b_ms:.4f} ms (bytes {nbytes}) x{k_ms / b_ms:.2f} "
            f"bound; {launches} launch a call")
        out["cases"].append({"case": label, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": "bytes"})
    return out


# ---------------------------------------------------------------------------
# [guards]: one host read per batch, under the card's sync debug mode.
# ---------------------------------------------------------------------------

GUARD_WARM = 2           # batches served before the guard (plans, scratch, capacities)
GUARD_BATCHES = 3        # batches served under the guard
GUARD_TIER_QUERIES = 50
GUARD_QUERY_EXIT = (0.8, 10, 2.0)  # threshold, k, margin: the [tier] ladder's rung 2


def _guard_configs():
    """(label, sentinels, mode, dense keep fraction, query exit) of each
    [guards] configuration."""
    return (
        ("single sentinel", (50,), "auto", None, False),
        ("(50, 150) fused", SENTINELS_2, "fused", None, False),
        ("(50, 150) staged", SENTINELS_2, "staged", None, False),
        ("(50, 150) auto", SENTINELS_2, "auto", None, False),
        ("hybrid (50, 150) fused", SENTINELS_2, "fused", HYBRID_KEEP, False),
        ("query exit", (50,), "fused", None, True),
    )


def _guard_service(models, mode, keep, query_exit):
    """A service over ``models`` (the [serve] ranker and classifiers),
    with a random dense gate at ``keep`` (seed 0) or query exit."""
    import functools

    import torch

    from repro_torch.core.stage import DenseStage
    from repro_torch.core.strategies import QueryExitConfig, dense_keep_fraction
    from repro_torch.models.dense_scorer import init_dense_scorer
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    cfg, ranker, clfs = models
    dense = None
    if keep is not None:
        scorer = init_dense_scorer(torch.Generator().manual_seed(SEED), cfg.n_features,
                                   device="cpu")
        dense = DenseStage(scorer, functools.partial(dense_keep_fraction, keep_frac=keep))
    th, k, margin = GUARD_QUERY_EXIT
    return RankingService(
        ranker, clfs[0],
        ServiceConfig(
            threshold=th if query_exit else THRESHOLD, execution_mode=mode,
            query_exit=QueryExitConfig(k=k, margin=margin) if query_exit else None,
            dense_stage=dense,
        ),
        extra_classifiers=clfs[1:], device=DEVICE,
    )


def _guard_run(label: str, sentinels, mode: str, keep, query_exit) -> dict:
    """Two identical services warm on the same batches; then one serves
    GUARD_BATCHES unguarded and the other the same batches under
    count_host_transfers (sync debug mode on). Each must read the card once
    per batch, explicitly, with no implicit sync, give bit-equal responses
    and launch the same forest kernels."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.utils import count_host_transfers

    models = _models(DEVICE, sentinels)
    plain, guarded = (_guard_service(models, mode, keep, query_exit) for _ in range(2))
    batches = _batches(models[0].n_features)[: GUARD_WARM + GUARD_BATCHES]
    for X, mask in batches[:GUARD_WARM]:
        plain.rank_batch(X, mask)
        guarded.rank_batch(X, mask)
    torch.cuda.synchronize()
    reset_launches()
    want = [plain.rank_batch(X, mask) for X, mask in batches[GUARD_WARM:]]
    torch.cuda.synchronize()
    unguarded_launches = kernel_launches()
    reset_launches()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with count_host_transfers() as counts:
        got = [guarded.rank_batch(X, mask) for X, mask in batches[GUARD_WARM:]]
    ms = (time.perf_counter() - t0) * 1e3 / GUARD_BATCHES
    launches = kernel_launches()
    gated = ops.launch_counts()["gated"]
    equal = all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, want)
    )
    st = guarded.stats
    log(
        f"[guards] {label}: {GUARD_BATCHES} batches of {Q} x {D} after {GUARD_WARM} warm: "
        f"explicit_gets={counts.explicit_gets} implicit_syncs={counts.implicit_syncs} "
        f"sync-debug warnings {counts.sync_warnings} (inside device_get "
        f"{counts.sync_warnings - counts.implicit_syncs}); forest launches guarded "
        f"{launches} vs unguarded {unguarded_launches}; bit-equal to unguarded: {equal}; "
        f"{ms:.3f} ms a batch under the guard; modes fused {st.batches_fused} / staged "
        f"{st.batches_staged}; queries exited {st.queries_exited}"
        + (f"; implicit sites {sorted(set(counts.sites))}" if counts.sites else "")
    )
    if counts.explicit_gets != GUARD_BATCHES or counts.implicit_syncs or counts.sites:
        raise AssertionError(f"[guards] {label}: host reads {counts}")
    if not equal:
        raise AssertionError(f"[guards] {label}: guarded responses differ from unguarded")
    if launches != unguarded_launches or not sum(launches.values()):
        raise AssertionError(f"[guards] {label}: launches {launches} vs {unguarded_launches}")
    return {"launches": launches, "gated": gated}


def _guard_tier() -> dict:
    """ServingTier on the [tier] service (sentinel 50, threshold 0.4), one
    doc count of 256, warmed; then GUARD_TIER_QUERIES queries submitted
    from one thread under the guard: one explicit read per flushed batch,
    no implicit sync on any thread."""
    import numpy as np
    import torch

    from repro_torch.serve import BucketPolicy, ServingTier, TierConfig
    from repro_torch.utils import count_host_transfers

    cfg, svc = _tier_service(DEVICE)
    tier = ServingTier(
        svc, cfg.n_features, TierConfig(doc_counts=(D,)),
        policy=BucketPolicy(max_queries=Q, max_wait_ms=2.0, min_docs=8),
    ).start()
    rng = np.random.default_rng(SEED + 700)
    queries = [
        rng.normal(size=(int(rng.integers(D // 4, D + 1)), cfg.n_features)).astype(np.float32)
        for _ in range(GUARD_TIER_QUERIES)
    ]
    torch.cuda.synchronize()
    before = svc.stats.batches
    reset_launches()
    try:
        with count_host_transfers() as counts:
            futures = []
            for q in queries:
                futures.append(tier.submit(q))
                time.sleep(0.0005)
            results = [f.result(timeout=120) for f in futures]
    finally:
        tier.stop()
    launches = kernel_launches()
    flushed = svc.stats.batches - before
    finite = all(np.isfinite(s[: len(q)]).all() for (_, s), q in zip(results, queries))
    log(
        f"[guards] tier: {GUARD_TIER_QUERIES} queries of {D // 4}-{D} documents in {flushed} "
        f"flushed batches: explicit_gets={counts.explicit_gets} "
        f"implicit_syncs={counts.implicit_syncs} sync-debug warnings {counts.sync_warnings}; "
        f"forest launches {launches}; finite {finite}"
        + (f"; implicit sites {sorted(set(counts.sites))}" if counts.sites else "")
    )
    if counts.explicit_gets != flushed or counts.implicit_syncs or not finite or not flushed:
        raise AssertionError(f"[guards] tier: {flushed} batches, host reads {counts}")
    return {"launches": launches, "flushed": flushed}


def _guard_controls() -> None:
    """The guard is not vacuous on the card: ops that sync count as
    implicit. Also prints which waits the sync debug mode does not flag."""
    import torch

    from repro_torch.utils import count_host_transfers

    x = torch.randn(4096, device=DEVICE)
    m = x > 0
    controls = {
        ".item()": (lambda: x.sum().item(), True),
        "boolean-mask index": (lambda: x[m], True),
        "torch.nonzero": (lambda: torch.nonzero(m), True),
        "torch.cuda.synchronize()": (torch.cuda.synchronize, False),
        "Event.synchronize()": (lambda: torch.cuda.Event().synchronize(), False),
    }
    seen = []
    for name, (fn, must) in controls.items():
        fn()
        torch.cuda.synchronize()
        with count_host_transfers() as counts:
            fn()
        seen.append(f"{name} {counts.implicit_syncs}")
        if must and counts.implicit_syncs < 1:
            raise AssertionError(f"[guards] control {name}: not counted ({counts})")
    log(f"[guards] controls (implicit syncs counted): {'; '.join(seen)} "
        f"(the last two wait without a sync-debug flag: the guard's blind spots)")


def phase_guards(card: str) -> dict:
    """[guards] at lear-msn1 full width (the [serve] models, seed 0)."""
    t_phase = time.perf_counter()
    _guard_controls()
    launches = no_launches()
    gated = 0
    for label, sentinels, mode, keep, qe in _guard_configs():
        r = _guard_run(label, sentinels, mode, keep, qe)
        for name, n in r["launches"].items():
            launches[name] += n
        gated += r["gated"]
    tier = _guard_tier()
    for name, n in tier["launches"].items():
        launches[name] += n
    summary = (f"guards: {len(_guard_configs())} configurations and a tier of "
               f"{GUARD_TIER_QUERIES} queries ({tier['flushed']} batches), one explicit read "
               f"a batch, 0 implicit syncs")
    log(f"[guards] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"launches": launches, "gated": gated, "summary": summary}


# ---------------------------------------------------------------------------
# [shapes]: the shape-checked lane around both kernel wrappers on the card.
# ---------------------------------------------------------------------------


def phase_shapes(card: str) -> None:
    """shape_checked(forest_score_kernel / _segments_kernel) on the
    lear-msn1 (50, 150) layout at B = Q·D: the declared shapes pass and the
    output equals the unwrapped call's bit for bit; a wrong dtype, a wrong
    rank and a node axis that disagrees across arguments raise TypeError."""
    import numpy as np
    import torch

    from repro_torch.kernels import forest_score as fs
    from repro_torch.kernels.ops import padded_forest
    from repro_torch.typecheck import shape_checked

    cfg, ranker, _ = _models(DEVICE, SENTINELS_2)
    pf = padded_forest(ranker, boundaries=(*SENTINELS_2, ranker.n_trees))
    x = torch.as_tensor(
        np.random.default_rng(SEED + 800).normal(size=(Q * D, cfg.n_features)).astype(np.float32),
        device=DEVICE,
    )
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    plain, seg = shape_checked(fs.forest_score_kernel), shape_checked(fs.forest_score_segments_kernel)
    kw = dict(block_t=pf.block_t, packed=pf.packed, leaf_gather=pf.leaf_gather)
    skw = dict(seg_block_starts=pf.seg_block_starts[:2],
               n_tree_blocks=pf.seg_block_starts[1] + pf.seg_blocks[1], **kw)
    same = (torch.equal(plain(x, *tables, **kw), fs.forest_score_kernel(x, *tables, **kw))
            and torch.equal(seg(x, *tables, **skw), fs.forest_score_segments_kernel(x, *tables, **skw)))
    bad = {
        "dtype": (lambda: plain(x, pf.feature.float(), *tables[1:], **kw), "feature"),
        "rank": (lambda: plain(x[0], *tables, **kw), "`x`"),
        "dim across arguments": (
            lambda: seg(x, pf.feature, pf.threshold[:, :8].contiguous(), *tables[2:], **skw),
            "threshold",
        ),
    }
    rejected = []
    for name, (fn, arg) in bad.items():
        try:
            fn()
        except TypeError as e:
            if arg in str(e):
                rejected.append(name)
    log(f"[shapes] both wrappers shape-checked on {x.device} at B={Q * D}, F={cfg.n_features}, "
        f"T={pf.feature.shape[0]}: bit-equal to the unwrapped calls {same}; rejected "
        f"{rejected} of {list(bad)} ({card})")
    if not same or len(rejected) != len(bad):
        raise AssertionError("[shapes] the checked lane failed")


# ---------------------------------------------------------------------------
# [retrieval]: TwoStageCascade on DLRM-RM2 at full width.
# ---------------------------------------------------------------------------

RETRIEVAL_KEEPS = (0.01, 0.05, 0.2)
RETRIEVAL_TOP = 100           # recall of the full scoring's top 100
RETRIEVAL_CPU_CANDS = 65_536  # candidates of the compact copy held to the CPU


def _retrieval_pair(cfg, params, dense, sparse):
    """(sentinel_fn, full_fn) of examples/cascade_retrieval.py: the cheap
    score is the candidate's embedding · the user's bottom-MLP vector, the
    full score DLRM's whole interaction."""
    import torch

    from repro_torch.models import recsys

    table = params[f"tables/t{len(cfg.vocab_sizes) - 1}"]
    bot = recsys._mlp(dense, params, "bot", torch.relu)[0]

    def sentinel_fn(ids):
        return recsys._take(table, ids) @ bot

    def full_fn(ids):
        return recsys.dlrm_score_candidates(
            cfg, params, {"dense": dense, "sparse": sparse, "cand_ids": ids}
        )

    return sentinel_fn, full_fn


def _retrieval(cfg, params, raw) -> dict:
    """TwoStageCascade over retrieval_cand's candidate ids at each keep:
    cascade vs full scoring time (CUDA events), recall of the full top 100,
    peak memory; survivors must be the stable top-k of the cheap scores and
    their full scores within TOL of the full scoring at the same positions.
    Then a compact copy on the CPU port: cheap and full scores within TOL,
    the same survivors but for ties within TOL at the keep boundary."""
    import numpy as np
    import torch

    from repro_torch.serve.ranking_service import TwoStageCascade

    dev = torch.device(DEVICE)
    dense = torch.as_tensor(raw["dense"], device=dev)
    sparse = torch.as_tensor(raw["sparse"], device=dev)
    ids = torch.as_tensor(raw["cand_ids"], device=dev)
    C = ids.shape[0]
    sentinel_fn, full_fn = _retrieval_pair(cfg, params, dense, sparse)
    with torch.no_grad():
        full_fn(ids)  # warm
        full_ms, full_all = _events_ms(lambda: full_fn(ids), CELL_TIMED_STEPS)
        cheap_all = sentinel_fn(ids)
        true_top = torch.sort(full_all, descending=True, stable=True).indices[:RETRIEVAL_TOP]
        order = np.argsort(-cheap_all.cpu().numpy(), kind="stable")
        # The candidate ids repeat (they index the last table's rows), so
        # the top 100 positions may be copies of few items: count items too.
        n_items = int(torch.unique(ids).numel())
        top_items = torch.unique(ids[true_top])
        out = {}
        for keep in RETRIEVAL_KEEPS:
            cascade = TwoStageCascade(sentinel_fn, full_fn, keep)
            k = cascade.keep(C)
            cascade.score(ids)  # warm
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms, (surv, full, cheap) = _events_ms(lambda: cascade.score(ids), CELL_TIMED_STEPS)
            peak = torch.cuda.max_memory_allocated() - base
            pos = torch.as_tensor(order[:k], device=dev)
            stable = bool(torch.equal(surv, ids[pos])) and bool(torch.equal(cheap, cheap_all))
            err = float(((full - full_all[pos]).abs() / full_all[pos].abs().clamp_min(1.0)).max())
            recall = float(torch.isin(true_top, pos).float().mean())
            item_recall = float(torch.isin(top_items, surv).float().mean())
            log(f"[retrieval] dlrm-rm2 keep={keep:.0%}: {k:,} of {C:,} candidates survive; "
                f"cascade {ms:.3f} ms vs full scoring {full_ms:.3f} ms "
                f"(x{full_ms / ms:.2f}); recall of the full top {RETRIEVAL_TOP}: {recall:.2f} "
                f"(they are copies of {len(top_items)} of the {n_items} distinct items; "
                f"items recalled {item_recall:.2f}); "
                f"peak memory above the tables {_gib(peak)}; survivors the stable top-k of the "
                f"cheap scores: {stable}; max rel|full(survivors) - full scoring| = {err:.3g}")
            if not stable or not err <= TOL:
                raise AssertionError(f"[retrieval] keep={keep}: stable {stable}, err {err}")
            out[keep] = {"ms": ms, "full_ms": full_ms, "recall": recall, "peak": peak}
    out["cpu"] = _retrieval_cpu(cfg, params, raw)
    return out


def _retrieval_cpu(cfg, params, raw) -> dict:
    """The cascade over the first RETRIEVAL_CPU_CANDS candidates on the
    card and on the CPU port, the CPU on a compact copy of the rows they
    touch (``_compact_dlrm``). Cheap and full scores within TOL; survivor
    sets equal but for candidates whose cheap score lies within
    2·(TOL + TOL·|t|) of the keep boundary t (the boundary rule of
    tests/torch_parity.py, on a sorted axis)."""
    import numpy as np
    import torch

    from repro_torch.serve.ranking_service import TwoStageCascade

    dev = torch.device(DEVICE)
    c = raw["cand_ids"][:RETRIEVAL_CPU_CANDS]
    cp, cs, cc, touched = _compact_dlrm(cfg, params, raw["sparse"], c)
    card = _retrieval_pair(cfg, params, torch.as_tensor(raw["dense"], device=dev),
                           torch.as_tensor(raw["sparse"], device=dev))
    cpu = _retrieval_pair(cfg, cp, torch.as_tensor(raw["dense"]), torch.as_tensor(cs))
    worst, n_boundary = 0.0, 0
    with torch.no_grad():
        for keep in RETRIEVAL_KEEPS:
            s_g, f_g, ch_g = TwoStageCascade(*card, keep).score(torch.as_tensor(c, device=dev))
            s_c, f_c, ch_c = TwoStageCascade(*cpu, keep).score(torch.as_tensor(cc))
            ch_g, s_g, f_g = ch_g.cpu().numpy(), s_g.cpu().numpy(), f_g.cpu().numpy()
            ch_c, f_c = ch_c.numpy(), f_c.numpy()
            u = touched.get(f"tables/t{len(cfg.vocab_sizes) - 1}")
            s_c = u[s_c.numpy()] if u is not None else s_c.numpy()
            k = len(s_g)
            t = np.sort(ch_g)[::-1][k - 1]
            near = np.abs(ch_g - t) <= 2 * (TOL + TOL * abs(t))
            differ = set(np.flatnonzero(np.isin(c, np.setxor1d(s_g, s_c))))
            outside = [i for i in differ if not near[i]]
            common = np.intersect1d(s_g, s_c)
            fg = dict(zip(s_g, f_g))
            fc = dict(zip(s_c, f_c))
            f_err = max((abs(fg[i] - fc[i]) / max(1.0, abs(fc[i])) for i in common), default=0.0)
            c_err = float((np.abs(ch_g - ch_c) / np.maximum(1.0, np.abs(ch_c))).max())
            worst = max(worst, f_err, c_err)
            n_boundary += int(near.sum())
            log(f"[retrieval] compact copy on the CPU keep={keep:.0%} ({len(c):,} candidates, "
                f"{k:,} survive): max rel|cheap|={c_err:.3g} max rel|full|={f_err:.3g}; "
                f"survivors differing {len(differ)} ({len(outside)} outside the boundary rule; "
                f"{int(near.sum())} candidates at the boundary)")
            if outside or not c_err <= TOL or not f_err <= TOL:
                raise AssertionError(f"[retrieval] keep={keep}: card and CPU differ")
    return {"err": worst, "boundary": n_boundary}


# ---------------------------------------------------------------------------
# [cells]: the model-cell path at full width.
# ---------------------------------------------------------------------------

# Cuts of the [cells] phase, by arithmetic (PERF.md §4). BERT4Rec's tied
# softmax at 65,536 × 200 × 27,136 f32 is 1.42 TB of logits, and its
# attention at 262,144 × 2 heads × 200 × 200 f32 is 84 GB of scores.
CELL_BATCH_CUTS = {
    ("bert4rec", "train_batch"): (256, "tied-softmax logits at 65,536 x 200 x 27,136 f32 "
                                       "are 1.42 TB"),
    ("bert4rec", "serve_bulk"): (8192, "attention scores at 262,144 x 2 x 200 x 200 f32 "
                                       "are 84 GB"),
}
CELL_RECSYS = ("dlrm-rm2", "deepfm", "din", "bert4rec")
CELL_TIMED_STEPS = 3          # timed after one warm step; the median is printed
CELL_TRAIN_STEPS = 5          # training steps on one batch (the first is the warm one)
CELL_CHECK_REQUESTS = 64      # requests held to the CPU port
CELL_CHECK_CANDS = 4096       # candidates held to the CPU port
CELL_UNTOUCHED_SAMPLE = 2048  # untouched rows sampled per row-wise table


def _events_ms(fn, n: int) -> tuple[float, list]:
    """Median device time of ``n`` calls of ``fn``, each between its own
    pair of CUDA events; returns it with the last call's result."""
    import torch

    times, out = [], None
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def _cell_shapes(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    for shape in get_config(arch).shapes:
        cut = CELL_BATCH_CUTS.get((arch, shape.name))
        if cut is not None:
            log(f"[cells] {arch} {shape.name}: cut batch {shape.batch} -> {cut[0]} ({cut[1]})")
            shape = dataclasses.replace(shape, batch=cut[0])
        yield shape


def _gib(n_bytes: float) -> str:
    return f"{n_bytes / 1e9:.2f} GB"


def _compact_dlrm(cfg, params, sparse, cands=None):
    """A CPU copy of DLRM's parameters holding only the table rows that
    ``sparse`` ([n, fields, hot] ids) and ``cands`` touch, with the ids
    remapped. A table below ROWWISE_MIN_ROWS rows is copied whole; a larger
    one keeps its touched rows first and is padded with zero rows to at least
    ROWWISE_MIN_ROWS, so the optimizer still treats it row-wise. Returns
    (params, sparse, cands, touched rows per table)."""
    import numpy as np
    import torch

    from repro_torch.models.recsys import pad_rows
    from repro_torch.train.optimizer import ROWWISE_MIN_ROWS

    out = {k: v.cpu() for k, v in params.items() if not k.startswith("tables/")}
    new_sparse, new_cands, touched = sparse.copy(), None, {}
    n_tables = len(cfg.vocab_sizes)
    for i in range(n_tables):
        table = params[f"tables/t{i}"]
        ids = sparse[:, i] if i < sparse.shape[1] else np.zeros((0,), np.int32)
        if i == n_tables - 1 and cands is not None:
            ids = np.concatenate([ids.ravel(), cands])
        if table.shape[0] < ROWWISE_MIN_ROWS:
            out[f"tables/t{i}"] = table.cpu()
            if i == n_tables - 1 and cands is not None:
                new_cands = cands.copy()
            continue
        u = np.unique(ids)
        touched[f"tables/t{i}"] = u
        rows = torch.zeros(pad_rows(max(len(u), ROWWISE_MIN_ROWS)), table.shape[1])
        rows[:len(u)] = table.index_select(0, torch.as_tensor(u, dtype=torch.int64, device=table.device)).cpu()
        out[f"tables/t{i}"] = rows
        if i < sparse.shape[1]:
            new_sparse[:, i] = np.searchsorted(u, sparse[:, i])
        if i == n_tables - 1 and cands is not None:
            new_cands = np.searchsorted(u, cands).astype(np.int32)
    return out, new_sparse, new_cands, touched


def _relu_signs(cfg, params, batch):
    """DLRM's ReLU decisions per sample, ``[B, units]`` bool on the host,
    read from the port's own forward pass: every bottom-MLP unit, then every
    hidden top-MLP unit."""
    from unittest import mock

    import torch

    from repro_torch.models.recsys import dlrm_forward

    relu, signs = torch.relu, []

    def recording_relu(x):
        signs.append(x > 0)
        return relu(x)

    with torch.no_grad(), mock.patch.object(torch, "relu", recording_relu):
        dlrm_forward(cfg, params, batch)
    return torch.cat(signs, dim=1).cpu()


def _dlrm_cell() -> dict:
    """DLRM-RM2 at full width: train on one batch of 65,536 with row-wise
    Adagrad (sparse rows in place), then serve the three serving shapes with
    the trained tables, each held to the CPU port on a compact copy."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import init_state

    dev = torch.device(DEVICE)
    cfg = get_config("dlrm-rm2")
    shapes = {s.name: s for s in _cell_shapes("dlrm-rm2")}
    out = {}

    # Training.
    torch.cuda.reset_peak_memory_stats()
    cell = make_cell(cfg, shapes["train_batch"])
    t0 = time.perf_counter()
    state = cell.init_state(SEED, device=dev)
    torch.cuda.synchronize()
    tables = sum(v.numel() * 4 for k, v in state.params.items() if k.startswith("tables/"))
    acc = sum(v.numel() * 4 for v in state.opt_state["acc"].values())
    row_acc = sum(v.numel() * 4 for k, v in state.opt_state["acc"].items()
                  if k.startswith("tables/") and v.ndim == 1)
    n_rows = sum(v.shape[0] for k, v in state.params.items() if k.startswith("tables/"))
    log(f"[cells] dlrm-rm2: init on the card in {time.perf_counter() - t0:.2f} s: "
        f"{n_rows:,} padded table rows x {cfg.embed_dim} = {_gib(tables)} of tables, "
        f"row accumulators {_gib(row_acc)} (all Adagrad state {_gib(acc)}); largest table "
        f"{max(v.numel() for k, v in state.params.items() if k.startswith('tables/')):,} elements")
    raw = synthesize_inputs(cell, seed=SEED)
    batch = as_tensors(raw, dev)
    cpu_params, cpu_sparse, _, touched = _compact_dlrm(cfg, state.params, raw["sparse"])
    cpu_batch = {"dense": torch.as_tensor(raw["dense"]), "sparse": torch.as_tensor(cpu_sparse),
                 "label": torch.as_tensor(raw["label"])}
    # The kink rule: a sample whose ReLU decisions differ between the card
    # and the CPU (a pre-activation within rounding of 0) takes another
    # gradient path; the rows it touches are set aside.
    with torch.no_grad():
        kinked = (_relu_signs(cfg, state.params, batch)
                  != _relu_signs(cfg, cpu_params, cpu_batch)).any(dim=1)
    kinked = kinked.numpy()
    aside = {k: np.isin(u, raw["sparse"][kinked, int(k.split("/t")[1])]) for k, u in touched.items()}
    rng = np.random.default_rng(SEED + 50)
    untouched = {}
    for k, u in touched.items():
        rows = rng.integers(0, state.params[k].shape[0], CELL_UNTOUCHED_SAMPLE)
        rows = np.unique(rows[~np.isin(rows, u)])
        idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        untouched[k] = (idx, state.params[k].index_select(0, idx).cpu())

    losses, times = [], []
    for i in range(CELL_TRAIN_STEPS):
        ms, (state, metrics) = _events_ms(lambda: cell.step(state, batch), 1)
        losses.append(float(metrics["loss"]))
        times.append(ms)
        if i == 0:
            mlp1 = {k: v.cpu() for k, v in state.params.items() if not k.startswith("tables/")}
            after1 = {k: state.params[k].index_select(
                0, torch.as_tensor(u, dtype=torch.int64, device=dev)).cpu()
                for k, u in touched.items()}
            acc1 = {k: state.opt_state["acc"][k].index_select(
                0, torch.as_tensor(u, dtype=torch.int64, device=dev)).cpu()
                for k, u in touched.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dlrm-rm2 train: losses {losses} not finite or not falling")

    # The CPU port, one step on the compact copy of the same batch.
    t0 = time.perf_counter()
    cpu_state = init_state(cpu_params, get_optimizer(cfg.optimizer))
    cpu_state, cpu_m = cell.step(cpu_state, cpu_batch)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(losses[0] - float(cpu_m["loss"]))
    keep = {k: torch.as_tensor(~a) for k, a in aside.items()}
    row_err = max((float((after1[k] - cpu_state.params[k][:len(u)])[keep[k]].abs().max())
                   for k, u in touched.items()), default=0.0)
    acc_err = max((float(((acc1[k] - cpu_state.opt_state["acc"][k][:len(u)]).abs()
                          / cpu_state.opt_state["acc"][k][:len(u)].abs().clamp_min(1e-30))[keep[k]].max())
                   for k, u in touched.items()), default=0.0)
    n_aside = sum(int(a.sum()) for a in aside.values())
    aside_err = max((float((after1[k] - cpu_state.params[k][:len(u)])[~keep[k]].abs().max())
                     for k, u in touched.items() if (~keep[k]).any()), default=0.0)
    mlp_err = max(float((v - cpu_state.params[k]).abs().max()) for k, v in mlp1.items())
    changed = sum(
        int(((state.params[k].index_select(0, idx).cpu() != before).any(dim=1)
             | (state.opt_state["acc"][k].index_select(0, idx).cpu() != 0)).sum())
        for k, (idx, before) in untouched.items()
    )
    n_sampled = sum(len(idx) for idx, _ in untouched.values())
    n_touched = sum(len(u) for u in touched.values())
    log(f"[cells] dlrm-rm2 train_batch B={shapes['train_batch'].batch}: {CELL_TRAIN_STEPS} steps "
        f"on one batch, losses {[round(x, 6) for x in losses]}; step {statistics.median(times[1:]):.3f} ms "
        f"(median of {CELL_TRAIN_STEPS - 1} after one warm step of {times[0]:.3f} ms); "
        f"peak memory {_gib(peak)}; vs the CPU port on a compact copy ({n_touched:,} touched "
        f"rows of the row-wise tables, {cpu_s:.1f} s): |loss|={loss_err:.3g} "
        f"max|touched row|={row_err:.3g} (max rel|row accumulator|={acc_err:.3g}, not held: "
        f"it carries the gradient's scale, whose rounding a loss gradient sigma(z) - y near 0 "
        f"magnifies; the step divides it out); kink rule: "
        f"{int(kinked.sum())} samples with a ReLU decision that differs, {n_aside} of their "
        f"rows set aside (max|row| there {aside_err:.3g}) "
        f"(MLP weights after the first dense Adagrad step, not held: {mlp_err:.3g}); "
        f"untouched rows changed: {changed} of {n_sampled} sampled")
    if loss_err > TOL * max(1.0, abs(losses[0])) or row_err > TOL or changed:
        raise AssertionError("dlrm-rm2 train: the card differs from the CPU port")
    out["train_batch"] = {"ms": statistics.median(times[1:]), "peak": peak, "losses": losses}
    _timed("dlrm-rm2 train_batch", cfg, shapes["train_batch"], out["train_batch"]["ms"])

    # Serving with the trained tables.
    params = state.params
    del state, cpu_state, cpu_params
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        torch.cuda.reset_peak_memory_stats()
        scell = make_cell(cfg, shapes[name])
        raw = synthesize_inputs(scell, seed=SEED + 1)
        inputs = as_tensors(raw, dev)
        scell.step(params, inputs)  # warm
        ms, scores = _events_ms(lambda: scell.step(params, inputs), CELL_TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated()
        n_out = shapes[name].n_candidates and -(-shapes[name].n_candidates // 512) * 512
        want_shape = (n_out or shapes[name].batch,)
        if tuple(scores.shape) != want_shape or not torch.isfinite(scores).all():
            raise AssertionError(f"dlrm-rm2 {name}: shape {tuple(scores.shape)} or non-finite")
        if name == "retrieval_cand":
            c = raw["cand_ids"][:CELL_CHECK_CANDS]
            cp, cs, cc, _ = _compact_dlrm(cfg, params, raw["sparse"], c)
            want = make_cell(cfg, shapes[name]).step(cp, {
                "dense": torch.as_tensor(raw["dense"]), "sparse": torch.as_tensor(cs),
                "cand_ids": torch.as_tensor(cc)})
            got, what = scores[:CELL_CHECK_CANDS].cpu(), f"first {CELL_CHECK_CANDS} candidates"
        else:
            n = CELL_CHECK_REQUESTS
            cp, cs, _, _ = _compact_dlrm(cfg, params, raw["sparse"][:n])
            want = scell.step(cp, {"dense": torch.as_tensor(raw["dense"][:n]),
                                   "sparse": torch.as_tensor(cs)})
            got, what = scores[:n].cpu(), f"first {n} requests"
        err = float((got - want).abs().max())
        log(f"[cells] dlrm-rm2 {name}: {want_shape[0]:,} scores in {ms:.3f} ms "
            f"(median of {CELL_TIMED_STEPS} after one warm call); peak memory {_gib(peak)}; "
            f"{what} vs the CPU port on a compact copy: max_abs_err={err:.3g}")
        if not err <= TOL:
            raise AssertionError(f"dlrm-rm2 {name}: differs from the CPU port by {err}")
        out[name] = {"ms": ms, "peak": peak}
        _timed(f"dlrm-rm2 {name}", cfg, shapes[name], ms)
        if name == "retrieval_cand":
            retrieval_raw = raw
    del scell, inputs, scores
    out["retrieval"] = _retrieval(cfg, params, retrieval_raw)
    del params
    return out


def _recsys_cell(arch: str) -> dict:
    """DeepFM, DIN or BERT4Rec at full width: train steps on one batch
    (the loss must fall), then each serving shape (finite, of its shape)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import DIN_CAND_CHUNK, make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    dev = torch.device(DEVICE)
    cfg = get_config(arch)
    out, params = {}, None
    for shape in _cell_shapes(arch):
        torch.cuda.reset_peak_memory_stats()
        cell = make_cell(cfg, shape)
        inputs = as_tensors(synthesize_inputs(cell, seed=SEED), dev)
        if shape.kind == "train":
            state = cell.init_state(SEED, device=dev)
            losses, times = [], []
            for _ in range(CELL_TRAIN_STEPS):
                ms, (state, m) = _events_ms(lambda: cell.step(state, inputs), 1)
                losses.append(float(m["loss"]))
                times.append(ms)
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"{arch} train: losses {losses} not finite or not falling")
            params = state.params
            del state
            ms = statistics.median(times[1:])
            what = f"losses {[round(x, 6) for x in losses]}"
        else:
            cell.step(params, inputs)  # warm
            ms, scores = _events_ms(lambda: cell.step(params, inputs), CELL_TIMED_STEPS)
            n = -(-shape.n_candidates // 512) * 512 if shape.n_candidates else shape.batch
            if tuple(scores.shape) != (n,) or not torch.isfinite(scores).all():
                raise AssertionError(f"{arch} {shape.name}: shape {tuple(scores.shape)} or non-finite")
            what = f"{n:,} finite scores"
            if arch == "din" and shape.n_candidates:
                what += f", swept in chunks of {DIN_CAND_CHUNK:,} candidates"
        peak = torch.cuda.max_memory_allocated()
        log(f"[cells] {arch} {shape.name} B={shape.batch}: {what}; step {ms:.3f} ms "
            f"(median after one warm step); peak memory {_gib(peak)}")
        out[shape.name] = {"ms": ms, "peak": peak}
        _timed(f"{arch} {shape.name}", cfg, shape, ms)
    if arch == "din":
        out["resume"] = _din_resume(cfg)
    return out


def _din_resume(cfg) -> bool:
    """DIN at full width: 4 steps straight against 2 steps, a checkpoint
    saved and restored, and 2 more steps: bit-equal."""
    import shutil
    import tempfile

    import torch

    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.utils import tree_items

    dev = torch.device(DEVICE)
    cell = make_cell(cfg, next(s for s in cfg.shapes if s.kind == "train"))
    batches = [as_tensors(synthesize_inputs(cell, seed=i), dev) for i in range(4)]
    straight = cell.init_state(SEED, device=dev)
    for b in batches:
        straight, _ = cell.step(straight, b)
    resumed = cell.init_state(SEED, device=dev)
    for b in batches[:2]:
        resumed, _ = cell.step(resumed, b)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="cells_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        save_checkpoint(ckpt, 2, resumed, extra={"step": 2})
        template = cell.init_state(SEED + 1, device=dev)
        torch.cuda.synchronize()
        state_bytes = sum(v.numel() * v.element_size() for _, v in tree_items(template))
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        resumed, extra = restore_checkpoint(ckpt, template)
        torch.cuda.synchronize()
        restore_extra = torch.cuda.max_memory_allocated() - before
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for b in batches[int(extra["step"]):]:
        resumed, _ = cell.step(resumed, b)
    a, b = dict(tree_items(straight)), dict(tree_items(resumed))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"[cells] din resume at full width: 4 steps straight vs 2 + save + restore + 2: "
        f"{len(a)} tensors, {len(differ)} differ; the restore, in place into a state of "
        f"{_gib(state_bytes)}, took {_gib(restore_extra)} more card memory at its peak")
    if differ:
        raise AssertionError(f"din resume is not bit-equal: {differ[:5]}")
    if restore_extra * 2 > state_bytes:
        raise AssertionError(f"din restore took {restore_extra} bytes beside the state")
    return True


def _forest_cell(shape_name: str) -> dict:
    """lear-msn1 at a published shape: the kernel route against the plain
    route on the card (0 difference), the first 64 queries against the CPU
    port (1e-5, boundary rule), three kernel launches a step."""
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import forest_score as fs
    from repro_torch.kernels import ops
    from repro_torch.models.api import forest_head, make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    dev = torch.device(DEVICE)
    cfg = get_config("lear-msn1")
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    cell = make_cell(cfg, shape)
    torch.cuda.reset_peak_memory_stats()
    params = cell.init_state(SEED, device=dev)
    t0 = time.perf_counter()
    raw = synthesize_inputs(cell, seed=SEED)
    inputs = as_tensors(raw, dev)
    synth_s = time.perf_counter() - t0
    Q, D, F = inputs["X"].shape
    cell.step(params, inputs)  # warm: buffers, plans, scratch
    reset_launches()
    ops.reset_launch_counts()
    ms, (scores, cont) = _events_ms(lambda: cell.step(params, inputs), CELL_TIMED_STEPS)
    launches, dispatches = kernel_launches(), ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["forest_score"] != 3 * CELL_TIMED_STEPS:
        raise AssertionError(f"forest cell {shape_name}: kernel launches {launches}")

    # The same step with the kernel's plain version, on the card.
    def plain(x, feature, threshold, mask, leaf, *, leaf_gather, packed, **kw):
        return fs.forest_score_plain(x, feature, threshold, mask, leaf, **kw)

    with mock.patch.object(ops, "forest_score_kernel", plain):
        p_scores, p_cont = cell.step(params, inputs)
    plain_err = float((scores - p_scores).abs().max())
    cont_diff = int((cont != p_cont).sum())

    # The first 64 queries on the CPU port (same seed, same trees).
    n = min(CELL_CHECK_REQUESTS, Q)
    cpu_params = cell.init_state(SEED, device="cpu")
    cpu_in = {"X": torch.as_tensor(raw["X"][:n]), "mask": torch.as_tensor(raw["mask"][:n])}
    c_scores, c_cont = cell.step(cpu_params, cpu_in)
    _, _, prob = forest_head(cfg, cpu_params, cpu_in["X"], cpu_in["mask"])
    boundary = cpu_in["mask"] & ((prob - cpu_params["threshold"]).abs() <= TOL)
    ok = ~boundary
    cpu_err = float((scores[:n].cpu() - c_scores)[ok].abs().max())
    cpu_cont = int((cont[:n].cpu() != c_cont)[ok].sum())
    log(f"[cells] lear-msn1 {shape_name}: {Q} queries x {D} docs = {Q * D:,} rows, "
        f"step {ms:.3f} ms (median of {CELL_TIMED_STEPS} after one warm step; inputs drawn "
        f"in {synth_s:.2f} s); peak memory {_gib(peak)}; continue rate "
        f"{float(cont.sum()) / float(inputs['mask'].sum()):.4f}; kernel_launches={launches} "
        f"dispatches={dispatches}; kernel vs plain on the card: max_abs_err={plain_err:.3g}, "
        f"cont differs at {cont_diff}; first {n} queries vs the CPU port: "
        f"max_abs_err={cpu_err:.3g}, cont differs at {cpu_cont} "
        f"({int(boundary.sum())} boundary docs set aside)")
    if plain_err != 0.0 or cont_diff or not cpu_err <= TOL or cpu_cont:
        raise AssertionError(f"forest cell {shape_name}: kernel, plain and CPU disagree")
    pfc = ops.padded_forest(params["classifier"])
    pf = ops.padded_forest(params["ranker"], boundaries=(cfg.sentinel, cfg.n_trees))
    x2d = inputs["X"].reshape(-1, F)
    _, aug, _ = forest_head(cfg, params, inputs["X"], inputs["mask"])
    cases = [(f"cell {shape_name} ranker head [0,1)", pf, x2d, 0, 1),
             (f"cell {shape_name} classifier [0,1)", pfc, aug, 0, 1),
             (f"cell {shape_name} ranker tail [1,2)", pf, x2d, 1, 2)]
    _timed(f"lear-msn1 {shape_name}", cfg, shape, ms)
    return {"ms": ms, "peak": peak, "launches": launches, "cases": cases}


def _launchers() -> int:
    """Both launchers at the reference's defaults (smoke configs) on the
    card; returns the forest kernel's launches."""
    import shutil
    import tempfile

    from repro_torch.launch import serve, train

    reset_launches()
    serve.main(["--arch", "dlrm-rm2", "--device", DEVICE])
    serve.main(["--arch", "lear-msn1", "--device", DEVICE])
    launches = kernel_launches()["forest_score"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="cells_launch_", dir=os.path.join(ROOT, "build"))
    try:
        train.main(["--arch", "dlrm-rm2", "--ckpt-dir", ckpt, "--device", DEVICE])
        if sorted(os.listdir(ckpt)) != ["step_0000000010.json", "step_0000000010.npz",
                                        "step_0000000020.json", "step_0000000020.npz"]:
            raise AssertionError(f"train launcher checkpoints: {sorted(os.listdir(ckpt))}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    try:
        train.main(["--arch", "lear-msn1", "--device", DEVICE])
        raise AssertionError("the train launcher accepted lear-msn1")
    except SystemExit as e:
        log(f"[cells] launch.train --arch lear-msn1: exits as the reference's does: {e}")
    log(f"[cells] launchers: serve dlrm-rm2 and lear-msn1, train dlrm-rm2 (20 steps, "
        f"checkpoints at 10 and 20) on the card; forest kernel launches {launches}")
    if launches != 9:
        raise AssertionError(f"launch.serve lear-msn1: {launches} kernel launches, want 9")
    return launches


def phase_cells(card: str) -> dict:
    """The model-cell path: the launchers, then every RecSys cell and the
    forest cell at full width, one cell at a time (two DLRM-RM2 states do
    not fit one card)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    launches = {**no_launches(), "forest_score": _launchers()}
    results = {"dlrm-rm2": _dlrm_cell()}
    for arch in CELL_RECSYS[1:]:
        gc.collect()
        torch.cuda.empty_cache()
        results[arch] = _recsys_cell(arch)
    cases = []
    for name in ("rank_xl", "rank_online"):
        gc.collect()
        torch.cuda.empty_cache()
        r = _forest_cell(name)
        for k, n in r.pop("launches").items():
            launches[k] += n
        cases += r.pop("cases") if name == "rank_xl" else []
        results[f"lear-msn1 {name}"] = r
    xl = results["lear-msn1 rank_xl"]
    dl = results["dlrm-rm2"]
    rt = dl["retrieval"]
    summary = (
        f"cells: dlrm-rm2 train step {dl['train_batch']['ms']:.3f} ms at "
        f"{_gib(dl['train_batch']['peak'])} peak, lear-msn1 rank_xl step {xl['ms']:.3f} ms; "
        f"retrieval: two-stage cascade "
        + ", ".join(f"keep {k:.0%} {rt[k]['ms']:.3f} ms (recall {rt[k]['recall']:.2f})"
                    for k in RETRIEVAL_KEEPS)
        + f" vs full scoring {rt[RETRIEVAL_KEEPS[0]]['full_ms']:.3f} ms"
    )
    log(f"[cells] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"launches": launches, "cases": cases, "summary": summary}


# ---------------------------------------------------------------------------
# [lm]: the LM serving path at full width.
# ---------------------------------------------------------------------------

LM_FULL = ("qwen3-4b", "deepseek-moe-16b")
LM_SHAPES_ONLY = ("qwen2.5-14b", "minitron-4b", "llama4-maverick-400b-a17b")
# Batch cuts of the published shapes (prefill_32k B = 32, decode_32k
# B = 128), by arithmetic: printed with their cache sizes (PERF.md §4).
LM_PREFILL_BATCH = {"qwen3-4b": 1, "deepseek-moe-16b": 1}
LM_DECODE_BATCH = {"qwen3-4b": 8, "deepseek-moe-16b": 4}
LM_COMPACT = (2, 64, 4)      # batch, prompt tokens, greedy steps: first layers, card vs CPU
LM_CONSIST = (2, 511)        # batch, S: prefill(S + 1) vs prefill(S) + decode at S
LM_GENERATE = (2, 128, 16)   # batch, prompt tokens, greedy steps
LM_DECODE_STEPS = 3          # timed after one warm step; the median is printed


def _lm_cache_bytes(cfg, batch: int, tokens: int) -> int:
    return 2 * cfg.n_layers * batch * tokens * cfg.n_kv_heads * cfg.d_head * 2


def _lm_prefill_ops(cfg, B: int, S: int) -> tuple[float, float]:
    """(bf16 tensor-core FLOPs, float32 FLOPs) of one prefill of B × S
    tokens as the port computes it: every weight GEMM over every token
    (the MoE's over every capacity slot, padding included), the router in
    float32, and attention's QKᵀ and PV over every block (no causal skip),
    in float32; lm_head on the last token only."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import _capacity

    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    T = B * S
    bf16 = 2.0 * T * (2 * D * H * Dh + 2 * D * Hkv * Dh) * cfg.n_layers + 2.0 * B * D * cfg.vocab_size
    f32 = 4.0 * B * H * S * S * Dh * cfg.n_layers
    for _, L, moe in tfm._stacks(cfg):
        if not moe:
            bf16 += 2.0 * T * 3 * D * (cfg.dense_d_ff or cfg.d_ff) * L
            continue
        E, Fe = cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
        C = _capacity(S, E, cfg.top_k, cfg.capacity_factor)
        bf16 += 2.0 * B * E * C * 3 * D * Fe * L + 2.0 * T * 3 * D * cfg.n_shared_experts * Fe * L
        f32 += 2.0 * T * D * E * L
    return bf16, f32


def _lm_decode_bytes(cfg, params, B: int, S: int) -> int:
    """Bytes one decode step must move: every weight but the embedding
    table (B rows of it), the whole cache (the reference masks, it does not
    skip, the positions past ``pos``), the new keys and values and the
    float32 logits."""
    w = sum(t.numel() * t.element_size() for k, t in params.items() if k != "embed")
    emb = params["embed"]
    return (w + B * emb.shape[1] * emb.element_size() + _lm_cache_bytes(cfg, B, S)
            + _lm_cache_bytes(cfg, B, 1) + B * cfg.vocab_size * 4)


def _lm_finite(what: str, logits, caches=None) -> None:
    """Fail on a non-finite logit or cache entry. Caches are checked a
    layer at a time: ``isfinite`` of a whole 19 GB cache would allocate a
    copy and two masks of it."""
    import torch

    ok = [torch.isfinite(logits).all()]
    for c in (caches or {}).values():
        ok += [torch.isfinite(t[i]).all() for t in c.values() for i in range(t.shape[0])]
    if not bool(torch.stack(ok).all()):
        raise AssertionError(f"[lm] {what}: non-finite values")


def _lm_compact(arch: str, cfg, params) -> dict:
    """The full-width model's first layers (Qwen3-4B's first 2; DeepSeek's
    dense layer and its first MoE layer) with the full embedding and
    lm_head, on the card and on the CPU port: a prefill, then greedy decode
    steps, the CPU fed the card's tokens. Held by tests/lm_parity.py: logits
    and caches within the bfloat16 tolerance, and greedy tokens equal except
    where the card's logits of the two tokens lie within the tolerance. The
    MoE layer is the copy's last, so it reaches only the logits of the token
    it routes: a step's logits are set aside for a sequence whose read token
    was re-routed at a near tie (``rerouted_last``); caches never are."""
    import dataclasses

    import numpy as np
    import torch

    from lm_parity import BF16_LOGIT_TOL, hold, hold_caches, record_port, rerouted_last

    from repro_torch.models import transformer as tfm

    B, S, steps = LM_COMPACT
    keep = {"dense_stack": 1 if cfg.is_moe else 2, "moe_stack": 1}
    ccfg = dataclasses.replace(cfg, n_layers=2)
    cparams = {k: v[:keep[k.split("/")[0]]] if "/" in k else v for k, v in params.items()}
    prompt = np.random.default_rng(SEED + 60).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    runs, feed = {}, []
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        p = cparams if side == "card" else {k: v.cpu() for k, v in cparams.items()}
        calls, logits, caches_at = [], [], []
        t0 = time.perf_counter()
        with record_port(calls):
            lg, caches = tfm.prefill(ccfg, p, torch.as_tensor(prompt, device=dev), S + steps)
            logits.append(lg.cpu())
            # Copies: decode writes the caches in place (and .cpu() of a CPU
            # tensor is the tensor itself).
            caches_at.append({n: {k: t.to("cpu", copy=True) for k, t in c.items()}
                              for n, c in caches.items()})
            for i in range(steps):
                if side == "card":
                    feed.append(torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None])
                lg, caches = tfm.decode_step(ccfg, p, feed[i].to(dev), caches, S + i)
                logits.append(lg.cpu())
        caches_at.append({n: {k: t.cpu() for k, t in c.items()} for n, c in caches.items()})
        runs[side] = (calls, logits, caches_at, time.perf_counter() - t0)
        _lm_finite(f"{arch} compact copy on the {side}", lg, caches)

    (card_calls, card_lg, card_c, t_card), (cpu_calls, cpu_lg, cpu_c, t_cpu) = runs["card"], runs["cpu"]
    errs, gaps, aside = [0.0, 0.0], 0, 0
    for i in range(steps + 1):
        moved = rerouted_last(card_calls[i], cpu_calls[i], B) if ccfg.is_moe else {}
        for seq, msg in moved.items():
            if msg:
                raise AssertionError(f"[lm] {arch} compact, step {i}, sequence {seq}: {msg}")
        rows = [b for b in range(B) if b not in moved]
        aside += len(moved)
        errs[0] = max(errs[0], hold(cpu_lg[i], card_lg[i], rows, "bfloat16", f"logits compact {i}"))
        for b in rows:
            want, got = int(card_lg[i][b].argmax()), int(cpu_lg[i][b].argmax())
            if want != got:
                gap = float(card_lg[i][b, want] - card_lg[i][b, got])
                if gap > BF16_LOGIT_TOL:
                    raise AssertionError(f"[lm] {arch} compact: step {i} row {b} greedy tokens "
                                         f"{want} (card) and {got} (CPU), gap {gap:.4g}")
                gaps += 1
    for j, i in enumerate((0, steps)):
        errs[1] = max(errs[1], hold_caches(cpu_c[j], card_c[j], list(range(B)), "bfloat16",
                                           f"compact {i}"))
    log(f"[lm] {arch} compact copy ({ccfg.n_layers} layers of full width, full embedding and "
        f"lm_head; prefill {B}x{S} + {steps} greedy steps) card vs CPU: max |dlogits| "
        f"{errs[0]:.4g}, max |dcache| {errs[1]:.4g} (tolerance {BF16_LOGIT_TOL}); greedy "
        f"tokens differing within the top-2 gap: {gaps}; logits set aside for a read token "
        f"re-routed at a near tie: {aside} of {B * (steps + 1)}; card {t_card:.2f} s, CPU "
        f"{t_cpu:.2f} s")
    return {"logits": errs[0], "caches": errs[1], "gaps": gaps, "aside": aside}


def _lm_rerun(arch: str, cfg, params) -> None:
    """The same prefill twice on the card: bit-equal logits and caches (the
    MoE sums each token's experts in a fixed order, no float atomics)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm

    B, S = LM_CONSIST[0], LM_CONSIST[1] + 1
    tokens = torch.as_tensor(np.random.default_rng(SEED + 61).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=DEVICE)
    (la, ca), (lb, cb) = (tfm.prefill(cfg, params, tokens, S) for _ in range(2))
    same = torch.equal(la, lb) and all(torch.equal(ca[n][k], cb[n][k]) for n in ca for k in ca[n])
    if not same:
        raise AssertionError(f"[lm] {arch}: a rerun of prefill {B}x{S} is not bit-equal")
    _lm_finite(f"{arch} rerun", la, ca)
    log(f"[lm] {arch} rerun of prefill {B}x{S}: logits and caches bit-equal")


def _lm_consistency(arch: str, cfg, gen) -> float:
    """Full depth, float32: the last logits of prefill(S + 1) against
    prefill(S) then decode_step at position S (2e-4). DeepSeek runs with
    capacity_factor E / top_k, so C = T and no token is dropped: with the
    config's 1.25 a prefill of S + 1 tokens drops or displaces other tokens
    than a prefill of S tokens and a decode step do, by GShard's design."""
    import dataclasses

    import numpy as np
    import torch

    from lm_parity import hold
    from repro_torch.models import transformer as tfm

    B, S = LM_CONSIST
    in_use = torch.cuda.memory_allocated()
    cut = {"capacity_factor": cfg.n_experts / cfg.top_k} if cfg.is_moe else {}
    c32 = dataclasses.replace(cfg, dtype="float32", **cut)
    p32 = tfm.init(c32, gen, DEVICE)
    tokens = torch.as_tensor(np.random.default_rng(SEED + 62).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32), device=DEVICE)
    full, _ = tfm.prefill(c32, p32, tokens, S + 1)
    _, caches = tfm.prefill(c32, p32, tokens[:, :S], S + 1)
    step, caches = tfm.decode_step(c32, p32, tokens[:, S:], caches, S)
    _lm_finite(f"{arch} consistency", step, caches)
    err = hold(step, full, list(range(B)), "float32", f"logits {arch} consistency")
    log(f"[lm] {arch} full depth ({cfg.n_layers} layers), float32"
        + (f", capacity_factor {c32.capacity_factor:.4g} (C = T)" if cut else "")
        + f": prefill({S + 1}) vs prefill({S}) + decode_step at {S}, B = {B}: "
        f"max |dlogits| {err:.4g} (tolerance 2e-4); weights {_gib(sum(t.numel() * 4 for t in p32.values()))} "
        f"beside {_gib(in_use)} in use before")
    del p32, caches
    return err


def _lm_prefill_timed(arch: str, cfg, params, card: str) -> dict:
    """prefill_32k at the cut batch, timed; for an MoE, a second prefill
    counts capacity drops and must equal the first bit for bit."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import _capacity

    pre, B = next(s for s in cfg.shapes if s.name == "prefill_32k"), LM_PREFILL_BATCH[arch]
    S = pre.seq_len
    log(f"[lm] {arch} prefill_32k: cut batch {pre.global_batch} -> {B} (caches "
        f"{_gib(_lm_cache_bytes(cfg, pre.global_batch, S))} at {pre.global_batch}, "
        f"{_gib(_lm_cache_bytes(cfg, B, S))} at {B})")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 63).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ms, (logits, caches) = _events_ms(lambda: tfm.prefill(cfg, params, tokens, S), 1)
    peak = torch.cuda.max_memory_allocated()
    _lm_finite(f"{arch} prefill_32k", logits, caches)
    if cfg.is_moe:
        logits2, caches2, dropped = _lm_prefill_counting_drops(cfg, params, tokens)
        if not (torch.equal(logits, logits2)
                and all(torch.equal(caches[n][k], caches2[n][k]) for n in caches for k in "kv")):
            raise AssertionError(f"[lm] {arch}: a rerun of prefill {B}x{S} is not bit-equal")
        C = _capacity(S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
        log(f"[lm] {arch} prefill_32k: capacity C = {C} slots per expert; (token, expert) "
            f"choices dropped for capacity over the {cfg.n_moe_layers} MoE layers: "
            f"{dropped:.3%}; a rerun is bit-equal")
    del logits, caches
    bf16, f32 = _lm_prefill_ops(cfg, B, S)
    bound = bf16 / _rf().BF16_FLOPS + f32 / _rf().F32_FLOPS
    log(f"[lm] {arch} prefill {B}x{S}: {ms:.1f} ms, {B * S / ms * 1e3:,.0f} tokens/s, peak "
        f"{_gib(peak)}; bound {bound * 1e3:.1f} ms (bf16 {bf16:.4g} FLOP / 989 TFLOP/s = "
        f"{bf16 / _rf().BF16_FLOPS * 1e3:.1f} ms + f32 {f32:.4g} FLOP / 67 TFLOP/s = "
        f"{f32 / _rf().F32_FLOPS * 1e3:.1f} ms), {ms / 1e3 / bound:.2f}x the bound; {card}")
    # Where it goes: one layer's attention alone, at the layer's shapes.
    from repro_torch.models.layers import blockwise_attention

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    q = torch.randn((B, S, cfg.n_heads, cfg.d_head), generator=g, device=DEVICE, dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, cfg.n_kv_heads, cfg.d_head), generator=g, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    attn_ms, _ = _events_ms(lambda: blockwise_attention(
        q, k, v, causal=cfg.causal, q_block=min(cfg.attn_q_block, S),
        kv_block=min(cfg.attn_kv_block, S), causal_skip=cfg.causal_skip), 1)
    log(f"[lm] {arch} prefill {B}x{S}: blockwise attention alone {attn_ms:.1f} ms a layer, "
        f"x {cfg.n_layers} layers = {attn_ms * cfg.n_layers:.0f} ms of the {ms:.0f} ms "
        f"({attn_ms * cfg.n_layers / ms:.1%}); its float32 products' bound "
        f"{f32 / _rf().F32_FLOPS * 1e3 / cfg.n_layers:.1f} ms a layer")
    _timed(f"{arch} prefill {B}x{S}", cfg, dataclasses.replace(pre, global_batch=B), ms,
           bound * 1e3)
    return {"ms": ms, "tokens_s": B * S / ms * 1e3, "peak": peak, "bound_ms": bound * 1e3,
            "attn_share": attn_ms * cfg.n_layers / ms}


def _lm_decode_timed(arch: str, cfg, params, gen, card: str) -> dict:
    """decode_32k at the cut batch against a cache drawn on the card (every
    position valid), timed: one warm step, then ``LM_DECODE_STEPS``."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm

    dec, B = next(s for s in cfg.shapes if s.name == "decode_32k"), LM_DECODE_BATCH[arch]
    S = dec.seq_len
    w_bytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"[lm] {arch} decode_32k: cut batch {dec.global_batch} -> {B} (caches "
        f"{_gib(_lm_cache_bytes(cfg, dec.global_batch, S))} at {dec.global_batch}, "
        f"{_gib(_lm_cache_bytes(cfg, B, S))} at {B}, beside {_gib(w_bytes)} of weights)")
    torch.cuda.reset_peak_memory_stats()
    caches = tfm.make_decode_caches(cfg, B, S, DEVICE)
    for t in (t for c in caches.values() for t in c.values()):
        t.normal_(generator=gen)
    token = torch.as_tensor(np.random.default_rng(SEED + 64).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32), device=DEVICE)
    tfm.decode_step(cfg, params, token, caches, S - 1)
    ms, (logits, _) = _events_ms(lambda: tfm.decode_step(cfg, params, token, caches, S - 1),
                                 LM_DECODE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    _lm_finite(f"{arch} decode_32k", logits, caches)
    profiled(f"lm {arch} decode B={B}", lambda: tfm.decode_step(cfg, params, token, caches, S - 1),
             "one decode step", n_top=6)
    moved = _lm_decode_bytes(cfg, params, B, S)
    log(f"[lm] {arch} decode B={B} at position {S - 1} of a {S}-token cache: {ms:.2f} ms a step, "
        f"{B / ms * 1e3:,.1f} tokens/s, peak {_gib(peak)}; bound {moved / _rf().HBM_BW * 1e3:.2f} ms "
        f"({_gib(moved)} / 3.35 TB/s), {ms / 1e3 / (moved / _rf().HBM_BW):.2f}x the bound; {card}")
    _timed(f"{arch} decode B={B} at {S}", cfg, dataclasses.replace(dec, global_batch=B), ms,
           moved / _rf().HBM_BW * 1e3)
    return {"ms": ms, "tokens_s": B / ms * 1e3, "peak": peak,
            "bound_ms": moved / _rf().HBM_BW * 1e3}


def _lm_generate(arch: str, cfg, params) -> float:
    import numpy as np
    import torch

    from repro_torch.serve.lm_serve import generate

    B, S, steps = LM_GENERATE
    prompt = torch.as_tensor(np.random.default_rng(SEED + 65).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=DEVICE)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, n_steps=steps).cpu()
    seconds = time.perf_counter() - t0
    if toks.shape != (B, steps) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"[lm] {arch} generate: {tuple(toks.shape)} tokens out of range")
    log(f"[lm] {arch} generate B={B}, prompt {S}, {steps} greedy steps: {seconds:.2f} s; "
        f"first row {toks[0].tolist()}")
    return seconds


def _lm_full(arch: str, card: str) -> dict:
    """One arch at full width and depth: init on the card, the compact copy
    against the CPU, a bit-equal rerun, prefill at 32,768 tokens and decode
    against a 32,768-token cache (cut batches), generate, then the float32
    full-depth consistency check. Each step runs in its own function, so
    its tensors are freed when it returns."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config(arch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = tfm.init(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    w_bytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"[lm] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} shared, "
           f"{cfg.n_dense_layers} dense layer" if cfg.is_moe else "")
        + f": {n_params / 1e9:.2f} B parameters, {_gib(w_bytes)}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"compact": _lm_compact(arch, cfg, params)}
    _lm_rerun(arch, cfg, params)
    free()
    out["prefill"] = _lm_prefill_timed(arch, cfg, params, card)
    free()
    out["decode"] = _lm_decode_timed(arch, cfg, params, gen, card)
    free()
    out["generate_s"] = _lm_generate(arch, cfg, params)
    del params
    free()
    out["consistency"] = _lm_consistency(arch, cfg, gen)
    free()
    return out


def _lm_prefill_counting_drops(cfg, params, tokens):
    """The prefill again, counting at every MoE layer the (token, chosen
    expert) pairs its capacity drops (the routing recomputed from the
    layer's input by ``moe.route``; the outputs are untouched). Returns
    (logits, caches, dropped share)."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import route

    counts = []
    real = tfm.moe_ffn

    def counting(x, router_w, *args, **kw):
        _, _, weight, token_idx = route(x, router_w, top_k=kw["top_k"],
                                        capacity_factor=kw["capacity_factor"])
        kept = (torch.gather(weight.transpose(1, 2), 2, token_idx) > 0).sum()
        counts.append(torch.stack([kept, (weight > 0).sum()]))
        return real(x, router_w, *args, **kw)

    tfm.moe_ffn = counting
    try:
        logits, caches = tfm.prefill(cfg, params, tokens, tokens.shape[1])
    finally:
        tfm.moe_ffn = real
    kept, chosen = torch.stack(counts).sum(0).tolist()
    return logits, caches, 1.0 - kept / chosen


def _lm_shapes_only() -> str:
    """Qwen2.5-14B, Minitron-4B and Llama-4-Maverick by shape: parameters
    and the serving cells' states and inputs on ``meta`` (the CPU tests hold
    them to the reference's ``eval_shape``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.utils import tree_items

    parts = []
    for arch in LM_SHAPES_ONLY:
        cfg = get_config(arch)
        abstract = tfm.abstract_params(cfg)
        n = sum(t.numel() for t in abstract.values())
        size = sum(t.numel() * t.element_size() for t in abstract.values())
        cells = []
        for shape in cfg.shapes:
            if shape.skip_reason:
                continue
            cell = make_cell(cfg, shape)
            state = cell.abstract_state()
            specs = cell.input_specs()
            if any(t.device.type != "meta" for _, t in tree_items(state)):
                raise AssertionError(f"[lm] {arch} {shape.name}: state not on meta")
            caches = specs.get("caches", {})
            c_bytes = sum(t.numel() * t.element_size() for c in caches.values() for t in c.values())
            cells.append(f"{shape.name} (B {shape.global_batch}, S {shape.seq_len}"
                         + (f", caches {_gib(c_bytes)}" if caches else "") + ")")
        parts.append(f"{arch} {n / 1e9:.2f} B parameters ({_gib(size)})")
        log(f"[lm] {arch} by shape only, on meta: {n / 1e9:.2f} B parameters, {_gib(size)}; "
            f"cells {', '.join(cells)}")
    return "; ".join(parts)


def phase_lm(card: str) -> dict:
    """The LM serving path: Qwen3-4B and DeepSeek-MoE-16B at full width and
    depth, the launcher on the smoke config, and the other three LM archs
    by shape. Adds no forest kernel launch."""
    import gc

    import torch

    from repro_torch.launch import serve

    sys.path.insert(0, os.path.join(ROOT, "tests"))   # lm_parity: the tests' tolerances and rules
    t_phase = time.perf_counter()
    before = kernel_launches()
    gc.collect()
    torch.cuda.empty_cache()
    results = {arch: _lm_full(arch, card) for arch in LM_FULL}
    serve.main(["--arch", "qwen3-4b", "--device", DEVICE])
    log("[lm] launch.serve --arch qwen3-4b (smoke config) on the card: served")
    shapes = _lm_shapes_only()
    if kernel_launches() != before:
        raise AssertionError(f"[lm] the LM path launched ranking kernels: {kernel_launches()}")
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction):
        raise AssertionError("[lm] TF32 or reduced-precision bf16 reductions were enabled")
    log(f"[lm] done in {time.perf_counter() - t_phase:.1f} s on {card}; {shapes}")
    q, d = results["qwen3-4b"], results["deepseek-moe-16b"]
    summary = (
        f"lm: qwen3-4b prefill 1x32768 {q['prefill']['ms']:.0f} ms, decode B=8 "
        f"{q['decode']['ms']:.2f} ms/step; deepseek-moe-16b prefill {d['prefill']['ms']:.0f} ms, "
        f"decode B=4 {d['decode']['ms']:.2f} ms/step"
    )
    return {"results": results, "summary": summary}


# The [lm_train] phase: Qwen3-4B and DeepSeek-MoE-16B train at full width
# and the train_4k sequence length. A functional AdamW step holds 16 bytes
# a parameter through the step (bf16 parameter and gradient, float32
# accumulator, float32 m and v) and 26 while the update builds the new
# parameters, m and v beside the old: full depth would need 114.7 GB
# (Qwen3-4B, 4.41 B) and 425.8 GB (DeepSeek, 16.38 B), so depth is cut to
# what one card holds, and the batch to 4 with microbatch 2 (PERF.md §4).
LM_TRAIN_LAYERS = {"qwen3-4b": 12, "deepseek-moe-16b": 3}
LM_TRAIN_BATCH = (4, 2)        # global batch, microbatch (published: 256, 32)
LM_TRAIN_STEPS = 3             # on one fixed batch; the loss must fall
LM_TRAIN_COMPACT = (2, 256)    # batch, sequence: 2 layers at full width, card vs CPU
LM_TRAIN_CKPT = ("qwen3-4b",)  # compact train states saved and restored (10 GB each)
ADAMW_STEP_BYTES = (16, 26)    # per parameter: held through the step, peak of the update
# Card against the CPU port on the compact copy, bfloat16 (PERF.md §6):
LM_TRAIN_LOSS_TOL = 0.02       # absolute; the loss is ~ln V ≈ 11.5-12
LM_TRAIN_NORM_TOL = 0.02       # relative, the global gradient norm
LM_TRAIN_GRAD_TOL = 1 / 16     # gradients (m = 0.1·g after step 1), of each leaf's max |m|


def _lm_train_ops(cfg, B: int, S: int) -> tuple[float, float]:
    """(bf16 FLOPs, float32 FLOPs) one training step on B × S tokens must
    do: three times a prefill's (the forward, and the backward's two
    products for each forward product), lm_head over every token. The
    recomputation of remat is not counted: it is not needed work."""
    bf16, f32 = _lm_prefill_ops(cfg, B, S)
    bf16 += 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    return 3 * bf16, 3 * f32


def _lm_train_batch(vocab: int, B: int, S: int, seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


def _bf16_ulp(x):
    """bfloat16's unit in the last place at ``x`` (float32 tensor)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


@contextlib.contextmanager
def _grads_of_step(out: dict, replace: dict | None = None):
    """While a train step runs, record its gradients (by parameter path) in
    ``out``; with ``replace``, the step uses those gradients instead of its
    own (moved to its device)."""
    from repro_torch.train import trainer

    own = trainer._grads

    def recording(loss_fn, params, batch):
        loss, grads = own(loss_fn, params, batch)
        if replace is not None:
            grads = {k: replace[k].to(grads[k].device) for k in grads}
        out.update(grads)
        return loss, grads

    trainer._grads = recording
    try:
        yield out
    finally:
        trainer._grads = own


def _rel_max(got, want) -> float:
    """max |got − want| over max |want|, in float64 on ``got``'s device."""
    got, want = got.detach().double(), want.detach().to(got.device).double()
    return float((got - want).abs().max()) / (float(want.abs().max()) or 1.0)


def _lm_train_hold(arch: str, m_card, m_cpu, g_card, g_cpu, st_inj, st_cpu) -> dict:
    """Step 1 on the card against the CPU port: loss, grad norm and every
    gradient at their tolerances; and the card's update applied to the
    CPU's gradients against the CPU's step: every parameter within one
    bfloat16 unit, every float32 optimizer entry within 1e-6 of its
    leaf's max. (On its own gradients the card's first AdamW step moves a
    parameter by ``lr · g / (|g| + eps)``: a sign where |g| is large, and
    where it is small, or the two gradients differ in sign, a step that
    follows the gradients' difference; so the whole steps are not held
    entry by entry, and the entries that differ by more than one unit are
    counted.)"""
    import torch

    from repro_torch.utils import tree_items

    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    norm_err = abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1)
    # Compared on the card: a billion entries are seconds on the host.
    grad_err = max(_rel_max(g_card[k], g) for k, g in g_cpu.items())
    checks = ((loss_err, LM_TRAIN_LOSS_TOL, "loss"), (norm_err, LM_TRAIN_NORM_TOL, "grad norm"),
              (grad_err, LM_TRAIN_GRAD_TOL, "gradients"))
    for err, tol, what in checks:
        if not err <= tol:
            raise AssertionError(f"[lm_train] {arch} compact card vs CPU: {what} {err:.4g} > {tol}")
    param_err, opt_err = 0.0, 0.0
    got = dict(tree_items(st_inj))
    for k, want in tree_items(st_cpu):
        g, w = got[k], want.to(got[k].device)
        if k.startswith("params/"):
            d = (g.float() - w.float()).abs()
            if bool((d > _bf16_ulp(w.float())).any()):
                raise AssertionError(f"[lm_train] {arch} compact {k}: the card's update on the "
                                     f"CPU's gradients differs by more than one bfloat16 unit")
            param_err = max(param_err, float(d.max()))
        else:
            err = _rel_max(g, w)
            if not err <= 1e-6:
                raise AssertionError(f"[lm_train] {arch} compact {k}: the card's update on the "
                                     f"CPU's gradients is {err:.3g} off")
            opt_err = max(opt_err, err)
    return {"loss": loss_err, "norm": norm_err, "grads": grad_err, "params": param_err,
            "opt": opt_err}


def _lm_train_compact(arch: str, cfg) -> dict:
    """2 layers at full width (DeepSeek: the dense layer and one MoE
    layer), full embedding and lm_head, batch 2 × 256: one train step on
    the card and on the CPU port from the same parameters and batch, held
    by :func:`_lm_train_hold`. A MoE token the card and the CPU route
    differently must sit at a near tie (tests/lm_parity.py's rule, margin
    < 0.1); the CPU step then replays the card's routing, so the two are
    held on the same experts. Then, on the card: the loss and gradients
    with remat "nothing" twice, "dots" and no remat, bit-equal; and the
    train state saved and restored through train/checkpoint.py,
    bit-equal."""
    import functools
    import shutil
    import tempfile

    import torch

    from lm_parity import record_routes, replay_routes, rerouted
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors
    from repro_torch.train import checkpoint, trainer
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.utils import tree_items, tree_map

    B, S = LM_TRAIN_COMPACT
    ccfg = dataclasses.replace(cfg, n_layers=2)
    cell = make_cell(ccfg, ShapeSpec(name="compact", kind="train", seq_len=S, global_batch=B))
    opt = get_optimizer(ccfg.optimizer)
    params = tfm.init(ccfg, torch.Generator(device=DEVICE).manual_seed(SEED + 70), DEVICE)
    raw = _lm_train_batch(cfg.vocab_size, B, S, SEED + 70)
    batch = as_tensors(raw, DEVICE)

    routes, g_card, g_cpu = [], {}, {}
    t0 = time.perf_counter()
    record = record_routes(routes, passes=2 if ccfg.remat else 1)
    with record if ccfg.is_moe else contextlib.nullcontext(), _grads_of_step(g_card):
        st_card, m_card = cell.step(trainer.init_state(params, opt), batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    own = []
    params_cpu = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    replay = replay_routes(routes, own, passes=2 if ccfg.remat else 1)
    with replay if ccfg.is_moe else contextlib.nullcontext(), _grads_of_step(g_cpu):
        st_cpu, m_cpu = cell.step(trainer.init_state(params_cpu, opt), as_tensors(raw, "cpu"))
    t_cpu = time.perf_counter() - t0
    moved = 0
    for card_dec, cpu_dec in zip(routes, own, strict=True):
        for seq, msg in rerouted(card_dec, cpu_dec, B).items():
            if msg:
                raise AssertionError(f"[lm_train] {arch} compact, sequence {seq}: {msg}")
        moved += int((card_dec.top != cpu_dec.top).any(-1).sum())
    with _grads_of_step({}, replace=g_cpu):
        st_inj, _ = cell.step(trainer.init_state(params, opt), batch)
    held = _lm_train_hold(arch, m_card, m_cpu, g_card, g_cpu, st_inj, st_cpu)
    del st_inj, g_card
    off, off_g = 0, 0.0   # whole-step entries off by more than one unit, and their largest |g|
    for k, p in st_cpu.params.items():
        p = p.to(DEVICE).float()
        bad = (st_card.params[k].float() - p).abs() > _bf16_ulp(p)
        off += int(bad.sum())
        if bool(bad.any()):
            g = g_cpu[k].to(DEVICE).float().abs()
            off_g = max(off_g, float(g[bad].max()) / (float(g.max()) or 1.0))
    del g_cpu
    n = sum(t.numel() for t in params.values())
    log(f"[lm_train] {arch} compact copy (2 layers of full width, full embedding and lm_head, "
        f"{n / 1e9:.2f} B parameters; batch {B} x {S}, {ccfg.optimizer}) step 1, card vs CPU: "
        f"loss {float(m_card['loss']):.6f} vs {float(m_cpu['loss']):.6f} (|d| {held['loss']:.3g}, "
        f"tolerance {LM_TRAIN_LOSS_TOL}); grad norm {float(m_card['grad_norm']):.6g} vs "
        f"{float(m_cpu['grad_norm']):.6g} (rel {held['norm']:.3g}, tolerance {LM_TRAIN_NORM_TOL}); "
        f"gradients {held['grads']:.4g} of each leaf's max (tolerance {LM_TRAIN_GRAD_TOL:.4g}); "
        f"the card's update on the CPU's gradients: parameters max |d| {held['params']:.3g} "
        f"(within one bf16 unit), m and v {held['opt']:.3g} of their max (tolerance 1e-6); the "
        f"whole steps' parameters differ by more than one bf16 unit in {off} of {n} entries, at "
        f"|g| <= {off_g:.3g} of the leaf's max"
        + (f"; tokens routed to other experts at a near tie: {moved} of "
           f"{sum(r.top.shape[0] * r.top.shape[1] for r in routes)} (the CPU replays the card's "
           f"routing)" if ccfg.is_moe else "")
        + f"; card {t_card:.2f} s, CPU {t_cpu:.2f} s")
    del st_cpu, m_cpu, params_cpu

    # Remat and reruns on the card: loss and every gradient bit-equal.
    def run(**kw):
        c = dataclasses.replace(ccfg, **kw)
        return trainer._grads(functools.partial(tfm.loss_fn, c), params, batch)

    base = run(remat=True, remat_policy="nothing")
    same = {}
    for name, kw in (("rerun", dict(remat=True, remat_policy="nothing")),
                     ("dots", dict(remat=True, remat_policy="dots")), ("no remat", dict(remat=False))):
        loss, grads = run(**kw)
        same[name] = torch.equal(loss, base[0]) and all(torch.equal(grads[k], base[1][k]) for k in grads)
        del grads
    if not all(same.values()):
        raise AssertionError(f"[lm_train] {arch} compact: loss and gradients not bit-equal: {same}")
    log(f"[lm_train] {arch} compact on the card: loss {float(base[0]):.6f} and every gradient "
        f"bit-equal across remat 'nothing', a rerun, 'dots' and no remat")
    del base

    if arch in LM_TRAIN_CKPT:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        d = tempfile.mkdtemp(prefix="lm_train_ckpt_", dir=os.path.join(ROOT, "build"))
        try:
            t0 = time.perf_counter()
            path = checkpoint.save_checkpoint(d, 1, st_card, extra={"step": 1})
            t_save = time.perf_counter() - t0
            template = tree_map(lambda _, t: torch.empty_like(t), st_card)
            t0 = time.perf_counter()
            restored, extra = checkpoint.restore_checkpoint(d, template)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            want = dict(tree_items(st_card))
            bad = [k for k, t in tree_items(restored)
                   if t.dtype != want[k].dtype or not torch.equal(t, want[k])]
            if bad or extra != {"step": 1}:
                raise AssertionError(f"[lm_train] {arch} checkpoint: restored leaves differ: {bad[:5]}")
            log(f"[lm_train] {arch} compact train state ({len(want)} leaves, bfloat16 parameters, "
                f"float32 m and v; {_gib(os.path.getsize(path))} on disk) saved in {t_save:.1f} s and "
                f"restored in {t_restore:.1f} s through train/checkpoint.py: bit-equal")
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return {"held": held, "moved": moved, "t_cpu": t_cpu}


def _lm_train_full(arch: str, cfg, card: str) -> dict:
    """Full width at the train_4k sequence length, depth and batch cut
    (printed): ``LM_TRAIN_STEPS`` steps through the train cell on one fixed
    batch; the loss must be finite and fall."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors

    shape = next(s for s in cfg.shapes if s.name == "train_4k")
    L, (B, mb), S = LM_TRAIN_LAYERS[arch], LM_TRAIN_BATCH, shape.seq_len
    fcfg = dataclasses.replace(cfg, n_layers=L)
    n_full = sum(t.numel() for t in tfm.abstract_params(cfg).values())
    n = sum(t.numel() for t in tfm.abstract_params(fcfg).values())
    held, peak_b = ADAMW_STEP_BYTES
    log(f"[lm_train] {arch} cuts: depth {cfg.n_layers} -> {L} layers"
        + (f" ({fcfg.n_dense_layers} dense + {fcfg.n_moe_layers} MoE)" if cfg.is_moe else "")
        + f": {n_full / 1e9:.2f} -> {n / 1e9:.2f} B parameters, a functional AdamW step "
        f"{_gib(peak_b * n_full)} -> {_gib(peak_b * n)} at {peak_b} B a parameter ({held} held "
        f"through the step) before activations; batch {shape.global_batch} / microbatch "
        f"{shape.microbatch} -> {B} / {mb}; sequence {S} as published; {fcfg.optimizer}, remat "
        f"'{fcfg.remat_policy}'")
    cell = make_cell(fcfg, dataclasses.replace(shape, global_batch=B, microbatch=mb))
    torch.cuda.reset_peak_memory_stats()
    state = cell.init_state(torch.Generator(device=DEVICE).manual_seed(SEED + 71), DEVICE)
    batch = as_tensors(_lm_train_batch(cfg.vocab_size, B, S, SEED + 71), DEVICE)
    losses, times = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = cell.step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del state, metrics
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[lm_train] {arch}: losses {losses} are not finite and falling")
    step_s = statistics.median(times[1:])
    bf16, f32 = _lm_train_ops(fcfg, B, S)
    bound = bf16 / _rf().BF16_FLOPS + f32 / _rf().F32_FLOPS
    log(f"[lm_train] {arch} {L} layers, batch {B} x {S} (microbatch {mb}), {LM_TRAIN_STEPS} steps "
        f"on one batch: loss " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step {step_s * 1e3:.1f} ms (median of steps 2-{LM_TRAIN_STEPS}; step 1 "
        f"{times[0] * 1e3:.1f} ms), {B * S / step_s:,.0f} tokens/s; peak {_gib(peak)} (reckoned "
        f"{_gib(peak_b * n)} before activations); bound {bound * 1e3:.1f} ms (bf16 {bf16:.4g} FLOP "
        f"/ 989 TFLOP/s = {bf16 / _rf().BF16_FLOPS * 1e3:.1f} ms + f32 attention {f32:.4g} FLOP / "
        f"67 TFLOP/s = {f32 / _rf().F32_FLOPS * 1e3:.1f} ms), {step_s / bound:.2f}x the bound; {card}")
    _timed(f"{arch} train {L} layers {B}x{S}", fcfg, cell.shape, step_s * 1e3, bound * 1e3)
    return {"step_ms": step_s * 1e3, "tokens_s": B * S / step_s, "peak": peak,
            "bound_ms": bound * 1e3, "losses": losses, "reckoned": peak_b * n}


def _lm_train_launcher() -> None:
    """``launch.train --arch qwen3-4b --steps 4 --ckpt-every 2`` on the card
    (smoke config, bfloat16 leaves in its checkpoints), then again with
    ``--steps 6``: it must resume from step 4."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="lm_train_launch_", dir=os.path.join(ROOT, "build"))
    try:
        args = ["--arch", "qwen3-4b", "--ckpt-every", "2", "--ckpt-dir", d, "--device", DEVICE]
        outs = []
        for steps in ("4", "6"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train.main([*args, "--steps", steps])
            outs.append(buf.getvalue())
        if "resumed" in outs[0] or "resumed from step 4" not in outs[1] or "step    5" not in outs[1]:
            raise AssertionError(f"[lm_train] launch.train did not resume: {outs}")
        ckpts = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"[lm_train] launch.train --arch qwen3-4b --steps 4 --ckpt-every 2 on the card, then "
        f"--steps 6: resumed from step 4 (checkpoints {', '.join(ckpts)}); "
        + outs[1].strip().splitlines()[-2].strip())


def phase_lm_train(card: str) -> dict:
    """The LM training path: Qwen3-4B and DeepSeek-MoE-16B, a compact copy
    of each against the CPU port, then full width with the depth cut; the
    launcher with a resume. Adds no forest kernel launch."""
    import gc

    import torch

    from repro_torch.configs import get_config

    sys.path.insert(0, os.path.join(ROOT, "tests"))   # lm_parity: the routing rule
    t_phase = time.perf_counter()
    before = kernel_launches()
    results = {}
    for arch in LM_FULL:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        results[arch] = {"compact": _lm_train_compact(arch, cfg)}
        gc.collect()
        torch.cuda.empty_cache()
        results[arch]["full"] = _lm_train_full(arch, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    _lm_train_launcher()
    if kernel_launches() != before:
        raise AssertionError(f"[lm_train] the LM path launched ranking kernels: {kernel_launches()}")
    seconds = time.perf_counter() - t_phase
    log(f"[lm_train] done in {seconds:.1f} s on {card}")
    q, d = results["qwen3-4b"]["full"], results["deepseek-moe-16b"]["full"]
    summary = (f"lm_train: qwen3-4b {LM_TRAIN_LAYERS['qwen3-4b']} layers {q['step_ms']:.0f} ms/step "
               f"({q['tokens_s']:,.0f} tokens/s, peak {_gib(q['peak'])}); deepseek-moe-16b "
               f"{LM_TRAIN_LAYERS['deepseek-moe-16b']} layers {d['step_ms']:.0f} ms/step "
               f"({d['tokens_s']:,.0f} tokens/s, peak {_gib(d['peak'])})")
    return {"results": results, "summary": summary, "seconds": seconds}


# The [nequip] phase: the full config (5 layers, d_hidden 32, l_max 2,
# n_rbf 8, cutoff 5.0) at its published graph shapes. Card against the CPU
# port in float32: relative to each compared tensor's largest |value|.
NEQUIP_TOL = 1e-4
# Rotation: tests/test_property.py's tolerances (energy rtol, atol; forces rtol, atol).
NEQUIP_ROT_TOL = (2e-4, 2e-5, 2e-3, 2e-4)


def _nequip_terms(cfg, params, batch, with_forces: bool) -> dict:
    """Energies, forces, loss and every gradient of one batch."""
    import functools

    from repro_torch.models import nequip
    from repro_torch.train import trainer

    e = nequip.forward_energy(cfg, params, batch["positions"], batch["species"], batch["edge_src"],
                              batch["edge_dst"], batch.get("graph_id"),
                              int(batch["energy"].shape[0]), batch.get("node_feat"))
    loss, grads = trainer._grads(
        functools.partial(nequip.loss_fn, cfg, with_forces=with_forces), params, batch)
    out = {"energy": e.detach(), "loss": loss, **{f"grad {k}": g for k, g in grads.items()}}
    if with_forces:
        out["forces"] = nequip.forces(cfg, params, batch)
    return out


def _nequip_molecule(cfg, card: str) -> dict:
    """``molecule`` (with forces), on a batch of its shape built as 128
    molecules of 30 atoms and 64 edges with ghost padding
    (tests/nequip_parity.py; the cell's synthesized inputs pile ~270 edges
    on each of 30 nodes, where float32 forces lose the reference's own
    rotation tolerance): energies, forces, loss and every gradient on the
    card against the CPU port; a rerun on the card bit-equal; rotation
    equivariance on the card; one train step through the cell."""
    import numpy as np
    import torch

    from nequip_parity import molecule_batch
    from repro_torch.models import nequip, so3
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors

    shape = next(s for s in cfg.shapes if s.name == "molecule")
    cell = make_cell(cfg, shape)
    specs = cell.input_specs()
    raw = molecule_batch(shape.graph_batch, shape.n_nodes, shape.n_edges,
                         specs["positions"].shape[0], specs["edge_src"].shape[0],
                         cfg.n_species, SEED + 80)
    params = nequip.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 80), DEVICE)
    batch = as_tensors(raw, DEVICE)
    t0 = time.perf_counter()
    card_t = _nequip_terms(cfg, params, batch, True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu_t = _nequip_terms(cfg, {k: v.cpu() for k, v in params.items()}, as_tensors(raw, "cpu"), True)
    errs = {k: _rel_max(card_t[k], cpu_t[k]) for k in cpu_t}
    worst = max(errs, key=errs.get)
    if not errs[worst] <= NEQUIP_TOL:
        raise AssertionError(f"[nequip] molecule card vs CPU: {worst} {errs[worst]:.4g} > {NEQUIP_TOL}")
    again = _nequip_terms(cfg, params, batch, True)
    rerun_equal = all(torch.equal(again[k], card_t[k]) for k in card_t)
    if not all(bool(torch.isfinite(t).all()) for t in card_t.values()):
        raise AssertionError("[nequip] molecule: non-finite values")
    # Rotation: E(R x) = E(x) and F(R x) = R F(x).
    R = torch.as_tensor(so3._random_rotation(np.random.default_rng(SEED + 81)).astype(np.float32),
                        device=DEVICE)
    rot = dict(batch, positions=batch["positions"] @ R.T)
    e1, e2 = card_t["energy"], nequip.forward_energy(
        cfg, params, rot["positions"], rot["species"], rot["edge_src"], rot["edge_dst"],
        rot["graph_id"], int(rot["energy"].shape[0]))
    f1, f2 = card_t["forces"], nequip.forces(cfg, params, rot)
    rt_e, at_e, rt_f, at_f = NEQUIP_ROT_TOL
    e_err = float((e2 - e1).abs().max())
    f_err = float((f2 - f1 @ R.T).abs().max())
    torch.testing.assert_close(e2, e1, rtol=rt_e, atol=at_e)
    torch.testing.assert_close(f2, f1 @ R.T, rtol=rt_f, atol=at_f)
    ms, (state, metrics) = _events_ms(
        lambda: cell.step(cell.init_state(SEED + 82, DEVICE), batch), 1)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("[nequip] molecule step: non-finite loss")
    N, E = batch["positions"].shape[0], batch["edge_src"].shape[0]
    log(f"[nequip] molecule (N {N}, E {E}: {shape.graph_batch} molecules of {shape.n_nodes} atoms "
        f"and {shape.n_edges} edges, ghost padding; forces): card vs CPU, relative to each "
        f"tensor's max: energy {errs['energy']:.3g}, forces {errs['forces']:.3g}, loss "
        f"{errs['loss']:.3g}, gradients {max(v for k, v in errs.items() if k.startswith('grad')):.3g} "
        f"(worst {worst}; tolerance {NEQUIP_TOL}); card {t_card:.2f} s; rerun on the card "
        f"bit-equal: {rerun_equal}; rotation: max |dE| {e_err:.3g}, max |dF| {f_err:.3g} "
        f"(rtol/atol {rt_e}/{at_e}, {rt_f}/{at_f}); one train step {ms:.1f} ms (with init), "
        f"loss {float(metrics['loss']):.5g}; {card}")
    return {"errs": errs, "rerun_equal": rerun_equal, "rot": (e_err, f_err)}


def _nequip_message_bytes(cfg, n_edges: int) -> int:
    """One layer's float32 messages: every path's ``[E, mul, 2·l3 + 1]``."""
    from repro_torch.models import so3

    return n_edges * cfg.d_hidden * sum(2 * l3 + 1 for *_, l3 in so3.allowed_paths(cfg.l_max)) * 4


def _nequip_big(cfg, name: str, card: str, steps: int) -> dict:
    """``name`` at its published size: ``steps`` train steps on one batch
    (the first is the warm one), step time and peak; the loss must be
    finite. Also reports whether two loss-and-gradient runs are bit-equal."""
    import torch

    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    shape = next(s for s in cfg.shapes if s.name == name)
    cell = make_cell(cfg, shape)
    with_forces = bool(shape.graph_batch)
    t0 = time.perf_counter()
    batch = as_tensors(synthesize_inputs(cell, seed=SEED + 83), DEVICE)
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    state = cell.init_state(SEED + 83, DEVICE)
    times, losses = [], []
    for _ in range(steps):
        ms, (state, metrics) = _events_ms(lambda: cell.step(state, batch), 1)
        times.append(ms)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"[nequip] {name}: losses {losses}")
    a, b = (_nequip_terms(cfg, state.params, batch, with_forces) for _ in range(2))
    rerun_equal = all(torch.equal(a[k], b[k]) for k in a)
    del a, b, state
    N, E = batch["positions"].shape[0], batch["edge_src"].shape[0]
    step_ms = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"[nequip] {name} (N {N}, E {E}, d_feat {shape.d_feat}"
        + (f", {shape.graph_batch} graphs, forces and the double backward" if with_forces else ", no forces")
        + f"; messages {_gib(_nequip_message_bytes(cfg, E))} a layer): {steps} step(s), step "
        f"{step_ms:.1f} ms" + (f" (after a first of {times[0]:.1f} ms)" if steps > 1 else "")
        + ", loss " + " -> ".join(f"{x:.5g}" for x in losses)
        + f"; peak {_gib(peak)}; inputs drawn in {t_data:.1f} s; two loss-and-gradient runs "
        f"bit-equal: {rerun_equal}; {card}")
    return {"step_ms": step_ms, "peak": peak, "rerun_equal": rerun_equal, "losses": losses}


def phase_nequip(card: str) -> dict:
    """NequIP at the full config: molecule against the CPU port with
    forces and rotation; minibatch_lg (forces, double backward) and
    full_graph_sm trained; ogb_products by shape on ``meta``."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.utils import tree_items

    sys.path.insert(0, os.path.join(ROOT, "tests"))   # nequip_parity: the molecule batch
    t_phase = time.perf_counter()
    before = kernel_launches()
    cfg = get_config("nequip")
    log(f"[nequip] {cfg.name}: {cfg.n_layers} layers, d_hidden {cfg.d_hidden}, l_max {cfg.l_max}, "
        f"n_rbf {cfg.n_rbf}, cutoff {cfg.cutoff}, {cfg.dtype}; segment sums by index_put "
        f"(accumulate, sorted) on the card")
    out = {"molecule": _nequip_molecule(cfg, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["minibatch_lg"] = _nequip_big(cfg, "minibatch_lg", card, 2)
    gc.collect()
    torch.cuda.empty_cache()
    out["full_graph_sm"] = _nequip_big(cfg, "full_graph_sm", card, 1)
    ogb = next(s for s in cfg.shapes if s.name == "ogb_products")
    cell = make_cell(cfg, ogb)
    state, specs = cell.abstract_state(), cell.input_specs()
    if any(t.device.type != "meta" for _, t in tree_items(state)):
        raise AssertionError("[nequip] ogb_products: state not on meta")
    E = specs["edge_src"].shape[0]
    log(f"[nequip] ogb_products by shape only, on meta: N {specs['positions'].shape[0]}, E {E}, "
        f"d_feat {ogb.d_feat}; {sum(t.numel() for t in state.params.values()):,} parameters; "
        f"messages {_gib(_nequip_message_bytes(cfg, E))} a layer")
    if kernel_launches() != before:
        raise AssertionError(f"[nequip] launched ranking kernels: {kernel_launches()}")
    seconds = time.perf_counter() - t_phase
    log(f"[nequip] done in {seconds:.1f} s on {card}")
    m = out["minibatch_lg"]
    summary = (f"nequip: minibatch_lg {m['step_ms']:.0f} ms/step, peak {_gib(m['peak'])}; "
               f"molecule card vs CPU {max(out['molecule']['errs'].values()):.2g}")
    return {"results": out, "summary": summary, "seconds": seconds}


# ---------------------------------------------------------------------------
# [parallel_train]: every family's train step on the (1, 1) mesh under the
# rules, the sparse-row reduction and BERT4Rec's whole-batch count.
# ---------------------------------------------------------------------------

PT_STEPS = 3              # steps each way; the median of steps 2-3 is timed
PT_SHARES = (2, 8)        # rank shares of DLRM-RM2's batch reduced as sparse rows
PT_TOL = 1e-6             # (b) and (c): of each gradient's max / of the loss
PT_CHUNK = 1 << 26        # elements a digest reads at a time


def _digest(t) -> int:
    """A weighted sum of ``t``'s bit patterns (int64, wrapping): two
    tensors of one shape and dtype with equal digests are, but for a
    collision, bit-equal. Reads ``PT_CHUNK`` elements at a time."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    flat = t.detach().contiguous().view(-1).view(bits)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), PT_CHUNK):
        part = flat[lo:lo + PT_CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + part.numel(), device=t.device, dtype=torch.int64)
        total += (part * (w * 2654435761 % 4294967291 + 1)).sum()
    return int(total)


def _pt_cases():
    """(label, arch, config, shape, seed): [cells]' recsys train shapes,
    [nequip]'s minibatch_lg and [lm_train]'s depth-cut train_4k."""
    from repro_torch.configs import get_config

    for arch in CELL_RECSYS:
        shape = next(s for s in _cell_shapes(arch) if s.kind == "train")
        yield f"{arch} {shape.name} B={shape.batch}", arch, get_config(arch), shape, SEED
    cfg = get_config("nequip")
    shape = next(s for s in cfg.shapes if s.name == "minibatch_lg")
    yield "nequip minibatch_lg (forces)", "nequip", cfg, shape, SEED + 83
    for arch in LM_FULL:
        cfg = get_config(arch)
        shape = next(s for s in cfg.shapes if s.name == "train_4k")
        (B, mb), L = LM_TRAIN_BATCH, LM_TRAIN_LAYERS[arch]
        yield (f"{arch} train_4k {L} layers {B}x{shape.seq_len}", arch,
               dataclasses.replace(cfg, n_layers=L),
               dataclasses.replace(shape, global_batch=B, microbatch=mb), SEED + 71)


def _pt_steps(cell, make_state, batch, mesh, rules) -> tuple[list, list, int, dict]:
    """``PT_STEPS`` steps from ``make_state()`` (under ``rules`` on
    ``mesh`` when given; no reference to a state outlives its step):
    per-step device times, losses and grad norms, the peak memory of the
    steps, and the final state's digests by path."""
    import contextlib

    import torch

    from repro_torch.distributed import sharding_rules
    from repro_torch.utils import tree_items

    ctx = sharding_rules(rules, mesh) if mesh is not None else contextlib.nullcontext()
    times, seen = [], []
    state = make_state()
    torch.cuda.reset_peak_memory_stats()
    with ctx:
        for _ in range(PT_STEPS):
            ms, (state, m) = _events_ms(lambda: cell.step(state, batch), 1)
            times.append(ms)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated()
    return times, seen, peak, {k: _digest(t) for k, t in tree_items(state)}


def _pt_family(label, arch, cfg, shape, seed, mesh, rules, card) -> dict:
    """(a) for one cell: ``PT_STEPS`` steps without rules, then from the
    same init under the rules on the (1, 1) mesh (an LM's state placed by
    remesh as DTensors): losses, norms and every leaf of the final state
    bit-equal; both timed."""
    import gc

    import torch

    from repro_torch.configs.base import TransformerConfig
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh

    cell = make_cell(cfg, shape)
    lm = isinstance(cfg, TransformerConfig)
    raw = (_lm_train_batch(cfg.vocab_size, shape.global_batch, shape.seq_len, seed) if lm
           else synthesize_inputs(cell, seed=seed))
    batch = as_tensors(raw, DEVICE)
    init = lambda: cell.init_state(torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    plain_ms, plain, plain_peak, want = _pt_steps(cell, init, batch, None, None)
    gc.collect()
    torch.cuda.empty_cache()
    placed = [""]

    def placed_init():
        t0 = time.perf_counter()
        # RecSys and NequIP: each rank cuts its shards from its own init (a
        # scatter would copy DLRM-RM2's 45.56 GB of tables); they step on
        # their local shards.
        state = remesh(init(), cell.state_logical(), rules, mesh,
                       src_data_rank=0 if lm else None)
        torch.cuda.synchronize()
        placed[0] = (f"DTensors placed by remesh in {time.perf_counter() - t0:.2f} s"
                     + ("" if lm else ", stepped on their local shards"))
        return state

    mesh_ms, ruled, peak, got = _pt_steps(cell, placed_init, batch, mesh, rules)
    gc.collect()
    torch.cuda.empty_cache()
    differ = sorted(k for k in want if got.get(k) != want[k])
    a, b = statistics.median(plain_ms[1:]), statistics.median(mesh_ms[1:])
    log(f"[parallel_train] (a) {label}: {placed[0]}; {PT_STEPS} steps, loss "
        + " -> ".join(f"{x:.6g}" for x, _ in ruled)
        + f"; losses and norms bit-equal {ruled == plain}; {len(want)} leaves of the state, "
        f"{len(want) - len(differ)} bit-equal (digests); step {b:.2f} ms under the rules vs "
        f"{a:.2f} ms without (median of steps 2-{PT_STEPS}, CUDA events), overhead "
        f"{(b / a - 1) * 100:+.1f}%; peak {_gib(peak)} under the rules vs {_gib(plain_peak)} "
        f"without; {card}")
    if ruled != plain or differ:
        raise AssertionError(f"[parallel_train] {label}: differs without rules: {differ[:5]} "
                             f"{ruled} vs {plain}")
    if not all(math.isfinite(x) for x, _ in ruled):
        raise AssertionError(f"[parallel_train] {label}: losses {ruled}")
    return {"ms": b, "plain_ms": a, "peak": peak, "plain_peak": plain_peak}


def _pt_sparse_rows(card: str) -> dict:
    """(b): DLRM-RM2's train batch of 65,536 at full width cut into 2 and 8
    rank shares in one process; each share's coalesced gradients of its
    mean loss, reduced by ``reduce_sparse_rows`` (dense ones averaged).
    A hot row sums ~20,000 float32 terms, so the one-process gradient is
    itself some 3e-6 of its leaf's max from the exact sum of its terms: a
    table's reduced rows must be no farther from the float64 sum of the
    whole batch's terms than the one-process rows are, plus PT_TOL of the
    leaf's max; a dense leaf within PT_TOL of the one-process gradient; two
    runs of the shares bit-equal."""
    import functools
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import recsys
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import trainer

    cfg = get_config("dlrm-rm2")
    shape = next(s for s in _cell_shapes("dlrm-rm2") if s.kind == "train")
    cell = make_cell(cfg, shape)
    params = cell.init_state(SEED, device=DEVICE).params
    batch = as_tensors(synthesize_inputs(cell, seed=SEED), DEVICE)
    loss_fn = functools.partial(recsys.loss_fn, cfg, sparse_grad=True)

    def grads(b):
        return trainer._grads(loss_fn, params, b)[1]

    def coalesced(g):
        return {k: v.coalesce() if v.is_sparse else v for k, v in g.items()}

    raw = grads(batch)
    exact = {k: torch.sparse_coo_tensor(v._indices(), v._values().double(), v.shape).coalesce()
             for k, v in raw.items() if v.is_sparse}
    whole = coalesced(raw)
    del raw
    B, out = shape.batch, {}
    for n in PT_SHARES:
        runs = []
        for _ in range(2):
            parts = [coalesced(grads({k: v[r * B // n:(r + 1) * B // n] for k, v in batch.items()}))
                     for r in range(n)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            red = {k: trainer.reduce_sparse_rows([p[k] for p in parts], n) if g.is_sparse
                   else sum(p[k] for p in parts) / n for k, g in whole.items()}
            torch.cuda.synchronize()
            t_red = time.perf_counter() - t0
            runs.append(red)
            del parts
        got, rows, worst = runs[0], 0, {"diff": 0.0, "reduced": 0.0, "one": 0.0, "dense": 0.0}
        for k, want in whole.items():
            scale = float((want.values() if want.is_sparse else want).abs().max())
            if not want.is_sparse:
                worst["dense"] = max(worst["dense"], float((got[k] - want).abs().max()) / scale)
                continue
            if not torch.equal(got[k].indices(), want.indices()):
                raise AssertionError(f"[parallel_train] (b) {n} shares: {k} rows differ")
            rows += want._nnz()
            e_red = float((got[k].values().double() - exact[k].values()).abs().max()) / scale
            e_one = float((want.values().double() - exact[k].values()).abs().max()) / scale
            diff = float((got[k].values() - want.values()).abs().max()) / scale
            worst = {**worst, "diff": max(worst["diff"], diff),
                     "reduced": max(worst["reduced"], e_red), "one": max(worst["one"], e_one)}
            if e_red > e_one + PT_TOL:
                raise AssertionError(f"[parallel_train] (b) {n} shares: {k} {e_red} from the "
                                     f"exact sum, the one-process gradient {e_one}")
        again = all(torch.equal(runs[0][k].values() if g.is_sparse else runs[0][k],
                                runs[1][k].values() if g.is_sparse else runs[1][k])
                    for k, g in whole.items())
        log(f"[parallel_train] (b) dlrm-rm2 B={B} in {n} shares: {rows:,} touched table rows "
            f"reduced by reduce_sparse_rows in {t_red * 1e3:.1f} ms; of each leaf's max, the "
            f"tables' largest distance from the float64 sum of the whole batch's terms "
            f"{worst['reduced']:.3g} (the one-process gradient's {worst['one']:.3g}), from the "
            f"one-process rows {worst['diff']:.3g}; dense leaves {worst['dense']:.3g} from the "
            f"one-process gradient; two runs bit-equal {again}; {card}")
        if worst["dense"] > PT_TOL or not again:
            raise AssertionError(f"[parallel_train] (b) {n} shares: {worst}, rerun {again}")
        out[n] = worst
        del runs, got
    del params, whole, exact
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pt_masked_count(card: str) -> float:
    """(c): BERT4Rec's train batch (the [cells] cut) with an uneven mask
    (the first half of the rows fully masked, the second one position
    each) in 2 shares: each share's loss divides by the whole batch's count
    and is weighted by 2, as under a two-rank split; their mean is the
    one-process loss within PT_TOL."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import recsys
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    cfg = get_config("bert4rec")
    shape = next(s for s in _cell_shapes("bert4rec") if s.kind == "train")
    cell = make_cell(cfg, shape)
    params = cell.init_state(SEED, device=DEVICE).params
    raw = synthesize_inputs(cell, seed=SEED)
    B, S = raw["mask_pos"].shape
    raw["mask_pos"][:] = 0.0
    raw["mask_pos"][: B // 2] = 1.0
    raw["mask_pos"][B // 2:, S // 2] = 1.0
    batch = as_tensors(raw, DEVICE)
    with torch.no_grad():
        whole = float(recsys.bert4rec_masked_loss(cfg, params, batch))
        total = batch["mask_pos"].sum()
        shares = [{k: v[r * B // 2:(r + 1) * B // 2] for k, v in batch.items()} for r in range(2)]
        own = recsys.batch_total
        try:   # the two-rank split's count: the whole batch's, for n = 2
            recsys.batch_total = lambda x: (total, 2)
            split = [float(recsys.bert4rec_masked_loss(cfg, params, b)) for b in shares]
        finally:
            recsys.batch_total = own
        quotients = [float(recsys.bert4rec_masked_loss(cfg, params, b)) for b in shares]
    got, parent = sum(split) / 2, sum(quotients) / 2
    err = abs(got - whole) / abs(whole)
    log(f"[parallel_train] (c) bert4rec B={B} uneven mask ({int(total)} masked) in 2 shares: "
        f"share-weighted loss {got:.7f}, one-process {whole:.7f} (relative error {err:.3g}); "
        f"the mean of the shares' own quotients would be {parent:.7f}; {card}")
    if err > PT_TOL:
        raise AssertionError(f"[parallel_train] (c): {got} vs {whole}")
    return err


def phase_parallel_train(card: str) -> dict:
    """[parallel_train]: (a) every family's train step under
    single_pod_rules on make_local_mesh(cuda:0) bit-equal to the step
    without rules, both timed; (b) the sparse-row reduction at DLRM-RM2
    full width; (c) BERT4Rec's whole-batch masked count."""
    import torch.distributed as dist

    from repro_torch.distributed import single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    before = kernel_launches()
    mesh, rules = make_local_mesh(DEVICE), single_pod_rules()
    log(f"[parallel_train] mesh {mesh} (backend {dist.get_backend(mesh.get_group('data'))}), "
        f"single_pod_rules")
    times = {}
    try:
        for label, arch, cfg, shape, seed in _pt_cases():
            times[arch] = _pt_family(label, arch, cfg, shape, seed, mesh, rules, card)
        shares = _pt_sparse_rows(card)
        count_err = _pt_masked_count(card)
    finally:
        dist.destroy_process_group()
    if kernel_launches() != before:
        raise AssertionError(f"[parallel_train] launched ranking kernels: {kernel_launches()}")
    seconds = time.perf_counter() - t_phase
    log(f"[parallel_train] done in {seconds:.1f} s on {card}")
    over = ", ".join(f"{a} {(t['ms'] / t['plain_ms'] - 1) * 100:+.1f}%" for a, t in times.items())
    reduced = " / ".join(f"{e['reduced']:.2g}" for e in shares.values())
    summary = (f"parallel_train: {len(times)} cells bit-equal on the (1, 1) mesh "
               f"(overhead {over}); sparse rows in 2 / 8 shares {reduced} from the exact sum "
               f"(one process {next(iter(shares.values()))['one']:.2g}); "
               f"bert4rec split count {count_err:.2g}")
    return {"summary": summary, "seconds": seconds}


# ---------------------------------------------------------------------------
# [parallel_serve]: every serving cell's sharded step on a one-rank mesh.
# ---------------------------------------------------------------------------

PS_STEPS = 3                  # timed after one warm step each way; the median is printed
PS_LM_LAYERS = {"qwen3-4b": 4, "deepseek-moe-16b": 2}   # depth cut (DeepSeek: dense + 1 MoE)
PS_PREFILL = (1, 4096)        # batch, tokens
PS_DECODE_CACHE = 32768       # tokens of the decode cache; batches as [lm]'s


def _ps_equal(got, want) -> bool:
    """Whether two output trees (tensors, tuples, dicts; ``DTensor``
    leaves compared by their whole value) are bit-equal."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(want, dict):
        return all(_ps_equal(got[k], v) for k, v in want.items())
    if isinstance(want, (tuple, list)):
        return all(_ps_equal(a, b) for a, b in zip(got, want, strict=True))
    if isinstance(got, DTensor):
        got = got.full_tensor()
    return got.dtype == want.dtype and torch.equal(got, want)


def _ps_pair(label, cell, params, inputs, mesh, rules, card, placed_inputs=None) -> dict:
    """The step without rules on ``params``, then under the rules on the
    (1, 1) mesh on ``params`` placed by ``remesh`` (and on
    ``placed_inputs()`` where given: a decode step's caches): one warm step
    and ``PS_STEPS`` timed each way; the outputs bit-equal and the forest
    kernel launched as often."""
    from repro_torch.distributed import sharding_rules
    from repro_torch.train import remesh

    def run(state, inp, ctx):
        before = kernel_launches()
        with ctx:
            cell.step(state, inp)
            ms, out = _events_ms(lambda: cell.step(state, inp), PS_STEPS)
        after = kernel_launches()
        return ms, out, {k: after[k] - before.get(k, 0) for k in after}

    plain_ms, want, plain_n = run(params, inputs, contextlib.nullcontext())
    t0 = time.perf_counter()
    placed = remesh(params, cell.state_logical(), rules, mesh, src_data_rank=None)
    place_s = time.perf_counter() - t0
    inp = placed_inputs() if placed_inputs is not None else inputs
    ms, got, n = run(placed, inp, sharding_rules(rules, mesh))
    equal = _ps_equal(got, want)
    log(f"[parallel_serve] {label}: placed by remesh in {place_s:.2f} s"
        + (", inputs placed too" if placed_inputs is not None else "")
        + f"; outputs bit-equal {equal}; step {ms:.3f} ms under the rules vs {plain_ms:.3f} ms "
        f"without (median of {PS_STEPS} after one warm step, CUDA events), overhead "
        f"{(ms / plain_ms - 1) * 100:+.1f}%; forest kernel launches {sum(n.values())} vs "
        f"{sum(plain_n.values())}; {card}")
    if not equal or n != plain_n:
        raise AssertionError(f"[parallel_serve] {label}: bit-equal {equal}, launches {n} vs "
                             f"{plain_n}")
    return {"ms": ms, "plain_ms": plain_ms, "launches": n}


def _ps_recsys(arch: str, mesh, rules, card) -> dict:
    """serve_p99 and retrieval_cand of one family at [cells]' shapes and
    full width, one init shared by both."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    cfg = get_config(arch)
    out, params = {}, None
    for shape in (s for s in _cell_shapes(arch) if s.name in ("serve_p99", "retrieval_cand")):
        cell = make_cell(cfg, shape)
        if params is None:
            params = cell.init_state(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        inputs = as_tensors(synthesize_inputs(cell, seed=SEED), DEVICE)
        size = (f"{inputs['cand_ids'].shape[0]:,} candidates" if shape.n_candidates
                else f"B={shape.batch}")
        out[shape.name] = _ps_pair(f"{arch} {shape.name} ({size}, full width)", cell, params,
                                   inputs, mesh, rules, card)
        del inputs
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ps_lm(arch: str, mesh, rules, card) -> dict:
    """Prefill and decode of one LM at full width and PS_LM_LAYERS' depth:
    prefill PS_PREFILL, decode at [lm]'s batch against a cache of
    PS_DECODE_CACHE tokens drawn on the card (the placed run on a clone of
    it, placed by remesh)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.train import remesh
    from repro_torch.train.trainer import serve_input_logical

    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=PS_LM_LAYERS[arch])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 91)
    params = tfm.init(cfg, gen, DEVICE)
    rng = np.random.default_rng(SEED + 91)
    shapes = {s.name: s for s in base.shapes}
    B, S = PS_PREFILL
    pre = make_cell(cfg, dataclasses.replace(shapes["prefill_32k"], seq_len=S, global_batch=B))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                             device=DEVICE)
    out = {"prefill": _ps_pair(f"{arch} prefill {B}x{S} ({cfg.n_layers} of {base.n_layers} "
                               f"layers)", pre, params, {"tokens": tokens}, mesh, rules, card)}
    Bd, T = LM_DECODE_BATCH[arch], PS_DECODE_CACHE
    dec = make_cell(cfg, dataclasses.replace(shapes["decode_32k"], seq_len=T, global_batch=Bd))
    caches = tfm.make_decode_caches(cfg, Bd, T, DEVICE)
    for t in (t for c in caches.values() for t in c.values()):
        t.normal_(generator=gen)
    copy = {n: {kv: t.clone() for kv, t in c.items()} for n, c in caches.items()}
    token = torch.as_tensor(rng.integers(0, cfg.vocab_size, (Bd, 1)).astype(np.int32),
                            device=DEVICE)
    pos = torch.tensor(T - 1, dtype=torch.int32)
    lg = serve_input_logical(dec.input_logical())["caches"]

    def placed_inputs():
        return {"token": token, "pos": pos,
                "caches": remesh(copy, lg, rules, mesh, src_data_rank=None)}

    out["decode"] = _ps_pair(f"{arch} decode B={Bd} at {T - 1} of a {T}-token cache "
                             f"({cfg.n_layers} layers)", dec, params,
                             {"token": token, "caches": caches, "pos": pos}, mesh, rules, card,
                             placed_inputs)
    del params, caches, copy
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ps_forest(mesh, rules, card) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs

    cfg = get_config("lear-msn1")
    shape = next(s for s in cfg.shapes if s.name == "rank_online")
    cell = make_cell(cfg, shape)
    params = cell.init_state(SEED, device=torch.device(DEVICE))
    inputs = as_tensors(synthesize_inputs(cell, seed=SEED), DEVICE)
    Q, D, _ = inputs["X"].shape
    out = _ps_pair(f"lear-msn1 rank_online ({Q} x {D})", cell, params, inputs, mesh, rules, card)
    if out["launches"].get("forest_score", 0) != 3 * (PS_STEPS + 1):
        raise AssertionError(f"[parallel_serve] lear-msn1: launches {out['launches']}")
    return out


def phase_parallel_serve(card: str) -> dict:
    """[parallel_serve]: every serving cell's step under single_pod_rules on
    make_local_mesh(cuda:0), its state placed by remesh, bit-equal to the
    step without rules, both timed: the four RecSys families' serve_p99
    and retrieval_cand at [cells]' shapes and full width, Qwen3-4B and
    DeepSeek-MoE-16B prefill and decode at PS_LM_LAYERS' depth, lear-msn1
    rank_online (its forest launches equal)."""
    import torch.distributed as dist

    from repro_torch.distributed import single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    mesh, rules = make_local_mesh(DEVICE), single_pod_rules()
    log(f"[parallel_serve] mesh {mesh} (backend {dist.get_backend(mesh.get_group('data'))}), "
        f"single_pod_rules")
    cells = {}
    try:
        for arch in CELL_RECSYS:
            for name, r in _ps_recsys(arch, mesh, rules, card).items():
                cells[f"{arch} {name}"] = r
        for arch in LM_FULL:
            for name, r in _ps_lm(arch, mesh, rules, card).items():
                cells[f"{arch} {name}"] = r
        forest = _ps_forest(mesh, rules, card)
        cells["lear-msn1 rank_online"] = forest
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    log(f"[parallel_serve] done in {seconds:.1f} s on {card}")
    over = ", ".join(f"{k} {(r['ms'] / r['plain_ms'] - 1) * 100:+.1f}%" for k, r in cells.items())
    return {"summary": f"parallel_serve: {len(cells)} serving cells bit-equal on the (1, 1) mesh "
                       f"in {seconds:.1f} s (overhead {over})",
            "launches": {"forest_score": forest["launches"].get("forest_score", 0),
                         "forest_score_segments": forest["launches"].get(
                             "forest_score_segments", 0)},
            "seconds": seconds}


# ---------------------------------------------------------------------------
# [placement]: the mesh placements of the serving path, and re-meshing.
# ---------------------------------------------------------------------------

PLACEMENT_SHARDS = (2, 8)        # data_parallel over cuda:0 named this many times
PLACEMENT_TIER_QUERIES = 50
PLACEMENT_HEADROOM = 8.0         # the tier check's capacity headroom: nothing overflows


def _placement_services(models, mode, n, headroom=None):
    """``n`` services over the [serve] models with sentinels (50, 150)."""
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    cfg, ranker, clfs = models
    kw = {"capacity_headroom": headroom} if headroom else {}
    return [
        RankingService(
            ranker, clfs[0],
            ServiceConfig(threshold=THRESHOLD, execution_mode=mode, launch_overhead_trees=512.0,
                          **kw),
            extra_classifiers=clfs[1:], device=DEVICE,
        )
        for _ in range(n)
    ]


def _placement_mode(models, mode: str, card: str) -> dict:
    """One mode: single_device(), local(), data_parallel() over the visible
    cards, and data_parallel over cuda:0 named 2 and 8 times, each on a
    fresh service warmed on GUARD_WARM batches, then GUARD_BATCHES batches
    under count_host_transfers: bit-equal to single_device()'s, one
    explicit read a batch and no implicit sync, each shard making the
    single batch's forest launches; then the same batches timed."""
    import numpy as np
    import torch

    from repro_torch.serve import placement
    from repro_torch.utils import count_host_transfers

    batches = _batches(models[0].n_features)[: GUARD_WARM + GUARD_BATCHES]
    runs = [("single_device()", placement.single_device()), ("local()", placement.local(DEVICE)),
            (f"data_parallel() ({torch.cuda.device_count()} visible)", placement.data_parallel())]
    runs += [(f"data_parallel([cuda:0] x {n})", placement.data_parallel(devices=[DEVICE] * n))
             for n in PLACEMENT_SHARDS]
    services = _placement_services(models, mode, len(runs))
    launches = no_launches()
    want = base = None
    cases, lines = set(), []
    for (label, pl), svc in zip(runs, services):
        for X, mask in batches[:GUARD_WARM]:
            svc.rank_batch(X, mask, placement=pl)
        torch.cuda.synchronize()
        reset_launches()
        with count_host_transfers() as counts:
            got = [svc.rank_batch(X, mask, placement=pl) for X, mask in batches[GUARD_WARM:]]
        torch.cuda.synchronize()
        n_launch = dict(kernel_launches())
        for name, k in n_launch.items():
            launches[name] += k
        t0 = time.perf_counter()
        for X, mask in batches[GUARD_WARM:]:
            svc.rank_batch(X, mask, placement=pl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / GUARD_BATCHES
        shards = pl.n_shards(Q)
        if want is None:
            want, base = got, n_launch
        equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(got, want))
        st = svc.stats
        lines.append(f"{label}: {shards} shard(s) of {Q // shards} x {D}, {ms:.3f} ms a batch, "
                     f"launches {n_launch}, explicit {counts.explicit_gets} implicit "
                     f"{counts.implicit_syncs}, bit-equal {equal}, overflow {st.overflow_docs}")
        if counts.explicit_gets != GUARD_BATCHES or counts.implicit_syncs or counts.sites:
            raise AssertionError(f"[placement] {mode} {label}: host reads {counts}")
        if not equal:
            raise AssertionError(f"[placement] {mode} {label}: differs from single_device()")
        if n_launch != {k: shards * v for k, v in base.items()} or not sum(base.values()):
            raise AssertionError(f"[placement] {mode} {label}: launches {n_launch} vs {base}")
        # The kernels' shapes on this path, for [kernels]: a shard's rows.
        rows = Q // shards * D
        for caps in st.capacities:
            cases.add(("range", 2, 3, min(caps[-1], rows)))
            if mode == "staged":
                cases.add(("range", 0, 1, rows))
                cases.add(("range", 1, 2, min(caps[0], rows)))
            else:
                cases.add(("segments", 0, 2, rows))
    log(f"[placement] {mode}, sentinels {SENTINELS_2}, {GUARD_BATCHES} batches of {Q} x {D} "
        f"after {GUARD_WARM} warm: " + "; ".join(lines) + f"; {card}")
    return {"launches": launches, "cases": cases}


def _placement_tier() -> dict:
    """A ServingTier on data_parallel over cuda:0 named twice: its health
    reports 2 devices; PLACEMENT_TIER_QUERIES queries under the guard, one
    explicit read a flushed batch; every response equal to the query served
    alone by a single-device service (headroom PLACEMENT_HEADROOM on both,
    so no capacity overflows and the shapes cannot matter)."""
    import numpy as np
    import torch

    from repro_torch.serve import BucketPolicy, ServingTier, TierConfig, placement
    from repro_torch.utils import count_host_transfers

    models = _models(DEVICE, SENTINELS_2)
    svc, alone = _placement_services(models, "fused", 2, PLACEMENT_HEADROOM)
    tier = ServingTier(
        svc, models[0].n_features, TierConfig(doc_counts=(D,)),
        policy=BucketPolicy(max_queries=Q, max_wait_ms=2.0, min_docs=8),
        placement=placement.data_parallel(devices=[DEVICE] * 2),
    ).start()
    rng = np.random.default_rng(SEED + 900)
    queries = [
        rng.normal(size=(int(rng.integers(D // 4, D + 1)), models[0].n_features)).astype(np.float32)
        for _ in range(PLACEMENT_TIER_QUERIES)
    ]
    n_devices = tier.health()["n_devices"]
    torch.cuda.synchronize()
    before = svc.stats.batches
    reset_launches()
    try:
        with count_host_transfers() as counts:
            futures = []
            for q in queries:
                futures.append(tier.submit(q))
                time.sleep(0.0005)
            results = [f.result(timeout=120) for f in futures]
    finally:
        tier.stop()
    launches = dict(kernel_launches())
    flushed = svc.stats.batches - before
    equal = all(
        np.array_equal(s, alone.rank_batch(q[None], np.ones((1, len(q)), bool))[1][0])
        for (_, s), q in zip(results, queries)
    )
    log(f"[placement] tier on data_parallel([cuda:0] x 2): health n_devices {n_devices}; "
        f"{PLACEMENT_TIER_QUERIES} queries in {flushed} flushed batches, explicit "
        f"{counts.explicit_gets} implicit {counts.implicit_syncs}; launches {launches}; "
        f"every response equal to the query served alone: {equal}; overflow "
        f"{svc.stats.overflow_docs}")
    if n_devices != 2 or not equal or svc.stats.overflow_docs:
        raise AssertionError("[placement] tier: devices, responses or overflow")
    if counts.explicit_gets != flushed or counts.implicit_syncs or not flushed:
        raise AssertionError(f"[placement] tier: {flushed} batches, host reads {counts}")
    return {"launches": launches}


def _placement_remesh(card: str) -> None:
    """Qwen3-4B's full-width parameters, drawn on the card, copied to host
    numpy and re-placed by remesh on make_local_mesh(cuda:0) (a one-rank
    NCCL group): every leaf bit-equal; then a one-rank NCCL all-reduce."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import single_pod_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import remesh

    cfg = get_config("qwen3-4b")
    params = tfm.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 90), DEVICE)
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    t0 = time.perf_counter()
    host = {k: t.cpu().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()
            for k, t in params.items()}
    t_host = time.perf_counter() - t0
    tree = {k: torch.from_numpy(a).view(params[k].dtype) for k, a in host.items()}
    mesh = make_local_mesh(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = remesh(tree, tfm.param_logical(cfg), single_pod_rules(), mesh)
    torch.cuda.synchronize()
    t_put = time.perf_counter() - t0
    equal = all(torch.equal(placed[k].to_local(), params[k]) for k in params)
    kinds = sorted({str(p) for d in placed.values() for p in d.placements})
    probe = torch.arange(8, dtype=torch.float32, device=DEVICE)
    dist.all_reduce(probe, group=mesh.get_group("data"))
    reduced = bool(torch.equal(probe.cpu(), torch.arange(8, dtype=torch.float32)))
    backend = dist.get_backend(mesh.get_group("data"))
    log(f"[placement] remesh: qwen3-4b, {len(params)} leaves, {_gib(n_bytes)} "
        f"({cfg.dtype}); card -> host numpy {t_host:.2f} s; remesh onto {mesh} "
        f"(backend {backend}) {t_put:.2f} s ({n_bytes / t_put / 1e9:.2f} GB/s); placements "
        f"{kinds}; every leaf bit-equal: {equal}; one-rank all-reduce exact: {reduced}; {card}")
    if not equal or not reduced:
        raise AssertionError("[placement] remesh: leaves or the all-reduce differ")
    del placed, tree, host, params
    dist.destroy_process_group()


def phase_placement(card: str) -> dict:
    """[placement] at lear-msn1 full width (the [serve] models, seed 0)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    models = _models(DEVICE, SENTINELS_2)
    launches = no_launches()
    cases = set()
    for mode in ("fused", "staged"):
        r = _placement_mode(models, mode, card)
        cases |= r["cases"]
        for name, n in r["launches"].items():
            launches[name] += n
    for name, n in _placement_tier()["launches"].items():
        launches[name] += n
    del models
    gc.collect()
    torch.cuda.empty_cache()
    _placement_remesh(card)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[placement] done in {seconds:.1f} s on {card}")
    summary = (f"placement: single_device, local and data_parallel x1/x{PLACEMENT_SHARDS} "
               f"bit-equal, fused and staged; a tier on 2 shards; qwen3-4b re-meshed bit-equal")
    return {"launches": launches, "cases": cases, "summary": summary}


# ---------------------------------------------------------------------------
# [dryrun]: the dry run of the hillclimb cells, and every timed step's
# chips=1 roofline beside its measured time.
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("lear-msn1", "rank_xl"), ("qwen2.5-14b", "train_4k"), ("nequip", "ogb_products"),
                ("dlrm-rm2", "train_batch"), ("dlrm-rm2", "retrieval_cand"),
                ("qwen3-4b", "decode_32k"))


def start_dryrun(out_dir: str) -> subprocess.Popen:
    """The dry run of DRYRUN_CELLS on the fake 16 x 16 mesh, in a process
    of its own (it traces on the host, with no card, while the card runs
    the other phases; the fake process group is process-wide)."""
    cells = ",".join(f"{a}:{s}" for a, s in DRYRUN_CELLS)
    code = ("import json, sys, time\n"
            "from repro_torch.launch import dryrun\n"
            "out = []\n"
            "for cell in sys.argv[2].split(','):\n"
            "    arch, shape = cell.split(':')\n"
            "    record, _ = dryrun.run_cell(arch, shape, multi_pod=False)\n"
            "    out.append(record)\n"
            "json.dump(out, open(sys.argv[1], 'w'))\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code, os.path.join(out_dir, "dryrun.json"),
                             cells], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def phase_dryrun(card: str, proc: subprocess.Popen, out_dir: str) -> dict:
    """The background dry run's records; then every step that [cells],
    [lm] and [lm_train] timed, traced on meta at its own config and shape:
    its chips=1 roofline beside the measured time and the phase's own
    bound. No measured time may be below its compute term."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.launch import op_analysis
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.api import make_cell

    t_phase = time.perf_counter()
    log_text, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"[dryrun] the dry run failed:\n{log_text[-4000:]}")
    with open(os.path.join(out_dir, "dryrun.json")) as f:
        records = json.load(f)
    for rec in records:
        r, m = rec["roofline"], rec["memory"]
        log(f"[dryrun] {rec['arch']} {rec['shape']} on the fake {rec['mesh']} ({rec['chips']} "
            f"ranks): trace {rec['trace_s']} s; per device {m['per_device_total_gib']} GiB; "
            f"compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, collective "
            f"{r['collective_s']:.4g} s ({r['coll_breakdown']}), dominant {r['dominant']}, "
            f"useful ratio {r['useful_ratio']:.3f}; divisibility problems "
            f"{len(rec['divisibility'])}"
            + (f"; activation collectives {rec['activation_collectives']}"
               if "activation_collectives" in rec else "")
            + (f"; by mesh axis {rec['activation_collectives_by_axis']}"
               if rec.get("activation_collectives_by_axis") else ""))
        if not all(math.isfinite(r[k]) and r[k] >= 0 for k in ("compute_s", "memory_s",
                                                               "collective_s")):
            raise AssertionError(f"[dryrun] {rec['arch']} {rec['shape']}: terms {r}")
    below = []
    for t in TIMED:
        t0 = time.perf_counter()
        tr, _ = trace_step(make_cell(t["cfg"], t["shape"]))
        model_flops = (rf.lm_model_flops(t["cfg"], t["shape"])
                       if isinstance(t["cfg"], TransformerConfig) else 0.0)
        r = rf.roofline(op_analysis.analyze(tr), chips=1, model_flops=model_flops)
        hand = "none" if t["hand_ms"] is None else f"{t['hand_ms']:.4g} ms"
        log(f"[dryrun] {t['label']}: measured {t['ms']:.4g} ms; chips=1 roofline: compute "
            f"{r.compute_s * 1e3:.4g} ms ({', '.join(f'{k} {v:.4g}' for k, v in r.flops_by_dtype.items())} "
            f"FLOP), memory {r.memory_s * 1e3:.4g} ms (printed, not held: L2 can beat an HBM "
            f"reckoning), bound {r.bound_s * 1e3:.4g} ms ({r.dominant}); the phase's own bound "
            f"{hand}; measured / compute {t['ms'] / 1e3 / max(r.compute_s, 1e-30):.2f}; traced "
            f"in {time.perf_counter() - t0:.1f} s")
        if t["ms"] / 1e3 < r.compute_s:
            below.append(t["label"])
    if below:
        raise AssertionError(f"[dryrun] measured below the compute term: {below}")
    if not TIMED:
        raise AssertionError("[dryrun] no timed step recorded")
    seconds = time.perf_counter() - t_phase
    log(f"[dryrun] done in {seconds:.1f} s on {card}")
    return {"summary": f"dryrun: {len(records)} cells on the fake 16x16 mesh; {len(TIMED)} "
                       f"timed steps, none below its compute term"}


# ---------------------------------------------------------------------------
# [examples]: the port's examples at smoke size on the card.
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart.py", "torch_serve_ranking.py", "torch_serve_progressive.py",
            "torch_cascade_retrieval.py", "torch_train_lm.py")
EXAMPLES_TIMEOUT_S = 240


def phase_examples(card: str) -> dict:
    """Each ``examples/torch_*.py --smoke`` in a process of its own, all at
    once, on the card (the examples' default device); any nonzero exit
    fails the phase."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name),
                                     "--smoke"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    failed = []
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=EXAMPLES_TIMEOUT_S)
            lines = [x for x in out.splitlines() if x.strip()]
            log(f"[examples] {name} --smoke: exit {p.returncode}; last line: "
                f"{lines[-1] if lines else '(none)'}")
            if p.returncode:
                failed.append(name)
                log(out[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t_phase
    log(f"[examples] {len(EXAMPLES) - len(failed)} of {len(EXAMPLES)} ran in {seconds:.1f} s "
        f"on {card}")
    if failed:
        raise AssertionError(f"[examples] failed: {failed}")
    return {"summary": f"examples: {len(EXAMPLES)} at smoke size in {seconds:.1f} s"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in float32 throughout, as the reference's do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t_start = time.perf_counter()
    dry_proc = None
    try:
        phase_build()
        card = card_line()
        elapsed = lambda name: log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")
        launches, tail_cases, serve_p50 = phase_serve()
        elapsed("serve")
        tier = phase_tier(card)
        for name, n in tier["launches"].items():
            launches[name] += n
        elapsed("tier")
        hybrid = phase_hybrid(card, _distill_on_card())
        for name, n in hybrid["launches"].items():
            launches[name] += n
        elapsed("hybrid")
        guards = phase_guards(card)
        for name, n in guards["launches"].items():
            launches[name] += n
        elapsed("guards")
        placement = phase_placement(card)
        for name, n in placement["launches"].items():
            launches[name] += n
        elapsed("placement")
        train = phase_train(card, serve_p50)
        for name, n in train["launches"].items():
            launches[name] += n
        elapsed("train")
        cells = phase_cells(card)
        for name, n in cells["launches"].items():
            launches[name] += n
        elapsed("cells")
        dry_dir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
        os.makedirs(dry_dir, exist_ok=True)
        dry_proc = start_dryrun(dry_dir)
        lm = phase_lm(card)
        elapsed("lm")
        lm_train = phase_lm_train(card)
        elapsed("lm_train")
        nequip = phase_nequip(card)
        elapsed("nequip")
        parallel_train = phase_parallel_train(card)
        elapsed("parallel_train")
        parallel_serve = phase_parallel_serve(card)
        for name, n in parallel_serve["launches"].items():
            launches[name] += n
        elapsed("parallel_serve")
        if launches["sentinel_features"] == 0:
            raise AssertionError("the main path never launched the sentinel-features kernel")
        dryrun = phase_dryrun(card, dry_proc, dry_dir)
        elapsed("dryrun")
        examples = phase_examples(card)
        elapsed("examples")
        kernels = phase_kernels(tail_cases, hybrid["cases"], train["cases"], cells["cases"],
                                placement["cases"])
        gated = phase_gated()
        sentinel = phase_sentinel()
        elapsed("kernels")
        phase_shapes(card)
        elapsed("shapes")
    except Exception:  # report the failing phase, then fail the run
        traceback.print_exc()
        return 1
    finally:
        if dry_proc is not None and dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.wait()

    sources = {
        "forest_score": ("src/repro_torch/csrc/forest_score.cu",
                         "src/repro/kernels/forest_score.py:318"),
        "forest_score_segments": ("src/repro_torch/csrc/forest_score.cu",
                                  "src/repro/kernels/forest_score.py:367"),
    }
    headline = {"forest_score": "ranker tail [1,2)"}
    line = []
    for name, r in kernels.items():
        case = next(
            (c for c in r["cases"] if c["case"] == headline.get(name)), r["cases"][0]
        )
        line.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None, "case": case["case"],
        })
    case = next(c for c in gated["cases"] if c["n_valid"] == c["B"] == GATED_BS[0])
    line.append({
        "name": "forest_score (gated tail)", "route": "cuda",
        "source": sources["forest_score"][0], "replaces": sources["forest_score"][1],
        "launches": tier["gated"] + hybrid["gated"] + guards["gated"],
        "max_abs_err": gated["max_abs_err"],
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": None, "case": case["case"],
    })
    case = sentinel["cases"][0]
    line.append({
        "name": "sentinel_features", "route": "cuda",
        "source": "src/repro_torch/csrc/sentinel_features.cu",
        "replaces": "none (plain jnp: src/repro/core/features.py augment_features)",
        "launches": launches["sentinel_features"], "max_abs_err": 0.0,
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": None, "case": case["case"],
    })
    # A short summary close to the end, where a truncated log still shows it.
    full = {c["B"]: c["ms"] for c in gated["cases"] if c["n_valid"] == c["B"]}
    log(f"[summary] {tier['summary']}; gated tail at a full count "
        + ", ".join(f"B={B} {ms:.4f} ms" for B, ms in sorted(full.items()))
        + f"; {hybrid['summary']}; {guards['summary']}; {train['summary']}; "
        f"{placement['summary']}; {cells['summary']}; {lm['summary']}; "
        f"{lm_train['summary']}; {nequip['summary']}; {parallel_train['summary']}; "
        f"{parallel_serve['summary']}; "
        f"{dryrun['summary']}; {examples['summary']}; "
        f"run {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
