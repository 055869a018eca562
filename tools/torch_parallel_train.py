"""The train and serving steps on a (data, model) mesh of four cards, one
process a card, against the same steps in one process.

    PYTHONPATH=src python3 tools/torch_parallel_train.py [--cases train|serve|nequip|all]

The launcher starts one rank per position of the (2, 2) mesh
(``join_ranks`` on 127.0.0.1 at a free port; rank ``r`` on ``cuda:r``,
NCCL) and prints one JSON line per case and rank, then a summary; it
exits non-zero if a rank fails or a case misses a limit. The same cases
at smoke size run on the CPU in ``gloo`` processes in
``tests/test_torch_model_parallel.py``.

- Smoke cases (float32, B 8, sequence 32, microbatch 4; Llama-4-Maverick
  without microbatches): Qwen3-4B, DeepSeek-MoE-16B, Minitron-4B and
  Llama-4-Maverick, their states placed by ``remesh`` under
  ``single_pod_rules``. Each rank also takes the same step alone on its
  card; loss and grad norm must agree within 1e-6 (relative), and every
  rank must take the identical step.
- Smoke cases of the families that step on their local shards: DLRM-RM2,
  DeepFM, DIN and BERT4Rec (float32, batch 16; tables split by rows over
  "model", the batch over "data") and NequIP's graph batch with forces
  (float64: its float32 forces on these inputs are some 1e-5 of their
  max from exact, ROADMAP C18; edges over all four ranks, nodes over
  "data"), held as the LM smoke cases.
- DLRM-RM2 at full width, ``train_batch`` (65,536), three steps: each
  card holds half of every table's rows (22.78 GB of the 45.56 GB) and of
  its row-wise state, the batch split over "data". Step 1's loss within
  1e-6 (relative) of rank 0's one-card step, later steps' within 1e-5;
  then each rank, its mesh state freed, takes the one-card gradient of
  the whole batch on its own card and holds its step-1 table rows by C16's
  rule: the touched rows in its range are the one-card rows, and no
  farther from the float64 sum of the batch's terms than the one-card
  rows are, plus 1e-6 of the table's max. Step time and each card's peak
  beside one card's.
- NequIP ``minibatch_lg`` with forces (full config, float32), edges over
  all four ranks and nodes over "data" (each card holds half of the node
  arrays and of every layer's aggregates), three steps: the loss, grad
  norm and every step-1 gradient within NequIP's tolerance (1e-4 of each
  tensor's max) of rank 0's one-card step, the ranks' final states
  identical; step time and peak beside one card's. ``--cases nequip``
  runs the NequIP cases alone (the smoke one and this).
- Qwen3-4B at ``chip_smoke.py``'s ``[lm_train]`` cut (12
  layers at full width, bfloat16, ``train_4k``, batch 4 × 4,096,
  microbatch 2), three steps on the mesh, timed on the host clock around
  synchronised steps (median of steps 2–3) beside each card's peak
  memory; then rank 0 takes the same three steps alone on its card.
  bfloat16 sums run in another order on the mesh, so the two agree only
  to rounding, and drift apart as the updates round differently: step 1's
  loss and grad norm and step 2's loss (after the first update) are held
  within :data:`FULL_LIMITS` of one card's, relative limits set between
  the gaps of sound runs and of planted faults (``PERF.md`` §6).

The serving cases (``--cases serve``; each state placed by ``remesh``, the
cells' steps under ``single_pod_rules``, outputs gathered whole on every
rank, which must agree bit for bit):

- Smoke (float32): the four RecSys families' ``serve_p99`` (16 requests)
  and ``retrieval_cand`` (2,000 candidates) with tables by rows over
  "model"; Qwen3-4B and DeepSeek-MoE-16B prefill of 4 x 10 tokens and three
  decode steps (positions 10-12 of a 24-token cache, its sequence over
  "model"); lear-msn1 ``rank_online`` (Q 4 over "data"). Each rank also
  serves alone: RecSys and the forest within :data:`SERVE_SMOKE_LIMITS`,
  the LM within ``tests/lm_parity.py``'s float32 2e-4.
- DLRM-RM2 ``retrieval_cand`` at full width (1,000,448 candidates over the
  four cards, tables by rows over "model": 22.78 GB a card): scores within
  :data:`RETRIEVAL_LIMIT` of rank 0's one-card step; step time and each
  card's peak beside one card's.
- Qwen3-4B ``decode_32k`` at full size, B = 8 (4 a card over "data")
  against a 32,768-token cache drawn on the cards (its sequence over
  "model": 9.66 GB a card of the 38.65 GB), one warm step and three timed
  at position 32,767: the logits within :data:`DECODE_LIMIT` (absolute,
  bfloat16) of rank 0's one-card step, beside a planted fault's gap (the
  partial softmaxes summed without their rescale) and a profile of one
  step on rank 0; step time and each card's peak beside one card's. Then
  the same in float32 against a 16,384-token cache, within
  :data:`DECODE_F32_LIMIT` of the logits' max.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2)
SMOKE = ("qwen3-4b", "deepseek-moe-16b", "minitron-4b", "llama4-maverick-400b-a17b")
SMOKE_LOCAL = {   # arch -> (shape, dtype): the families stepped on their local shards
    "dlrm-rm2": (dict(kind="train", batch=16, microbatch=8), "float32"),
    "deepfm": (dict(kind="train", batch=16), "float32"),
    "din": (dict(kind="train", batch=16), "float32"),
    "bert4rec": (dict(kind="train", batch=16, microbatch=8), "float32"),
    "nequip": (dict(kind="train", n_nodes=10, n_edges=20, graph_batch=8), "float64"),
}
SMOKE_LIMIT = 1e-6
DLRM_STEPS = 3
DLRM_LIMITS = {"step 1 loss": 1e-6, "step 1 grad norm": 1e-5, "step 2 loss": 1e-5}
DLRM_ROW_TOL = 1e-6       # C16: beyond the one-card rows' own distance from exact
NEQUIP_STEPS = 3
NEQUIP_TOL = 1e-4         # chip_smoke.NEQUIP_TOL: of each tensor's max
FULL_ARCH, FULL_LAYERS, FULL_BATCH, FULL_STEPS = "qwen3-4b", 12, (4, 2), 3
# The mesh's relative gap to one card, about 10x the sound runs' (2.15e-6,
# 5.66e-5, 1.50e-4 on NVIDIA H100 80GB HBM3 at 700 W) and below planted
# faults' (a tensor-parallel sum dropped: 4.98e-4, 0.712, 2.98e-2; the data
# ranks' mean left a sum: grad norm 1.0). A fault in a replicated weight's
# gradient can hide inside them; the ranks then disagree (PERF.md §6).
FULL_LIMITS = {"step 1 loss": 2e-5, "step 1 grad norm": 5e-4, "step 2 loss": 1.5e-3}
SERVE_STEPS = 3               # timed after one warm step (host clock, synchronised)
# Smoke serving: the gathered output's largest gap to one card, of its max
# (RecSys: a bag's rows sum in another order, ROADMAP C17; the LM's merged
# softmax adds in another order: tests/lm_parity.py's F32_TOL).
SERVE_SMOKE_LIMITS = {"recsys": 1e-6, "lm": 2e-4, "forest": 1e-6}
# DLRM-RM2 retrieval at full width: the scores' gap to one card, of their
# max (a share of the rows takes its own GEMM from cuBLAS).
RETRIEVAL_LIMIT = 1e-5
# Qwen3-4B decode in bfloat16, absolute: set between a sound run's gap
# (0.246, logits' max 4.94) and a planted missing rescale's (2.87) on four
# NVIDIA H100 80GB HBM3 at 700 W. The tensor-parallel partial sums round in
# bfloat16 at each of 36 layers, so tests/lm_parity.py's BF16_LOGIT_TOL
# (0.125, two layers against the CPU) is too tight here (PERF.md §6). The
# float32 case below holds exactness.
DECODE_LIMIT = 0.5
DECODE_BATCH, DECODE_CACHE = 8, 32768
# The same decode in float32 against a 16,384-token cache (one card holds
# its 17.6 GB of weights and 38.7 GB of cache), held to tests/lm_parity.py's
# F32_TOL of the logits' max.
DECODE_CACHE_F32, DECODE_F32_LIMIT = 16384, 2e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gaps(r: dict) -> dict[str, float]:
    """The mesh's relative gaps to one card in case report ``r``."""
    got, want = r["losses"], r["one_losses"]
    gaps = {"step 1 loss": (got[0][0], want[0][0]), "step 1 grad norm": (got[0][1], want[0][1])}
    if len(got) > 1:
        gaps["step 2 loss"] = (got[1][0], want[1][0])
    return {k: abs(a - b) / abs(b) for k, (a, b) in gaps.items()}


def _launch(cases: str) -> int:
    world = math.prod(MESH)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, os.path.abspath(__file__), "--port", str(port), "--cases", cases]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=1500)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs, strict=True)):
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        reports += lines
        for x in lines:
            print(json.dumps(x), flush=True)
        if p.returncode:
            print(f"rank {r} failed:\n{out[-4000:]}", flush=True)
            return 1
    ok = True
    for case in dict.fromkeys(x["case"] for x in reports):
        ranks = [x for x in reports if x["case"] == case]
        r0 = ranks[0]
        same = all(x.get("losses") == r0.get("losses") and x.get("digest") == r0.get("digest")
                   for x in ranks)
        serving = "gaps" in r0   # a serving case reports its gaps to one card itself
        gaps = r0["gaps"] if serving else _gaps(r0)
        limits = r0.get("limits") or (FULL_LIMITS if r0.get("ms") else
                                      dict.fromkeys(gaps, SMOKE_LIMIT))
        checks = {k: all(x["checks"][k] for x in ranks) for k in r0.get("checks", {})}
        held = same and all(gaps[k] <= limits[k] for k in gaps) and all(checks.values())
        ok &= held
        print(f"{case}: {len(ranks)} ranks identical {same}; "
              + ("" if serving else f"(loss, grad norm) by step {r0['losses']} vs one card "
                                    f"{r0['one_losses']}; ")
              + "gaps "
              + ", ".join(f"{k} {v:.3g} (limit {limits[k]:g})" for k, v in gaps.items())
              + "".join(f"; {k} {v}" for k, v in checks.items())
              + "".join(f"; {k} {v}" for k, v in r0.get("notes", {}).items())
              + f"; held {held}"
              + (f"; step {r0['ms']:.1f} ms on the mesh vs {r0['one_ms']:.1f} alone; peak per "
                 f"card {max(x['peak'] for x in ranks) / 1e9:.2f} GB vs {r0['one_peak']}"
                 if r0.get("ms") else ""), flush=True)
        ok &= not (r0.get("digest") is not None and not same)
    return 0 if ok else 1


def _rank(args) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding_rules, single_pod_rules
    from repro_torch.launch.mesh import join_ranks
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh

    dev = torch.device(f"cuda:{args.rank}")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    join_ranks("127.0.0.1", args.port, args.rank, math.prod(MESH))
    mesh = init_device_mesh("cuda", MESH, mesh_dim_names=("data", "model"))
    rules = single_pod_rules()
    if args.cases in ("serve", "all"):
        _serve_cases(args, dev, mesh, rules)
    if args.cases == "serve":
        dist.destroy_process_group()
        return

    def steps(cell, state, batch, n, ruled, keep=False):
        times, losses = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if ruled:
                with sharding_rules(rules, mesh):
                    state, m = cell.step(state, batch)
            else:
                state, m = cell.step(state, batch)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times, losses, state if keep else None   # no state outlives its use

    def report(**kw):
        print(json.dumps({"rank": args.rank, **kw}), flush=True)

    for arch, (shape, dtype) in SMOKE_LOCAL.items():
        if args.cases == "nequip" and arch != "nequip":
            continue
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
        cell = make_cell(cfg, ShapeSpec(name="t", **shape))
        batch = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v
                 for k, v in as_tensors(synthesize_inputs(cell, 0), dev).items()}

        def init():
            st = cell.init_state(0, dev)
            return dataclasses.replace(st, params={k: v.to(getattr(torch, dtype))
                                                   for k, v in st.params.items()})

        _, losses, new = steps(cell, remesh(init(), cell.state_logical(), rules, mesh), batch,
                               1, True, keep=arch == "nequip")
        digest = _digest_state(new) if arch == "nequip" else None   # replicated
        del new
        _, one_losses, _ = steps(cell, init(), batch, 1, False)
        report(case=f"{arch} smoke {dtype}", losses=losses, one_losses=one_losses, digest=digest)

    if args.cases != "nequip":
        _dlrm_full(args, dev, mesh, rules, steps, report)
    _nequip_full(args, dev, mesh, rules, steps, report)
    if args.cases == "nequip":
        dist.destroy_process_group()
        return

    for arch in SMOKE:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        mb = 0 if cfg.optimizer == "adafactor" else 4
        cell = make_cell(cfg, ShapeSpec(name="t", kind="train", seq_len=32, global_batch=8,
                                        microbatch=mb))
        batch = as_tensors(synthesize_inputs(cell, 0), dev)
        placed = remesh(cell.init_state(0, dev), cell.state_logical(), rules, mesh)
        _, losses, _ = steps(cell, placed, batch, 1, True)
        del placed
        _, one_losses, _ = steps(cell, cell.init_state(0, dev), batch, 1, False)
        report(case=f"{arch} smoke f32", losses=losses, one_losses=one_losses)

    cfg = get_config(FULL_ARCH)
    shape = next(s for s in cfg.shapes if s.name == "train_4k")
    B, mb = FULL_BATCH
    cfg = dataclasses.replace(cfg, n_layers=FULL_LAYERS)
    cell = make_cell(cfg, dataclasses.replace(shape, global_batch=B, microbatch=mb))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, shape.seq_len), generator=g,
                              device=dev, dtype=torch.int32) for k in ("tokens", "labels")}

    def init():
        return cell.init_state(torch.Generator(device=dev).manual_seed(71), dev)

    placed = [remesh(init(), cell.state_logical(), rules, mesh)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # pop(): no reference to the first state outlives its step.
    times, losses, _ = steps(cell, placed.pop(), batch, FULL_STEPS, True)
    peak = torch.cuda.max_memory_allocated()
    one_ms = one_peak = one_losses = None
    dist.barrier()
    if args.rank == 0:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_times, one_losses, _ = steps(cell, init(), batch, FULL_STEPS, False)
        one_ms = statistics.median(one_times[1:])
        one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
    dist.barrier()
    report(case=f"{FULL_ARCH} {FULL_LAYERS} layers {B}x{shape.seq_len} bf16",
           losses=losses, one_losses=one_losses, ms=statistics.median(times[1:]),
           step_ms=times, one_ms=one_ms, peak=peak, one_peak=one_peak)
    dist.destroy_process_group()


def _digest_state(state) -> str:
    """SHA-256 of every leaf's bits (a ``DTensor``'s ``full_tensor()``, so
    every rank hashes the same whole state; a collective)."""
    import hashlib

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.utils import tree_items

    h = hashlib.sha256()
    for _, t in tree_items(state):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _spy_grads(seen: list):
    """Make the trainer hand this list each step's gradients (the ones its
    norm, clip and optimizer see); returns the undo."""
    from repro_torch.train import trainer

    norm = trainer.optax_global_norm
    trainer.optax_global_norm = lambda g, *a: seen.append(g) or norm(g, *a)
    return lambda: setattr(trainer, "optax_global_norm", norm)


def _dlrm_full(args, dev, mesh, rules, steps, report) -> None:
    """DLRM-RM2 ``train_batch`` at full width on the mesh, held to rank 0's
    one-card steps and, row by row, to the float64 sum (C16)."""
    import functools
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import recsys
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh, trainer

    cfg = get_config("dlrm-rm2")
    shape = next(s for s in cfg.shapes if s.name == "train_batch")
    cell = make_cell(cfg, shape)
    batch = as_tensors(synthesize_inputs(cell, seed=0), dev)

    def init():
        return cell.init_state(torch.Generator(device=dev).manual_seed(0), dev)

    # Every rank draws the same init and keeps a copy of its shards only:
    # a scatter from rank 0 would copy the whole 45.56 GB of tables.
    placed = [remesh(init(), cell.state_logical(), rules, mesh, src_data_rank=None)]
    gc.collect()
    torch.cuda.empty_cache()
    tables = sum(t.to_local().numel() * 4 for k, t in placed[0].params.items()
                 if k.startswith("tables/"))
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seen: list = []
    undo = _spy_grads(seen)
    try:
        times, losses, _ = steps(cell, placed.pop(), batch, DLRM_STEPS, True)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    mine = {k: g for k, g in seen[0].items() if g.is_sparse}   # this rank's step-1 table rows
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    # The one-card gradient of the whole batch on this card: rows by C16.
    state = init()
    raw = trainer._grads(functools.partial(recsys.loss_fn, cfg, sparse_grad=True),
                         state.params, batch)[1]
    m = mesh.get_coordinate()[1]
    rows_ok, worst = True, {"mesh": 0.0, "one": 0.0}
    for k, g in mine.items():
        exact = torch.sparse_coo_tensor(raw[k]._indices(), raw[k]._values().double(),
                                        raw[k].shape).coalesce()
        one = raw[k].coalesce()
        n = g.shape[0]
        lo = m * n
        scale = float(one.values().abs().max())
        idx = one.indices()[0]
        at = (idx >= lo) & (idx < lo + n)
        g = g.coalesce()
        if not torch.equal(g.indices()[0] + lo, idx[at]):
            rows_ok = False
            continue
        if not g._nnz():   # no id of the batch in this rank's rows
            continue
        e_mesh = float((g.values().double() - exact.values()[at]).abs().max()) / scale
        e_one = float((one.values()[at].double() - exact.values()[at]).abs().max()) / scale
        worst = {"mesh": max(worst["mesh"], e_mesh), "one": max(worst["one"], e_one)}
        rows_ok &= e_mesh <= e_one + DLRM_ROW_TOL
    del raw, mine
    gc.collect()
    torch.cuda.empty_cache()
    one_ms = one_peak = one_losses = None
    if args.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        one_times, one_losses, _ = steps(cell, state, batch, DLRM_STEPS, False)
        one_ms = statistics.median(one_times[1:])
        one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
    del state
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    report(case=f"dlrm-rm2 train_batch B={shape.batch} rows over model", losses=losses,
           one_losses=one_losses, ms=statistics.median(times[1:]), step_ms=times,
           one_ms=one_ms, peak=peak, one_peak=one_peak, limits=DLRM_LIMITS,
           checks={"rows by C16": rows_ok},
           notes={"tables a card": f"{tables / 1e9:.2f} GB",
                  "allocated a card before the steps": f"{state_bytes / 1e9:.2f} GB",
                  "rows from exact (mesh / one card)":
                      f"{worst['mesh']:.3g} / {worst['one']:.3g}"})


def _nequip_full(args, dev, mesh, rules, steps, report) -> None:
    """NequIP ``minibatch_lg`` with forces, edges over every rank and
    nodes over "data", held to rank 0's one-card step at NEQUIP_TOL."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh

    cfg = get_config("nequip")
    shape = next(s for s in cfg.shapes if s.name == "minibatch_lg")
    cell = make_cell(cfg, shape)
    batch = as_tensors(synthesize_inputs(cell, seed=83), dev)

    def init():
        return cell.init_state(torch.Generator(device=dev).manual_seed(83), dev)

    seen: list = []
    undo = _spy_grads(seen)
    try:
        placed = [remesh(init(), cell.state_logical(), rules, mesh)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses, new = steps(cell, placed.pop(), batch, NEQUIP_STEPS, True, keep=True)
        peak = torch.cuda.max_memory_allocated()
        digest = _digest_state(new)
        del new
        mesh_grads = {k: g.clone() for k, g in seen[0].items()}
        seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        one_ms = one_peak = one_losses = None
        grad_rel = 0.0
        if args.rank == 0:
            torch.cuda.reset_peak_memory_stats()
            one_times, one_losses, _ = steps(cell, init(), batch, NEQUIP_STEPS, False)
            one_ms = statistics.median(one_times[1:])
            one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            grad_rel = max(float((mesh_grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                           for k, g in seen[0].items())
    finally:
        undo()
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    E = batch["edge_src"].shape[0]
    report(case=f"nequip minibatch_lg (forces) E={E} over {dist.get_world_size()} ranks, "
                f"N={batch['positions'].shape[0]} over \"data\"",
           losses=losses, one_losses=one_losses, ms=statistics.median(times[1:]),
           step_ms=times, one_ms=one_ms, peak=peak, one_peak=one_peak, digest=digest,
           limits={"step 1 loss": NEQUIP_TOL, "step 1 grad norm": NEQUIP_TOL,
                   "step 2 loss": NEQUIP_TOL},
           checks={"step-1 gradients within 1e-4 of their max": args.rank != 0
                   or grad_rel <= NEQUIP_TOL},
           notes={"step-1 gradients' largest gap": f"{grad_rel:.3g}" if args.rank == 0
                  else "rank 0 reads"})


# ---------------------------------------------------------------------------
# The serving cases.
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    """``a``'s largest gap to ``b``, of ``b``'s max."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _serve_timed(cell, state, inputs, ruled, mesh, rules, n=SERVE_STEPS):
    """One warm step and ``n`` timed (host clock around synchronised
    steps); returns the times and the last output."""
    import contextlib

    import torch

    from repro_torch.distributed import sharding_rules

    ctx = sharding_rules(rules, mesh) if ruled else contextlib.nullcontext()
    times, out = [], None
    with ctx:
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cell.step(state, inputs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return times[1:], out


def _tensor_digest(tensors) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _serve_smoke(args, dev, mesh, rules, report) -> None:
    """The smoke serving cases of every family, each rank against its own
    one-card step."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh

    for arch in ("dlrm-rm2", "deepfm", "din", "bert4rec"):
        for name, shape in (("serve_p99", dict(kind="serve", batch=16)),
                            ("retrieval_cand", dict(kind="serve", batch=1, n_candidates=2000))):
            cell = make_cell(get_smoke_config(arch), ShapeSpec(name="s", **shape))
            params = cell.init_state(0, dev)
            inputs = as_tensors(synthesize_inputs(cell, seed=5), dev)
            placed = remesh(params, cell.state_logical(), rules, mesh, src_data_rank=None)
            _, got = _serve_timed(cell, placed, inputs, True, mesh, rules, n=0)
            _, want = _serve_timed(cell, params, inputs, False, mesh, rules, n=0)
            report(case=f"{arch} {name} smoke f32", gaps={"scores": _rel(got, want)},
                   limits={"scores": SERVE_SMOKE_LIMITS["recsys"]}, digest=_tensor_digest([got]))

    B, P, T, steps = 4, 10, 24, 3
    for arch in ("qwen3-4b", "deepseek-moe-16b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        pre = make_cell(cfg, ShapeSpec(name="p", kind="prefill", seq_len=P, global_batch=B))
        dec = make_cell(cfg, ShapeSpec(name="d", kind="decode", seq_len=T, global_batch=B))
        params = pre.init_state(0, dev)
        rng = np.random.default_rng(5)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32),
                                 device=dev)
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32),
                              device=dev)

        def serve(state, ruled):
            _, (logits, caches) = _serve_timed(pre, state, {"tokens": prompt}, ruled, mesh,
                                               rules, n=0)
            caches = {n: {kv: F.pad(t, (0, 0, 0, 0, 0, T - P)) for kv, t in c.items()}
                      for n, c in caches.items()}
            out = [logits]
            for i in range(steps):
                _, (logits, caches) = _serve_timed(
                    dec, state, {"token": nxt[i], "caches": caches,
                                 "pos": torch.tensor(P + i)}, ruled, mesh, rules, n=0)
                out.append(logits)
            return out

        got = serve(remesh(params, pre.state_logical(), rules, mesh), True)
        want = serve(params, False)
        report(case=f"{arch} prefill + decode smoke f32",
               gaps={"logits": max(_rel(a, b) for a, b in zip(got, want))},
               limits={"logits": SERVE_SMOKE_LIMITS["lm"]}, digest=_tensor_digest(got))

    cell = make_cell(get_smoke_config("lear-msn1"), ShapeSpec(name="q", kind="serve", batch=4))
    params = cell.init_state(7, dev)
    inputs = as_tensors(synthesize_inputs(cell, seed=5), dev)
    placed = remesh(params, cell.state_logical(), rules, mesh, src_data_rank=None)
    _, (scores, cont) = _serve_timed(cell, placed, inputs, True, mesh, rules, n=0)
    _, (w_scores, w_cont) = _serve_timed(cell, params, inputs, False, mesh, rules, n=0)
    report(case="lear-msn1 rank_online Q=4 smoke", gaps={"scores": _rel(scores, w_scores)},
           limits={"scores": SERVE_SMOKE_LIMITS["forest"]},
           checks={"continue masks equal": bool(torch.equal(cont, w_cont))},
           digest=_tensor_digest([scores, cont]))


def _dlrm_retrieval(args, dev, mesh, rules, report) -> None:
    """DLRM-RM2 ``retrieval_cand`` at full width on the mesh, then rank 0
    alone on its card."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import as_tensors, synthesize_inputs
    from repro_torch.train import remesh

    cfg = get_config("dlrm-rm2")
    shape = next(s for s in cfg.shapes if s.name == "retrieval_cand")
    cell = make_cell(cfg, shape)
    inputs = as_tensors(synthesize_inputs(cell, seed=0), dev)

    def init():
        return cell.init_state(torch.Generator(device=dev).manual_seed(0), dev)

    # Every rank draws the same init and keeps a copy of its shards only.
    placed = [remesh(init(), cell.state_logical(), rules, mesh, src_data_rank=None)]
    gc.collect()
    torch.cuda.empty_cache()
    tables = sum(t.to_local().numel() * 4 for k, t in placed[0].items() if k.startswith("tables/"))
    torch.cuda.reset_peak_memory_stats()
    times, scores = _serve_timed(cell, placed.pop(), inputs, True, mesh, rules)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    one_ms = one_peak = None
    gaps = {}
    if args.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        one_times, want = _serve_timed(cell, init(), inputs, False, mesh, rules)
        one_ms = statistics.median(one_times)
        one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
        gaps = {"scores": _rel(scores, want)}
        del want
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    C = inputs["cand_ids"].shape[0]
    report(case=f"dlrm-rm2 retrieval_cand C={C:,} rows over model, candidates over every card",
           gaps=gaps, limits={"scores": RETRIEVAL_LIMIT}, digest=_tensor_digest([scores]),
           ms=statistics.median(times), step_ms=times, one_ms=one_ms, peak=peak,
           one_peak=one_peak, notes={"tables a card": f"{tables / 1e9:.2f} GB"})


def _profile_step(fn, n_top: int = 6) -> dict:
    """torch.profiler over one call of ``fn`` (a collective step: every
    rank calls it, this one records): the window's wall ms, the card's busy
    ms (device events' own time), and the top device and host-self events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_events = [e for e in events
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return {
        "window ms": round(wall, 3),
        "device busy ms": round(sum(e.self_device_time_total for e in dev_events) / 1e3, 3),
        "top device": [f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                       for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:n_top]],
        "top host self": [f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
                          for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:n_top]],
    }


def _qwen_decode(args, dev, mesh, rules, report, dtype: str, T: int, limit: float,
                 profile: bool) -> None:
    """Qwen3-4B ``decode_32k`` at full width and depth in ``dtype``, B =
    DECODE_BATCH, against a ``T``-token cache whose sequence splits over
    "model", then rank 0 alone on its card with the same weights and cache.
    bfloat16 is held absolute (``limit``) beside a planted fault's gap and
    profiled (``profile``); float32 relative to the logits' max."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import make_cell
    from repro_torch.train import remesh
    from repro_torch.train.trainer import serve_input_logical

    cfg = dataclasses.replace(get_config("qwen3-4b"), dtype=dtype)
    shape = next(s for s in cfg.shapes if s.name == "decode_32k")
    B = DECODE_BATCH
    cell = make_cell(cfg, dataclasses.replace(shape, global_batch=B, seq_len=T))
    token = torch.as_tensor(np.random.default_rng(64).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32), device=dev)

    def inputs(caches):
        return {"token": token, "caches": caches, "pos": torch.tensor(T - 1)}

    def weights():
        return tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def caches():
        g = torch.Generator(device=dev).manual_seed(1)
        c = tfm.make_decode_caches(cfg, B, T, dev)
        for t in (t for x in c.values() for t in x.values()):
            t.normal_(generator=g)
        return c

    lg = serve_input_logical(cell.input_logical())["caches"]
    # Each rank draws the whole weights and cache and keeps its shards.
    placed = remesh(weights(), cell.state_logical(), rules, mesh, src_data_rank=None)
    gc.collect()
    mine = remesh(caches(), lg, rules, mesh, src_data_rank=None)
    gc.collect()
    torch.cuda.empty_cache()
    cache_bytes = sum(t.to_local().numel() * t.element_size()
                      for x in mine.values() for t in x.values())
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, (logits, _) = _serve_timed(cell, placed, inputs(mine), True, mesh, rules)
    peak = torch.cuda.max_memory_allocated()
    notes = {}
    if profile:
        prof = _profile_step(lambda: _serve_timed(cell, placed, inputs(mine), True, mesh, rules,
                                                  n=0))
        if args.rank == 0:
            notes["profile of one step on rank 0"] = prof
    planted = None
    if dtype == "bfloat16":
        # A planted fault beside the limit: the partial softmaxes summed
        # without the rescale to the ranks' maximum.
        merge = tfm.merge_softmax
        tfm.merge_softmax = (
            lambda top, total, acc, axis: axis.reduce(acc) / axis.reduce(total)[..., None])
        try:
            _, (planted, _) = _serve_timed(cell, placed, inputs(mine), True, mesh, rules, n=0)
        finally:
            tfm.merge_softmax = merge
    del placed, mine
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    one_ms = one_peak = None
    gaps = {}
    key = "logits (absolute)" if dtype == "bfloat16" else "logits (of their max)"
    if args.rank == 0:
        params, whole = weights(), caches()
        torch.cuda.reset_peak_memory_stats()
        one_times, (want, _) = _serve_timed(cell, params, inputs(whole), False, mesh, rules)
        one_ms = statistics.median(one_times)
        one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
        gap = float((logits - want).abs().max())
        gaps = {key: gap if dtype == "bfloat16" else gap / float(want.abs().max())}
        if planted is not None:
            notes["planted fault's gap (no rescale)"] = float((planted - want).abs().max())
        del params, whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    report(case=f"qwen3-4b decode {dtype} B={B} against a {T:,}-token cache, its sequence "
                f"over model", gaps=gaps, limits={key: limit},
           digest=_tensor_digest([logits]), ms=statistics.median(times), step_ms=times,
           one_ms=one_ms, peak=peak, one_peak=one_peak,
           notes={"cache a card": f"{cache_bytes / 1e9:.2f} GB",
                  "allocated a card before the steps": f"{held / 1e9:.2f} GB",
                  "logits' max": f"{float(logits.abs().max()):.4g}", **notes})


def _serve_cases(args, dev, mesh, rules) -> None:
    def report(**kw):
        print(json.dumps({"rank": args.rank, **kw}), flush=True)

    _serve_smoke(args, dev, mesh, rules, report)
    _dlrm_retrieval(args, dev, mesh, rules, report)
    _qwen_decode(args, dev, mesh, rules, report, "bfloat16", DECODE_CACHE, DECODE_LIMIT, True)
    _qwen_decode(args, dev, mesh, rules, report, "float32", DECODE_CACHE_F32, DECODE_F32_LIMIT,
                 False)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--cases", choices=("train", "serve", "nequip", "all"), default="all")
    args = p.parse_args()
    if args.rank is None:
        return _launch(args.cases)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _rank(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

