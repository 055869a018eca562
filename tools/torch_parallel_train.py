"""The train step on a (data, model) mesh of four cards, one process a
card, against the same step in one process.

    PYTHONPATH=src python3 tools/torch_parallel_train.py

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
SMOKE_LIMIT = 1e-6
FULL_ARCH, FULL_LAYERS, FULL_BATCH, FULL_STEPS = "qwen3-4b", 12, (4, 2), 3
# The mesh's relative gap to one card, about 10x the sound runs' (2.15e-6,
# 5.66e-5, 1.50e-4 on NVIDIA H100 80GB HBM3 at 700 W) and below planted
# faults' (a tensor-parallel sum dropped: 4.98e-4, 0.712, 2.98e-2; the data
# ranks' mean left a sum: grad norm 1.0). A fault in a replicated weight's
# gradient can hide inside them; the ranks then disagree (PERF.md §6).
FULL_LIMITS = {"step 1 loss": 2e-5, "step 1 grad norm": 5e-4, "step 2 loss": 1.5e-3}


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


def _launch() -> int:
    world = math.prod(MESH)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, os.path.abspath(__file__), "--port", str(port)]
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
        same = all(x["losses"] == r0["losses"] for x in ranks)
        gaps = _gaps(r0)
        limits = FULL_LIMITS if r0.get("ms") else dict.fromkeys(gaps, SMOKE_LIMIT)
        held = same and all(gaps[k] <= limits[k] for k in gaps)
        ok &= held
        print(f"{case}: {len(ranks)} ranks identical {same}; (loss, grad norm) by step "
              f"{r0['losses']} vs one card {r0['one_losses']}; relative gaps "
              + ", ".join(f"{k} {v:.3g} (limit {limits[k]:g})" for k, v in gaps.items())
              + f"; held {held}"
              + (f"; step {r0['ms']:.1f} ms on the mesh vs {r0['one_ms']:.1f} alone; peak per "
                 f"card {max(x['peak'] for x in ranks) / 1e9:.2f} GB vs {r0['one_peak']}"
                 if r0.get("ms") else ""), flush=True)
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

    def steps(cell, state, batch, n, ruled):
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
        return times, losses

    def report(**kw):
        print(json.dumps({"rank": args.rank, **kw}), flush=True)

    for arch in SMOKE:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        mb = 0 if cfg.optimizer == "adafactor" else 4
        cell = make_cell(cfg, ShapeSpec(name="t", kind="train", seq_len=32, global_batch=8,
                                        microbatch=mb))
        batch = as_tensors(synthesize_inputs(cell, 0), dev)
        placed = remesh(cell.init_state(0, dev), cell.state_logical(), rules, mesh)
        _, losses = steps(cell, placed, batch, 1, True)
        del placed
        _, one_losses = steps(cell, cell.init_state(0, dev), batch, 1, False)
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
    times, losses = steps(cell, placed.pop(), batch, FULL_STEPS, True)
    peak = torch.cuda.max_memory_allocated()
    one_ms = one_peak = one_losses = None
    dist.barrier()
    if args.rank == 0:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_times, one_losses = steps(cell, init(), batch, FULL_STEPS, False)
        one_ms = statistics.median(one_times[1:])
        one_peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
    dist.barrier()
    report(case=f"{FULL_ARCH} {FULL_LAYERS} layers {B}x{shape.seq_len} bf16",
           losses=losses, one_losses=one_losses, ms=statistics.median(times[1:]),
           step_ms=times, one_ms=one_ms, peak=peak, one_peak=one_peak)
    dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args()
    if args.rank is None:
        return _launch()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _rank(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
