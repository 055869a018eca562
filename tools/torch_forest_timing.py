#!/usr/bin/env python3
"""Host and device time of one forest-scoring call of the PyTorch port.

Run on a machine with an NVIDIA card, with a tree's ``src`` on the path::

    PYTHONPATH=src python3 tools/torch_forest_timing.py [--label NAME] [--plans]

At the lear-msn1 shapes of one single-sentinel serving batch — the
classifier (16 trees, 140 features, B 2048), the ranker's head (64 trees,
B 2048) and its tail (1,008 trees) at the serving capacity B 1024 — it
times two calls: ``repro_torch.kernels.ops.forest_score_range``, which the
ranking engine makes, and the kernel wrapper under it
(``forest_score.forest_score_kernel``, given the packed tables where the
tree has them). For each it prints

- ``host_us``: the host's time per call, 200 calls issued behind a sleep
  kernel so that the card never makes the host wait; the median and the
  least of 5 runs;
- ``device_ms``: 200 back-to-back calls between one pair of CUDA events,
  divided by 200.

It uses only what every version of the port has, so two trees can be
compared on one card in one run (``PYTHONPATH=<tree>/src`` for each).
With ``--plans`` it also times the wrapper on the tail at B 2048, 1024
and 512 under forced launch decompositions (``forest_score.GRID_PLAN``:
warps on documents, warps on the trees of a block, tree blocks per CTA;
0 is the launcher's choice), each result held bit-exact to the plain
version.

With ``--gated`` (a tree whose wrapper takes ``n_valid``) it times the
tail at B 1024 and 2048 ungated and gated with every row valid, in the
order ungated, gated, gated, ungated, and the gated launch with no row
valid. With ``--sass`` it prints, for each instantiation of the kernel in
the built library, the registers, stack bytes and SASS instructions that
``cuobjdump`` reports.
"""

from __future__ import annotations

import argparse
import inspect
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs.lear_msn1 import config
from repro_torch.core.features import N_AUG
from repro_torch.forest.ensemble import random_ensemble
from repro_torch.kernels import forest_score as fs
from repro_torch.kernels.ops import forest_score_range, padded_forest

REPS = 200
RUNS = 5
SLEEP_CYCLES = 100_000_000  # ~50 ms of card time ahead of the host's calls
PLANS = ((0, 0, 0), (4, 2, 0), (2, 4, 0), (1, 8, 0), (1, 4, 0), (2, 4, 2), (1, 8, 2))


def host_us(fn) -> tuple[float, float]:
    """Median and least host microseconds per call over ``RUNS`` runs."""
    per_call = []
    for _ in range(RUNS):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        per_call.append((time.perf_counter() - t0) / REPS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call), min(per_call)


def device_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def wrapper_call(pf, x, seg_lo, seg_hi):
    kw = dict(
        block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[seg_lo],
        n_tree_blocks=sum(pf.seg_blocks[seg_lo:seg_hi]), leaf_gather=pf.leaf_gather,
    )
    if "packed" in inspect.signature(fs.forest_score_kernel).parameters:
        kw["packed"] = pf.packed
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    return lambda: fs.forest_score_kernel(x, *tables, **kw)


def gated_rows(pf, x, label: str) -> None:
    """The tail ungated and gated (every row valid, then none), one card."""
    tables = (pf.feature, pf.threshold, pf.mask, pf.leaf_value)
    kw = dict(block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[1],
              n_tree_blocks=pf.seg_blocks[1], leaf_gather=pf.leaf_gather, packed=pf.packed)
    for B in (1024, 2048):
        xs = x[:B].contiguous()
        counts = {c: torch.tensor(c, dtype=torch.int32, device=xs.device) for c in (0, B)}
        ungated = lambda xs=xs: fs.forest_score_kernel(xs, *tables, **kw)
        gated = {
            c: lambda xs=xs, n=n: fs.forest_score_kernel(xs, *tables, n_valid=n, **kw)
            for c, n in counts.items()
        }
        if not torch.equal(gated[B](), ungated()):
            raise AssertionError(f"B={B}: the gated launch differs from the ungated one")
        u1, g1, g2, u2 = (device_ms(f) for f in (ungated, gated[B], gated[B], ungated))
        g0 = device_ms(gated[0])
        u, g = (u1 + u2) / 2, (g1 + g2) / 2
        print(
            f"[gated] {label} tail B={B}: ungated={u1:.4f},{u2:.4f} ms "
            f"gated n_valid=B={g1:.4f},{g2:.4f} ms ({100 * (g / u - 1):+.2f}%) "
            f"gated n_valid=0={g0:.4f} ms", flush=True,
        )


def sass_rows(label: str) -> None:
    """Registers, stack and SASS instruction count per kernel instantiation."""
    from repro_torch.kernels import build

    path, _ = build.build("forest_score")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-res-usage", str(path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    name_re = re.compile(r"forest_score_kernelILi(\d+)ELb([01])ELb([01])E")
    usage = {}
    for fn, rest in re.findall(r"Function (\S+):\n(.*)", res):
        m = name_re.search(fn)
        if m:
            usage[m.groups()] = rest.strip()
    counts: dict[tuple, int] = {}
    key = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = name_re.search(line)
            key = m.groups() if m else None
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[key] = counts.get(key, 0) + 1
    for (bt, seg, gated) in sorted(usage, key=lambda k: (int(k[0]), k[1], k[2])):
        print(
            f"[sass] {label} block_t={bt} segmented={seg} gated={gated}: "
            f"{usage[(bt, seg, gated)]}; instructions={counts.get((bt, seg, gated), 0)}",
            flush=True,
        )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="tree")
    parser.add_argument("--plans", action="store_true")
    parser.add_argument("--gated", action="store_true")
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_forest_timing: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = config()
    ranker = random_ensemble(0, cfg.n_trees, cfg.depth, cfg.n_features, device=dev)
    clf = random_ensemble(
        1, cfg.classifier_trees, cfg.classifier_depth, cfg.n_features + N_AUG, device=dev
    )
    pf = padded_forest(ranker, boundaries=(cfg.sentinel, cfg.n_trees))
    pfc = padded_forest(clf)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2048, cfg.n_features)).astype(np.float32), device=dev)
    xc = torch.as_tensor(
        rng.normal(size=(2048, cfg.n_features + N_AUG)).astype(np.float32), device=dev
    )
    cases = (
        ("classifier B=2048", pfc, xc, 0, 1),
        ("head B=2048", pf, x, 0, 1),
        ("tail B=1024", pf, x[:1024].contiguous(), 1, 2),
    )
    for label, p, xs, lo, hi in cases:
        for call, fn in (
            ("ops.forest_score_range", lambda p=p, xs=xs, lo=lo, hi=hi: forest_score_range(
                p, xs, lo, hi)),
            ("forest_score_kernel", wrapper_call(p, xs, lo, hi)),
        ):
            med, least = host_us(fn)
            print(
                f"[timing] {args.label} {label} {call}: host_us median={med:.2f} "
                f"least={least:.2f} device_ms={device_ms(fn):.4f}", flush=True,
            )

    if args.gated:
        gated_rows(pf, x, args.label)
    if args.sass:
        sass_rows(args.label)
    if args.plans:
        for B in (2048, 1024, 512):
            xs = x[:B].contiguous()
            want = fs.forest_score_plain(
                xs, pf.feature, pf.threshold, pf.mask, pf.leaf_value,
                block_t=pf.block_t, tree_block_offset=pf.seg_block_starts[1],
                n_tree_blocks=pf.seg_blocks[1],
            )
            for plan in PLANS:
                fs.GRID_PLAN = plan
                fn = wrapper_call(pf, xs, 1, 2)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"plan {plan} B={B}: differs from the plain version")
                grid = fs.launch_plan(
                    B, xs.shape[1], pf.feature.shape[1], pf.leaf_value.shape[1],
                    pf.block_t, pf.seg_blocks[1],
                )
                print(
                    f"[plans] {args.label} tail B={B} plan={plan}: "
                    f"device_ms={device_ms(fn):.4f} grid={grid}", flush=True,
                )
            fs.GRID_PLAN = (0, 0, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
