"""Cells at the smoke config's sizes, for the CPU tests of the harness.

The smoke sizes are ``repro_torch.configs.lear_msn1.smoke_config``'s (24
trees of depth 4 over 16 features, sentinel 6, a 4-tree classifier); the
traffic is the bulk mix's at 16 queries of up to 32 candidates.
"""

from __future__ import annotations

import json

from lear_bench.harness import ROOT, Cell

# The cells' own limits.
LIMITS = json.loads((ROOT / "lear_bench" / "workloads" / "msn1-bulk.json").read_text())["limits"]


def small_cell(
    sentinel2: int = 0, mode: str = "auto", threshold: float = 0.5, queries: int = 16,
) -> Cell:
    cfg = {
        "n_trees": 24, "depth": 4, "n_features": 16, "sentinel": 6,
        "classifier_trees": 4, "classifier_depth": 3, "classifier_seed": 26, "top_k": 10,
        "service": {"execution_mode": mode, "launch_overhead_trees": 64.0},
    }
    if sentinel2:
        cfg["sentinel2"] = sentinel2
    traffic = {
        "loop": "closed", "clients": 1, "queries": queries, "slots": 32,
        "candidates": {"draw": "poisson", "mean": 20, "min": 8, "max": 32},
        "features": {"draw": "normal"}, "pool": 2,
    }
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return Cell(
        name="small", config=cfg, traffic=traffic,
        workload={"threshold": threshold, "limits": dict(LIMITS)},
        end_to_end=manifest["end_to_end"], per_layer=manifest["per_layer"],
    )
