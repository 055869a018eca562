"""Re-derive roofline records from saved ``.ops.json.gz`` traces (no
retrace): the port of :mod:`repro.launch.reanalyze`, for a change of
constants or of :func:`repro_torch.launch.op_analysis.analyze`. Each
record keeps its model FLOPs and the collectives reckoned from the rules.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rf
from repro_torch.launch.dryrun import ARTIFACTS


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.reanalyze")
    p.add_argument("--dir", default=os.path.normpath(ARTIFACTS))
    args = p.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            record = json.load(f)
        if "skipped" in record or "error" in record:
            continue
        ops_path = path.removesuffix(".json") + ".ops.json.gz"
        if not os.path.exists(ops_path):
            continue
        cost = op_analysis.analyze(op_analysis.load(ops_path))
        chips = record["chips"]
        # The record's collectives beyond the trace's own are the rules'.
        traced = {k: v / chips for k, v in cost.coll_breakdown.items()}
        rules = {k: v - traced.get(k, 0.0)
                 for k, v in record["roofline"]["coll_breakdown"].items()}
        roof = rf.roofline(cost, chips=chips, model_flops=record["roofline"]["model_flops"],
                           coll_breakdown=rules)
        record["roofline"] = roof.to_dict()
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        print(os.path.basename(path), roof.dominant, f"bound={roof.bound_s:.3e}")


if __name__ == "__main__":
    main()
