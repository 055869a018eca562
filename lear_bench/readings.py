"""The readings the check's limits are set from, in one process.

    python3 -m lear_bench.readings --workload msn1-bulk --seconds 3 \\
        --seeds 11 12 13 --control-seeds 21 22 23

Runs the cell once a seed with the program in the window (sound runs: the
lower reading of each compared number is their largest), then once a
control seed with :class:`lear_bench.control.ControlService` in the
program's place (the upper reading is the control's smallest), and prints
one JSON line a run and a summary line. Needs the card, as the cell does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lear_bench import harness
    from lear_bench.control import ControlService

    cell = harness.load_cell(args.workload)
    worst: dict[str, float] = {}
    best: dict[str, float] = {}
    runs = [(s, "program", None) for s in args.seeds]
    runs += [(s, "control", ControlService) for s in args.control_seeds]
    for seed, side, service in runs:
        r = harness.run(cell, seed, args.seconds, False, args.device, time.perf_counter(),
                        service=service)
        numbers = {k: v["value"] for k, v in r["check"].items()}
        print(json.dumps({"seed": seed, "side": side, "correct": r["correct"],
                          "attempted": r["attempted"], "numbers": numbers}), flush=True)
        into, pick = (worst, max) if side == "program" else (best, min)
        for k, v in numbers.items():
            into[k] = pick(into.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
