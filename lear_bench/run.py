"""Run one cell of the benchmark once and print its result line.

From the root of a checkout::

    python3 -m lear_bench.run --workload msn1-bulk --seed 7 --seconds 10 --trace 0

Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), without the program beside it (``src/``),
or when a module of JAX or of the JAX package is loaded once the window
has closed. With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones (the traced segment follows the
window). The last lines on standard error and the result's ``check`` key
give each number compared against the reference beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    # Caches stay inside the checkout, at fixed paths; the program is
    # imported from the checkout's src/.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "lear_bench" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lear_bench import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, manifest)
    chips = next(w["chips"] for w in manifest["workloads"] if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lear_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    # Each host thread that drives requests on a CPU of its own, the same
    # in every run, and no thread team of torch's spinning beside them.
    result = harness.run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
        pin_cpus=sorted(os.sched_getaffinity(0), reverse=True),
    )
    found = harness.forbidden_modules()
    if found:
        print(f"lear_bench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
