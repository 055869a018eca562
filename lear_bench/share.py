"""The continue share an exit threshold gives, worked out by the reference.

    python3 -m lear_bench.share --workload msn1-bulk --queries 512 --seeds 1 2 3

For each seed it draws the cell's weights and one request of ``--queries``
queries (the cell's traffic otherwise), runs :mod:`lear_bench.reference`
in float64 at the cell's threshold, and prints the share of real documents
past each stage; with ``--target`` it also prints the threshold at which
that share of real documents passes the first stage (the quantile of the
first classifier's probabilities over every seed's documents). Runs on the
CPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    sys.path[:0] = [str(ROOT)]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--target", type=float, default=None)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import torch

    from lear_bench import generator, harness, reference, weights

    cell = harness.load_cell(args.workload)
    cfg, wl = cell.config, cell.workload
    sentinels = harness.sentinels_of(cfg)
    traffic = dict(cell.traffic, queries=args.queries, pool=1)
    dev = torch.device(args.device)
    logits = []
    for seed in args.seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        F = cfg["n_features"]
        ranker = weights.draw_ranker(gen, cfg["n_trees"], cfg["depth"], F, dev)
        clfs = [
            weights.draw_classifier(cfg["classifier_seed"] + k, cfg["classifier_trees"],
                                    cfg["classifier_depth"], F + 4, dev)
            for k in range(len(sentinels))
        ]
        X, mask = generator.make_pool(traffic, F, seed, gen, dev).batches[0]
        r = reference.reference(X, mask, ranker, clfs, sentinels, wl["threshold"], cfg["top_k"])
        print(f"seed {seed}: real {r.real}, survivors {r.survivors}, share "
              f"{[round(n / r.real, 6) for n in r.survivors]} at threshold {wl['threshold']}")
        logits.append(r.first_logits[mask])
    if args.target is not None:
        q = torch.quantile(torch.cat(logits), 1.0 - args.target).item()
        print(f"threshold for a first-stage share of {args.target}: "
              f"{1 / (1 + math.exp(-q)):.6f} (logit {q:.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
