"""Progressive-engine serving walkthrough on the PyTorch port, as
``examples/serve_progressive.py`` on ``repro_torch``:

1. calibrate ``launch_overhead_trees`` from a measured timing probe;
2. build a two-stage LEAR cascade (two classifiers, two sentinels) whose
   augmented features are built on the device inside the step;
3. serve traffic whose continue rate SHIFTS mid-stream and watch the
   execution-mode pick follow it (staged on sparse traffic, fused on
   dense);
4. read the per-stage capacities and the service stats.

Unlike the reference, the port picks the mode on the host:
:class:`repro_torch.serve.RankingService` (``execution_mode="auto"``)
prices fused against staged from its smoothed survivor counts before each
batch, where the reference picks inside its compiled step with
``lax.cond``, which the port leaves out by design.

    PYTHONPATH=src python examples/torch_serve_progressive.py                  # on the card
    PYTHONPATH=src python examples/torch_serve_progressive.py --device cpu --smoke
"""

import argparse

import numpy as np

from repro_torch.core.lear import train_lear
from repro_torch.data.synthetic import make_letor_dataset
from repro_torch.forest.gbdt import GBDTParams, train_lambdamart
from repro_torch.serve.calibration import calibrate_launch_overhead_trees
from repro_torch.serve.ranking_service import RankingService, ServiceConfig
from repro_torch.utils import resolve_device


def _shifted_batches(ds, rng, batch_queries, n_batches, sparse_first):
    """Yield query batches; the first half resamples toward queries with
    few relevant docs (sparse survivors), the second half toward many."""
    rel_per_q = (ds.labels > 0).sum(axis=1)
    order = np.argsort(rel_per_q)
    half = n_batches // 2
    for b in range(n_batches):
        pool = order[: len(order) // 2] if (b < half) == sparse_first \
            else order[len(order) // 2:]
        idx = rng.choice(pool, size=batch_queries, replace=True)
        yield ds.X[idx], ds.mask[idx]


def main(device: str | None = None, smoke: bool = False):
    dev = resolve_device(device)
    if smoke:
        n_queries, n_feat, n_trees, batches, bq = 40, 16, 32, 4, 2
        sentinels = (4, 12)
    else:
        n_queries, n_feat, n_trees, batches, bq = 160, 48, 64, 10, 8
        sentinels = (6, 20)

    # 1. Calibrate the cost model's launch price from measurement. The
    # service default launch_overhead_trees="auto" does exactly this
    # (cached per process); we call it explicitly to show the number.
    overhead = calibrate_launch_overhead_trees(dev)
    print(f"calibrated launch_overhead_trees ≈ {overhead:.0f} doc·trees")

    print(f"training λ-MART ({n_trees} trees) + 2 LEAR classifiers...")
    data = make_letor_dataset("msn1", n_queries=n_queries,
                              n_features=n_feat, docs_scale=0.25, seed=3)
    splits = data.splits()
    train, cls_split, test = (
        splits["train"], splits["classifier"], splits["test"]
    )
    ranker = train_lambdamart(
        train.X, train.labels.astype(np.float32), train.mask,
        GBDTParams(n_trees=n_trees, depth=4, learning_rate=0.15), k=10, device=dev,
    )
    clf_a, clf_b = (
        train_lear(cls_split.X, cls_split.labels, cls_split.mask, ranker,
                   sentinel=s, k=15)
        for s in sentinels
    )

    # 2. The service: auto execution mode = the host-side fused/staged pick.
    service = RankingService(
        ranker, clf_a,
        ServiceConfig(
            threshold=0.3, execution_mode="auto",
            launch_overhead_trees=overhead, capacity_headroom=1.25,
            survivor_ema=0.5, top_k=10,
        ),
        extra_classifiers=[clf_b],
        device=dev,
    )

    # 3. Shifting traffic: sparse-survivor batches first, dense after.
    rng = np.random.default_rng(0)
    print(f"serving {batches} batches of {bq} queries "
          "(sparse → dense traffic shift)...")
    for b, (X, mask) in enumerate(
        _shifted_batches(test, rng, bq, batches, sparse_first=True)
    ):
        staged0 = service.stats.batches_staged
        service.rank_batch(X, mask)
        picked = "staged" if service.stats.batches_staged > staged0 else "fused"
        print(f"  batch {b}: picked={picked:<6} "
              f"capacities={service._pick_capacities(X.shape[0] * X.shape[1])}")

    # 4. Service-level accounting (trees traversed — the paper's metric).
    s = service.stats
    print(f"\nstats after {s.batches} batches "
          f"({s.batches_fused} fused / {s.batches_staged} staged):")
    print(f"  queries        : {s.queries}")
    print(f"  docs scored    : {s.docs}")
    print(f"  continue rate  : {s.continue_rate:.1%}")
    print(f"  overflow docs  : {s.overflow_docs}")
    print(f"  speedup (trees): {s.speedup:.2f}x vs full ensemble")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for tests (tests/test_torch_examples.py runs this)")
    main(**vars(ap.parse_args()))
