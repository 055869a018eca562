"""End to end on the PyTorch port: a batched ranking SERVICE with LEAR
early exit, as ``examples/serve_ranking.py`` on ``repro_torch``.

Trains the full stack (λ-MART teacher + LEAR classifier), then serves
query batches through :class:`repro_torch.serve.RankingService` —
compacted tail execution through the forest kernel on the card (its plain
version on the CPU), capacity adaptation, and the service-level stats.

    PYTHONPATH=src python examples/torch_serve_ranking.py                  # on the card
    PYTHONPATH=src python examples/torch_serve_ranking.py --device cpu --smoke
"""

import argparse

import numpy as np
import torch

from repro_torch.core.lear import train_lear
from repro_torch.data.pipeline import QueryBatcher
from repro_torch.data.synthetic import make_letor_dataset
from repro_torch.forest.gbdt import GBDTParams, train_lambdamart
from repro_torch.metrics.ranking import mean_ndcg
from repro_torch.serve.ranking_service import RankingService, ServiceConfig
from repro_torch.utils import resolve_device


def main(device: str | None = None, smoke: bool = False):
    dev = resolve_device(device)
    n_queries, n_trees, sentinel, batches = (60, 24, 4, 3) if smoke else (160, 64, 6, 6)
    data = make_letor_dataset("msn1", n_queries=n_queries, n_features=48,
                              docs_scale=0.25, seed=3)
    splits = data.splits()
    train, cls_split, test = splits["train"], splits["classifier"], splits["test"]

    print(f"training λ-MART ({n_trees} trees) + LEAR...")
    ranker = train_lambdamart(
        train.X, train.labels.astype(np.float32), train.mask,
        GBDTParams(n_trees=n_trees, depth=5, learning_rate=0.15), k=10, device=dev,
    )
    clf = train_lear(cls_split.X, cls_split.labels, cls_split.mask, ranker,
                     sentinel=sentinel, k=15)

    service = RankingService(ranker, clf, ServiceConfig(threshold=0.3), device=dev)
    batcher = QueryBatcher(n_queries=test.n_queries, batch_queries=8)

    print(f"serving {batches} batches of 8 queries...")
    ndcgs = []
    for _ in range(batches):
        idx = batcher.next_indices()
        mask = test.mask[idx]
        _, scores = service.rank_batch(test.X[idx], mask)
        ndcgs.append(float(mean_ndcg(torch.as_tensor(np.asarray(scores)),
                                     torch.as_tensor(test.labels[idx]),
                                     torch.as_tensor(mask), 10)))

    s = service.stats
    print(f"\nservice stats after {s.batches} batches:")
    print(f"  queries        : {s.queries}")
    print(f"  docs scored    : {s.docs}")
    print(f"  continue rate  : {s.continue_rate:.1%}")
    print(f"  overflow docs  : {s.overflow_docs}")
    print(f"  speedup (trees): {s.speedup:.2f}x vs full ensemble")
    print(f"  NDCG@10 (mean) : {np.mean(ndcgs):.4f}")
    # Resumable service state (fault-tolerance contract).
    print(f"  batcher cursor : {batcher.state()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for tests")
    main(**vars(ap.parse_args()))
