"""Quickstart on the PyTorch port: train a λ-MART ranker, attach LEAR early
exit, measure the efficiency/effectiveness trade-off — the paper's pipeline,
as ``examples/quickstart.py`` walks it, on ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py                  # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --smoke
"""

import argparse

import numpy as np
import torch

from repro_torch.core.lear import augment_features, train_lear
from repro_torch.data.synthetic import make_letor_dataset
from repro_torch.forest.gbdt import GBDTParams, train_lambdamart
from repro_torch.forest.scoring import score_bitvector
from repro_torch.metrics.ranking import mean_ndcg
from repro_torch.metrics.speedup import speedup_vs_full
from repro_torch.utils import resolve_device


def main(device: str | None = None, smoke: bool = False):
    dev = resolve_device(device)
    n_queries, n_trees, sentinel = (60, 24, 4) if smoke else (200, 80, 8)

    # 1. A small MSN-1-like dataset (graded labels 0-4).
    data = make_letor_dataset("msn1", n_queries=n_queries, n_features=64,
                              docs_scale=0.3, seed=0)
    splits = data.splits()
    train, cls_split, test = splits["train"], splits["classifier"], splits["test"]

    # 2. λ-MART teacher (NDCG@10 lambda gradients).
    print(f"training λ-MART ({n_trees} trees)...")
    ranker = train_lambdamart(
        train.X, train.labels.astype(np.float32), train.mask,
        GBDTParams(n_trees=n_trees, depth=5, learning_rate=0.15), k=10, device=dev,
    )

    # 3. LEAR classifier at the sentinel (≈10% of the ensemble).
    print("training LEAR classifier...")
    clf = train_lear(cls_split.X, cls_split.labels, cls_split.mask, ranker,
                     sentinel=sentinel, k=15)

    # 4. Evaluate the cascade on the test split.
    Q, D, F = test.X.shape
    X = torch.as_tensor(test.X, device=dev)
    _, per_tree = score_bitvector(ranker, X.reshape(Q * D, F), return_per_tree=True)
    per_tree = per_tree.reshape(Q, D, -1)
    partial = per_tree[..., :sentinel].sum(-1)
    full = per_tree.sum(-1)
    mask = torch.as_tensor(test.mask, device=dev)
    labels = torch.as_tensor(test.labels, device=dev)

    ndcg_full = float(mean_ndcg(full, labels, mask, 10))
    print(f"\nFull ensemble: NDCG@10 = {ndcg_full:.4f}, speedup 1.00x")
    aug = augment_features(X, partial, mask)
    for threshold in (0.1, 0.3, 0.5, 0.7):
        cont = clf.continue_mask(aug, mask, threshold=threshold)
        scores = torch.where(cont, full, partial)
        ndcg = float(mean_ndcg(scores, labels, mask, 10))
        sp = float(speedup_vs_full(cont, mask, sentinel, ranker.n_trees, clf.n_trees))
        print(
            f"LEAR(threshold={threshold:.1f}): NDCG@10 = {ndcg:.4f} "
            f"({100 * (ndcg - ndcg_full) / ndcg_full:+.2f}%), "
            f"speedup {sp:.2f}x"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for tests")
    main(**vars(ap.parse_args()))
