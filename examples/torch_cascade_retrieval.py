"""Beyond-paper, on the PyTorch port: the LEAR cascade generalized to
recsys retrieval, as ``examples/cascade_retrieval.py`` on ``repro_torch``.

Scores 100k candidates for one user with a DLRM-family model in two stages:
a cheap sentinel scorer (embedding dot product) filters candidates, the
full model scores the survivors — the paper's document-level early exit
transplanted onto a neural ranking stack.

    PYTHONPATH=src python examples/torch_cascade_retrieval.py                  # on the card
    PYTHONPATH=src python examples/torch_cascade_retrieval.py --device cpu --smoke
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RecSysConfig
from repro_torch.models import recsys as rec
from repro_torch.serve.ranking_service import TwoStageCascade
from repro_torch.utils import resolve_device


def _synced(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(device: str | None = None, smoke: bool = False):
    dev = resolve_device(device)
    cfg: RecSysConfig = get_smoke_config("dlrm-rm2")
    params = rec.dlrm_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)

    C = 10_000 if smoke else 100_000
    user = {
        "dense": torch.as_tensor(rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
                                 device=dev),
        "sparse": torch.as_tensor(
            np.stack([rng.integers(0, v, size=(1, cfg.multi_hot))
                      for v in cfg.vocab_sizes[:-1]], axis=1).astype(np.int32), device=dev),
    }
    cand_ids = torch.as_tensor(
        rng.integers(0, cfg.vocab_sizes[-1], size=C).astype(np.int32), device=dev)

    # Full scorer: complete DLRM interaction per candidate.
    @torch.no_grad()
    def full_fn(ids):
        return rec.dlrm_score_candidates(cfg, params, {**user, "cand_ids": ids})

    # Sentinel: dot(candidate embedding, user bottom-MLP vector) — the cheap
    # first stage (one gather + one matvec per candidate).
    with torch.no_grad():
        bot = rec._mlp(user["dense"], params, "bot", torch.relu)[0]

    @torch.no_grad()
    def sentinel_fn(ids):
        cand_vec = params[f"tables/t{len(cfg.vocab_sizes) - 1}"][ids.long()]
        return cand_vec @ bot

    # Ground truth = full scoring of everything.
    t0 = _synced(dev)
    full_all = full_fn(cand_ids).cpu().numpy()
    t_full = _synced(dev) - t0
    true_top100 = set(np.argsort(-full_all, kind="stable")[:100].tolist())

    for keep in (0.01, 0.05, 0.2):
        cascade = TwoStageCascade(sentinel_fn, full_fn, keep_fraction=keep)
        t0 = _synced(dev)
        survivors, scores, cheap = cascade.score(cand_ids)
        t_casc = _synced(dev) - t0
        # Survivor *positions* in cand_ids (the cascade keeps top sentinel
        # scores); recall = how many of the true top-100 survive the filter.
        order = torch.sort(cheap, descending=True, stable=True).indices
        surv_pos = set(order[: cascade.keep(C)].tolist())
        recall = len(true_top100 & surv_pos) / 100
        print(
            f"keep={keep:.0%}: sentinel+full over {cascade.keep(C)} survivors, "
            f"top-100 recall={recall:.2f}, "
            f"wall {t_casc:.4f}s vs full {t_full:.4f}s"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true", help="10,000 candidates")
    main(**vars(ap.parse_args()))
