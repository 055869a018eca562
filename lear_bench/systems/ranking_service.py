"""``repro_torch.serve.ranking_service.RankingService`` over the drawn
weights, which it receives through ``forest.ensemble.from_complete_arrays``;
its ``ServiceConfig`` is the configuration's ``service`` group."""

from __future__ import annotations


def build(
    ranker: dict, clfs: list[dict], sentinels: tuple[int, ...], cfg: dict,
    threshold: float, dev: object,
) -> object:
    from repro_torch.core.lear import LearClassifier
    from repro_torch.forest.ensemble import from_complete_arrays
    from repro_torch.serve.ranking_service import RankingService, ServiceConfig

    def forest(w: dict):
        host = {k: v.cpu().numpy() for k, v in w.items()}
        return from_complete_arrays(
            host["feature"], host["threshold"], host["leaf_value"], device=dev
        )

    program_clfs = [LearClassifier(forest(c), s) for c, s in zip(clfs, sentinels)]
    return RankingService(
        forest(ranker), program_clfs[0],
        ServiceConfig(threshold=threshold, top_k=cfg["top_k"], **cfg["service"]),
        extra_classifiers=program_clfs[1:], device=dev,
    )
