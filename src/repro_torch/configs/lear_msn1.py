"""The paper's own architecture: λ-MART ensemble (MSN-1 scale) + LEAR
cascade. 1,047 trees / 64 leaves / 136 features, sentinel 50, 10-tree
Continue/Exit classifier — exactly Table 1's setting."""

from repro_torch.configs.base import ForestConfig, forest_shapes

__all__ = ["ForestConfig", "config", "smoke_config"]


def config() -> ForestConfig:
    return ForestConfig(
        name="lear-msn1",
        n_trees=1047,
        depth=6,
        n_features=136,
        sentinel=50,
        classifier_trees=10,
        max_docs=256,
        shapes=forest_shapes(),
    )


def smoke_config() -> ForestConfig:
    return ForestConfig(
        name="lear-msn1-smoke",
        n_trees=24,
        depth=4,
        n_features=16,
        sentinel=6,
        classifier_trees=4,
        max_docs=32,
        shapes=(),
    )
