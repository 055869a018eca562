"""The paper's own architecture: λ-MART ensemble (MSN-1 scale) + LEAR
cascade. 1,047 trees / 64 leaves / 136 features, sentinel 50, 10-tree
Continue/Exit classifier — exactly Table 1's setting.

The port's own copy of ``repro.configs.lear_msn1`` and of the fields of
``repro.configs.base.ForestConfig`` the serving path reads.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """The paper's own architecture: λ-MART ensemble + LEAR cascade."""

    name: str
    n_trees: int = 1047
    depth: int = 6
    n_features: int = 136
    sentinel: int = 50
    classifier_trees: int = 10
    # The classifier forest's depth: the reference trains it with
    # GBDTParams(n_trees=10, depth=5) (repro.core.lear.train_lear), so it
    # has 31 internal nodes and 32 leaves.
    classifier_depth: int = 5
    max_docs: int = 256


def config() -> ForestConfig:
    return ForestConfig(
        name="lear-msn1",
        n_trees=1047,
        depth=6,
        n_features=136,
        sentinel=50,
        classifier_trees=10,
        max_docs=256,
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
    )
