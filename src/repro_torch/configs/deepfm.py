"""DeepFM on Criteo-style 39 sparse fields. [arXiv:1703.04247; paper]

One concatenated embedding table (global ids = field offsets + local ids),
row-sharded over the model axis. Field vocabularies follow Criteo-Kaggle
magnitudes (13 integer-bucket fields + 26 categorical).
"""

from repro_torch.configs.base import RecSysConfig, recsys_shapes

# 39 field vocab sizes, Criteo-Kaggle-like magnitudes.
_VOCABS = tuple(
    [64] * 13  # bucketized integer features
    + [
        1_460, 584, 10_131_227, 2_202_608, 306, 24, 12_518, 634, 4, 93_146,
        5_684, 8_351_593, 3_195, 28, 14_992, 5_461_306, 11, 5_653, 2_173,
        4, 7_046_547, 18, 16, 286_181, 105, 142_572,
    ]
)


def config() -> RecSysConfig:
    return RecSysConfig(
        name="deepfm",
        family="deepfm",
        embed_dim=10,
        n_sparse=39,
        vocab_sizes=_VOCABS,
        mlp=(400, 400, 400),
        shapes=recsys_shapes(),
    )


def smoke_config() -> RecSysConfig:
    return RecSysConfig(
        name="deepfm-smoke",
        family="deepfm",
        embed_dim=4,
        n_sparse=6,
        vocab_sizes=(16, 32, 64, 16, 8, 128),
        mlp=(32, 32),
        shapes=(),
    )
