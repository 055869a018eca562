"""DLRM RM2: dot interaction, MLPerf/Criteo-TB table sizes.
[arXiv:1906.00091; paper]

Table row counts are the published Criteo-Terabyte cardinalities used by
MLPerf DLRM — ~188M rows total × dim 64, the "huge sparse embedding"
regime; rows are model-axis sharded and trained with row-wise Adagrad
(the production DLRM optimizer — full-state optimizers triple table
memory for no accuracy gain at this scale).
"""

from repro_torch.configs.base import RecSysConfig, recsys_shapes

_CRITEO_TB_VOCABS = (
    45_833_188, 36_746, 17_245, 7_413, 20_243, 3, 7_114, 1_441, 62,
    29_275_261, 1_572_176, 345_138, 10, 2_209, 11_267, 128, 4, 974, 14,
    48_937_457, 11_316_796, 40_094_537, 452_104, 12_606, 104, 35,
)


def config() -> RecSysConfig:
    return RecSysConfig(
        name="dlrm-rm2",
        family="dlrm",
        embed_dim=64,
        n_dense=13,
        n_sparse=26,
        vocab_sizes=_CRITEO_TB_VOCABS,
        bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1),
        optimizer="adagrad_rowwise",
        shapes=recsys_shapes(),
    )


def smoke_config() -> RecSysConfig:
    return RecSysConfig(
        name="dlrm-rm2-smoke",
        family="dlrm",
        embed_dim=8,
        n_dense=13,
        n_sparse=4,
        vocab_sizes=(64, 128, 32, 256),
        bot_mlp=(32, 16, 8),
        top_mlp=(32, 16, 1),
        optimizer="adagrad_rowwise",
        shapes=(),
    )
