"""BERT4Rec on ML-20M-scale item vocabulary. [arXiv:1904.06690; paper]"""

from repro_torch.configs.base import RecSysConfig, recsys_shapes


def config() -> RecSysConfig:
    return RecSysConfig(
        name="bert4rec",
        family="bert4rec",
        embed_dim=64,
        n_blocks=2,
        n_heads=2,
        seq_len=200,
        item_vocab=26744,       # ML-20M items (paper's largest dataset)
        shapes=recsys_shapes(),
    )


def smoke_config() -> RecSysConfig:
    return RecSysConfig(
        name="bert4rec-smoke",
        family="bert4rec",
        embed_dim=16,
        n_blocks=2,
        n_heads=2,
        seq_len=20,
        item_vocab=200,
        shapes=(),
    )
