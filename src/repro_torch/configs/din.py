"""DIN: target attention over user behavior. [arXiv:1706.06978; paper]

Item vocabulary sized to Amazon-Books (the paper's public benchmark).
"""

from repro_torch.configs.base import RecSysConfig, recsys_shapes


def config() -> RecSysConfig:
    return RecSysConfig(
        name="din",
        family="din",
        embed_dim=18,
        seq_len=100,
        attn_mlp=(80, 40),
        mlp=(200, 80),
        item_vocab=367_984,     # Amazon-Books goods count
        shapes=recsys_shapes(),
    )


def smoke_config() -> RecSysConfig:
    return RecSysConfig(
        name="din-smoke",
        family="din",
        embed_dim=8,
        seq_len=12,
        attn_mlp=(16, 8),
        mlp=(24, 12),
        item_vocab=500,
        shapes=(),
    )
