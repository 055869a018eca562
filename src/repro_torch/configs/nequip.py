"""NequIP: E(3)-equivariant interatomic potential. [arXiv:2101.03164; paper]"""

from repro_torch.configs.base import NequIPConfig, gnn_shapes


def config() -> NequIPConfig:
    return NequIPConfig(
        name="nequip",
        n_layers=5,
        d_hidden=32,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
        shapes=gnn_shapes(),
    )


def smoke_config() -> NequIPConfig:
    return NequIPConfig(
        name="nequip-smoke",
        n_layers=2,
        d_hidden=8,
        l_max=2,
        n_rbf=4,
        cutoff=5.0,
        shapes=(),
    )
