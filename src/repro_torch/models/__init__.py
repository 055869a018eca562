"""Models of the port: the hybrid cascade's distilled dense scorer, the
RecSys family, the LM decoder (dense and MoE), NequIP, and the model-cell
API (``make_cell``) over them and the paper's forest."""

from repro_torch.models.dense_scorer import (
    DenseScorer,
    dense_params_from_numpy,
    dense_score,
    init_dense_scorer,
)
from repro_torch.models.nequip import nequip_params_from_numpy, nequip_params_to_numpy
from repro_torch.models.recsys import recsys_params_from_numpy, recsys_params_to_numpy
from repro_torch.models.transformer import (
    transformer_params_from_numpy,
    transformer_params_to_numpy,
)

__all__ = [
    "DenseScorer", "dense_params_from_numpy", "dense_score", "init_dense_scorer",
    "nequip_params_from_numpy", "nequip_params_to_numpy",
    "recsys_params_from_numpy", "recsys_params_to_numpy",
    "transformer_params_from_numpy", "transformer_params_to_numpy",
]
