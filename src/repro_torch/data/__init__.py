"""Data of the port: the synthetic LETOR datasets and the resumable
pipelines (numpy, host side)."""

from repro_torch.data.pipeline import QueryBatcher, TokenPipeline
from repro_torch.data.synthetic import PRESETS, LetorDataset, LetorPreset, make_letor_dataset

__all__ = [
    "LetorDataset", "LetorPreset", "make_letor_dataset", "PRESETS", "QueryBatcher",
    "TokenPipeline",
]
