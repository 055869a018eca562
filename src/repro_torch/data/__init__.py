"""Data of the port: the synthetic LETOR datasets, the resumable
pipelines and the CSR neighbor sampler (numpy, host side)."""

from repro_torch.data.graph_sampler import CSRGraph, sample_neighbors
from repro_torch.data.pipeline import QueryBatcher, TokenPipeline
from repro_torch.data.synthetic import PRESETS, LetorDataset, LetorPreset, make_letor_dataset

__all__ = [
    "CSRGraph", "LetorDataset", "LetorPreset", "make_letor_dataset", "PRESETS", "QueryBatcher",
    "TokenPipeline", "sample_neighbors",
]
