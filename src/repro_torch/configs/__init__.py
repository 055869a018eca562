"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The port's copy of :mod:`repro.configs`.

10 assigned architectures + the paper's own λ-MART/LEAR forest config.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ArchConfig,
    ForestConfig,
    NequIPConfig,
    RecSysConfig,
    ShapeSpec,
    TransformerConfig,
)

_MODULES = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "nequip": "repro_torch.configs.nequip",
    "bert4rec": "repro_torch.configs.bert4rec",
    "din": "repro_torch.configs.din",
    "deepfm": "repro_torch.configs.deepfm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "lear-msn1": "repro_torch.configs.lear_msn1",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "lear-msn1")


def list_archs() -> tuple[str, ...]:
    return tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(_MODULES[name]).config()


def get_smoke_config(name: str) -> ArchConfig:
    return importlib.import_module(_MODULES[name]).smoke_config()


__all__ = [
    "ArchConfig",
    "ForestConfig",
    "NequIPConfig",
    "RecSysConfig",
    "ShapeSpec",
    "TransformerConfig",
    "ASSIGNED_ARCHS",
    "list_archs",
    "get_config",
    "get_smoke_config",
]
