"""Logical-axis sharding on ``torch.distributed``'s ``DeviceMesh``: the
port of :mod:`repro.distributed` (``spec_to_placements`` in place of
``spec_to_sharding``)."""

from repro_torch.distributed.sharding import (
    Rules,
    constrain,
    current_rules,
    local_rules,
    multi_pod_rules,
    resolve,
    sharding_rules,
    single_pod_rules,
    spec_to_placements,
)

__all__ = [
    "Rules",
    "single_pod_rules",
    "multi_pod_rules",
    "local_rules",
    "sharding_rules",
    "current_rules",
    "constrain",
    "resolve",
    "spec_to_placements",
]
