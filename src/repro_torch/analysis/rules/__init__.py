"""Rule registry for the analyzer.

A rule is an object with a ``code`` (``TS00x``), a ``name``, a ``hint``
(the one-line fix shown under every finding), and a
``check(project, suppressions) -> Iterator[Finding]`` method. To add a
rule: create ``tsNNN_short_name.py`` beside the existing seven (duck
typing, no base class) and append an instance to :func:`all_rules`.
"""

from __future__ import annotations

from repro_torch.analysis.rules.ts001_host_sync import HostSyncRule
from repro_torch.analysis.rules.ts002_control_flow import TensorControlFlowRule
from repro_torch.analysis.rules.ts003_reassociation import ReassociationRule
from repro_torch.analysis.rules.ts004_env_reads import EnvReadRule
from repro_torch.analysis.rules.ts005_thread_discipline import ThreadDisciplineRule
from repro_torch.analysis.rules.ts006_single_device_get import SingleDeviceGetRule
from repro_torch.analysis.rules.ts007_bounded_serving import BoundedServingRule


def all_rules() -> list:
    """The active rule set, in error-code order."""
    return [
        HostSyncRule(),
        TensorControlFlowRule(),
        ReassociationRule(),
        EnvReadRule(),
        ThreadDisciplineRule(),
        SingleDeviceGetRule(),
        BoundedServingRule(),
    ]


__all__ = [
    "BoundedServingRule",
    "EnvReadRule",
    "HostSyncRule",
    "ReassociationRule",
    "SingleDeviceGetRule",
    "TensorControlFlowRule",
    "ThreadDisciplineRule",
    "all_rules",
]
