"""TS001 — host sync reachable from device scope.

A ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``numpy.asarray`` of a tensor, ``torch.cuda.synchronize()`` or a
``device_get`` inside code reachable from a device-scope root makes the
host wait for the card on every step — the stall the serving step exists
to avoid, and a failure inside a CUDA graph capture. So do the ops that
sync inside ATen because their output's size depends on the data:
``nonzero``, ``masked_select``, ``unique``, one-argument ``torch.where``
and ``repeat_interleave`` without ``output_size``. ``float()``, ``int()``
and ``bool()`` are flagged only on a tensor-tainted value (on host Python
numbers and shapes they are free). Boolean-mask indexing also syncs, but
the analyzer cannot tell a mask from an index without types:
``count_host_transfers`` sees it on the card.
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis.callgraph import FunctionInfo, ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions
from repro_torch.analysis.rules.common import body_nodes, classify_transfer

HINT = (
    "keep the value on the card (torch.where, a device count the kernel "
    "reads, a fixed capacity) or move the read to the host side of the step, "
    "into the one packed device_get"
)


class HostSyncRule:
    code = "TS001"
    name = "host-sync-in-device-scope"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        for func in project.functions_in(project.device_scope):
            mod = project.modules[func.module]
            for node in body_nodes(project, func):
                if not isinstance(node, ast.Call):
                    continue
                transfer = classify_transfer(project, mod, node, func)
                if transfer is not None:
                    yield self._finding(func, node, transfer)
                    continue
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args
                    and project.expr_tainted(func, node.args[0])
                ):
                    yield self._finding(func, node, f"{node.func.id}() on a tensor")

    def _finding(self, func: FunctionInfo, node: ast.Call, what: str) -> Finding:
        return Finding(
            code=self.code,
            path=str(func.path),
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{what} in `{func.qualname}`, which is reachable from "
                "device scope"
            ),
            hint=self.hint,
        )
