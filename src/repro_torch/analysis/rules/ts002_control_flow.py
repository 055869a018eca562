"""TS002 — Python control flow on tensor values in device scope.

In eager PyTorch a bare ``if``/``while`` on a value derived from tensors
calls ``Tensor.__bool__``: the host waits for the card to learn the
branch, every step. Branching on shapes, dtypes, devices, host-annotated
(``int``/``str``/config) parameters, or ``is None`` checks is host Python
and fine.
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis.callgraph import ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions
from repro_torch.analysis.rules.common import body_nodes

HINT = (
    "use torch.where / masks for data-dependent choices, or let the kernel "
    "read the value on the card; if the value is really host data, annotate "
    "the parameter with its host type (int, str, ...)"
)


class TensorControlFlowRule:
    code = "TS002"
    name = "python-control-flow-on-tensor"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        for func in project.functions_in(project.device_scope):
            for node in body_nodes(project, func):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                if isinstance(node, ast.While) and isinstance(node.test, ast.Constant):
                    continue
                if project.expr_tainted(func, node.test):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield Finding(
                        code=self.code,
                        path=str(func.path),
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{kind}` on a tensor value in `{func.qualname}` "
                            "(device scope)"
                        ),
                        hint=self.hint,
                    )
