"""TS004 — environment reads in device scope.

Engine tunables (``PADDED_CACHE_MAX``, ``LEAF_SELECT_MAX``, the dense
scorer's widths, ...) are read ONCE at
import through ``env_int``, so every step of a process runs under the same
values and a warmed shape stays warm. An ``env_int`` / ``os.environ`` /
``os.getenv`` read inside device scope would be re-read every step — a
host cost on the hot path, and a way for two steps of one configuration
to disagree.
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis.callgraph import ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions
from repro_torch.analysis.rules.common import body_nodes

HINT = (
    "read the environment once at module scope (see env_int in "
    "kernels/ops.py) and use the module constant in the step"
)


class EnvReadRule:
    code = "TS004"
    name = "env-read-in-device-scope"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        for func in project.functions_in(project.device_scope):
            mod = project.modules[func.module]
            for node in body_nodes(project, func):
                what = None
                if isinstance(node, ast.Call):
                    canon = project.canonical(mod, node.func)
                    resolved = project.resolve_canonical(canon) if canon else None
                    if resolved is not None and resolved.endswith(":env_int"):
                        what = "env_int()"
                    elif canon in ("os.getenv", "os.environ.get"):
                        what = canon + "()"
                elif isinstance(node, ast.Subscript):
                    if project.canonical(mod, node.value) == "os.environ":
                        what = "os.environ[...]"
                if what is not None:
                    yield Finding(
                        code=self.code,
                        path=str(func.path),
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"{what} read inside `{func.qualname}`, which is "
                            "reachable from device scope"
                        ),
                        hint=self.hint,
                    )
