"""TS005 — engine calls from client-facing serving methods.

One worker thread owns the engine: ``ContinuousBatcher._run`` (and the
post-join drain ``_flush``) plus ``ServingTier.start`` (AOT warmup runs
before the worker exists).  Every other method of those classes runs on
CLIENT threads — an engine call there races the worker on the jit
cache, the capacity ratchet, and the per-bucket adaptive state.

The rule flags direct call sites of engine entry points
(``rank_batch``/``rank``/``rank_progressive``/``rank_compacted`` and
``warmup_service``) in non-allowlisted methods of the configured
classes (:data:`repro_torch.analysis.config.SERVE_CLASS_ALLOWED_METHODS`).
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions

HINT = (
    "route the work through the batcher queue (submit -> worker _run -> "
    "_flush); only the worker loop may touch the engine"
)


class ThreadDisciplineRule:
    code = "TS005"
    name = "engine-call-off-worker-thread"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        for func in project.functions.values():
            allowed = config.SERVE_CLASS_ALLOWED_METHODS.get(func.class_name or "")
            if allowed is None:
                continue
            method = func.qualname.split(".", 1)[-1].split(".", 1)[0]
            if method in allowed:
                continue
            mod = project.modules[func.module]
            if isinstance(func.node, ast.Lambda):
                continue
            for node in ast.walk(func.node):
                if not isinstance(node, ast.Call):
                    continue
                what = None
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in config.ENGINE_METHOD_NAMES
                ):
                    what = f".{node.func.attr}()"
                else:
                    canon = project.canonical(mod, node.func)
                    resolved = (
                        project.resolve_canonical(canon) if canon else None
                    )
                    target = resolved or canon
                    if target is not None and any(
                        target.endswith(sfx.lstrip(":"))
                        for sfx in config.ENGINE_FUNCTION_SUFFIXES
                    ):
                        what = target.rsplit(".", 1)[-1] + "()"
                if what is not None:
                    yield Finding(
                        code=self.code,
                        path=str(func.path),
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"engine entry {what} called from "
                            f"`{func.qualname}` — only "
                            f"{sorted(allowed)} of {func.class_name} may "
                            "touch the engine"
                        ),
                        hint=self.hint,
                    )
