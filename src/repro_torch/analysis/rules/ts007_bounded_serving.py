"""TS007 — unbounded growth / blind excepts in serving worker loops.

The serving tier's overload behavior is DEFINED (admission control sheds,
deadlines expire, the supervisor restarts) only while two disciplines
hold inside the worker-loop classes
(:data:`repro_torch.analysis.config.WORKER_LOOP_CLASSES`):

1. **Every buffer is bounded.** A ``collections.deque()`` without
   ``maxlen``, a ``queue.Queue()`` without ``maxsize`` (or a
   ``SimpleQueue``, which cannot be bounded), or a ``self.*.append`` /
   ``extend`` inside a ``while True`` loop grows without limit under
   overload — the failure mode the admission-control layer exists to
   prevent, reintroduced by the implementation.
2. **No blind exception handlers.** A bare ``except:`` or
   ``except BaseException`` inside these classes swallows worker death
   (KeyboardInterrupt, injected kills, MemoryError) that the supervisor
   must observe to restart the worker and fail in-flight futures.

Deliberate catch-alls (the supervisor's own guard is one — it exists to
BE the catch-all) carry a ``# repro: noqa(TS007) -- why`` justification.
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import FunctionInfo, ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions

HINT = (
    "bound the buffer (deque(maxlen=…), Queue(maxsize=…), admission-"
    "checked dict/list) or catch a typed exception; a deliberate "
    "catch-all needs `# repro: noqa(TS007) -- why`"
)

_GROW_METHODS = frozenset({"append", "appendleft", "extend", "extendleft"})
_QUEUE_TYPES = frozenset({"Queue", "LifoQueue", "PriorityQueue"})


def _last_name(node: ast.expr) -> str | None:
    """Rightmost identifier of a Name/Attribute chain (``queue.Queue`` →
    ``Queue``), or None for anything else."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _rooted_at_self(node: ast.expr) -> bool:
    """True when an attribute/subscript chain bottoms out at ``self``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return isinstance(node, ast.Name) and node.id == "self"


class BoundedServingRule:
    code = "TS007"
    name = "unbounded-growth-or-blind-except-in-worker-loop"
    hint = HINT

    @staticmethod
    def _blind_handler(node: ast.ExceptHandler) -> str | None:
        if node.type is None:
            return "bare `except:`"
        if _last_name(node.type) == "BaseException":
            return "`except BaseException`"
        return None

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        for func in project.functions.values():
            if (func.class_name or "") not in config.WORKER_LOOP_CLASSES:
                continue
            if isinstance(func.node, ast.Lambda):
                continue
            for node in ast.walk(func.node):
                if isinstance(node, ast.ExceptHandler):
                    what = self._blind_handler(node)
                    if what is not None:
                        yield Finding(
                            code=self.code,
                            path=str(func.path),
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"{what} in `{func.qualname}` swallows "
                                "worker death the supervisor must observe"
                            ),
                            hint=self.hint,
                        )
                elif isinstance(node, ast.Call):
                    ctor = _last_name(node.func)
                    kwargs = {kw.arg for kw in node.keywords}
                    if (
                        ctor == "deque"
                        and len(node.args) < 2
                        and "maxlen" not in kwargs
                    ):
                        yield self._unbounded(func, node, "deque without maxlen")
                    elif ctor == "SimpleQueue":
                        yield self._unbounded(
                            func, node, "SimpleQueue (cannot be bounded)"
                        )
                    elif (
                        ctor in _QUEUE_TYPES
                        and not node.args
                        and "maxsize" not in kwargs
                    ):
                        yield self._unbounded(
                            func, node, f"{ctor} without maxsize"
                        )
                elif (
                    isinstance(node, ast.While)
                    and isinstance(node.test, ast.Constant)
                    and node.test.value is True
                ):
                    for sub in ast.walk(node):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in _GROW_METHODS
                            and _rooted_at_self(sub.func.value)
                        ):
                            yield self._unbounded(
                                func, sub,
                                f"self-state .{sub.func.attr}() inside "
                                "`while True`",
                            )

    def _unbounded(
        self, func: FunctionInfo, node: ast.AST, what: str
    ) -> Finding:
        return Finding(
            code=self.code,
            path=str(func.path),
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"unbounded growth in `{func.qualname}`: {what} — "
                "overload becomes OOM instead of typed shedding"
            ),
            hint=self.hint,
        )
