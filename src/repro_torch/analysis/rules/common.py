"""Shared helpers for the rule modules."""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import FunctionInfo, ModuleInfo, ProjectIndex

# Host reads by method: ``t.item()`` and friends (``to`` only with a CPU
# target, see :func:`classify_transfer`).
_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# Operations that sync inside ATen: their output's size depends on the
# data, so the host reads it back (``repeat_interleave`` only without
# ``output_size``; ``torch.where`` only with the condition alone).
_DATA_SIZED_OPS = frozenset({"nonzero", "masked_select", "unique", "unique_consecutive"})


def body_nodes(project: ProjectIndex, func: FunctionInfo) -> Iterator[ast.AST]:
    """All AST nodes in a function's OWN body: nested function/lambda
    subtrees are skipped (they are analyzed as their own functions)."""
    if isinstance(func.node, ast.Lambda):
        roots: list[ast.AST] = [func.node.body]
    else:
        roots = list(func.node.body)

    def walk(node: ast.AST) -> Iterator[ast.AST]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        yield node
        for child in ast.iter_child_nodes(node):
            yield from walk(child)

    for root in roots:
        yield from walk(root)


def _names_cpu(expr: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    return (
        isinstance(expr, ast.Call) and bool(expr.args)
        and isinstance(expr.args[0], ast.Constant) and expr.args[0].value == "cpu"
    )


def classify_transfer(
    project: ProjectIndex, mod: ModuleInfo, call: ast.Call, func: FunctionInfo
) -> str | None:
    """Name the device→host read a call performs, or None.

    The explicit one is a call of a transfer primitive (``device_get``).
    The others: ``torch.cuda.synchronize``, ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``numpy.asarray`` /
    ``numpy.array`` of a tensor-tainted value, and the ops that sync
    inside ATen (``nonzero``, ``masked_select``, ``unique``,
    ``repeat_interleave`` without ``output_size``, one-argument
    ``torch.where``), as functions or methods.
    """
    canon = project.canonical(mod, call.func)
    if canon is not None:
        resolved = project.resolve_canonical(canon)
        if resolved is not None and resolved.endswith(config.TRANSFER_PRIMITIVE_SUFFIXES):
            return resolved.rsplit(":", 1)[-1] + "()"
        if canon == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        root, _, leaf = canon.rpartition(".")
        if (
            root == "numpy" and leaf in ("asarray", "array") and call.args
            and project.expr_tainted(func, call.args[0])
        ):
            return f"numpy.{leaf} of a tensor"
        if root == "torch" and leaf == "where" and len(call.args) == 1 and not call.keywords:
            return "torch.where(condition)"
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    base = project.canonical(mod, call.func.value) or ""
    if base.split(".")[0] in ("numpy", "math"):
        return None
    on_torch = base == "torch"
    if attr in _READ_METHODS and not on_torch and not call.args and not call.keywords:
        return f".{attr}()"
    if attr == "to" and not on_torch and (
        any(_names_cpu(a) for a in call.args)
        or any(kw.arg == "device" and _names_cpu(kw.value) for kw in call.keywords)
    ):
        return '.to("cpu")'
    if attr in _DATA_SIZED_OPS:
        return f"{attr}()"
    if attr == "repeat_interleave" and not any(kw.arg == "output_size" for kw in call.keywords):
        return "repeat_interleave() without output_size"
    return None
