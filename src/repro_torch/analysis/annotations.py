"""Annotation completeness of the port's serving packages.

The port of the stdlib tier of ``tools/check_types.py``: every module- and
class-level function in the target set must annotate all its parameters
and its return type. Nested functions are exempt — they are closures
whose operands are deliberately left unannotated, and the analyzer's
taint pass treats unannotated parameters as tensors. Waive a def line with
``# repro: noqa(TYP)``. (The reference's second tier, mypy under
``mypy.ini``, is not ported: that file configures the reference's
packages only.)

Run from the repository root::

    python -m repro_torch.analysis.annotations [paths...]

Exit status 1 when a function misses an annotation.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from collections.abc import Iterator
from pathlib import Path

# The serving packages, relative to the repository root.
TARGETS: tuple[str, ...] = (
    "src/repro_torch/kernels",
    "src/repro_torch/core",
    "src/repro_torch/serve",
    "src/repro_torch/metrics",
    "src/repro_torch/analysis",
    "src/repro_torch/typecheck.py",
    "src/repro_torch/utils.py",
)

NOQA_TYP_RE = re.compile(r"#\s*repro:\s*noqa\(\s*TYP\s*\)")


def target_files(paths: list[str]) -> list[Path]:
    files: list[Path] = []
    for raw in paths:
        path = Path(raw)
        files.extend(sorted(path.rglob("*.py")) if path.is_dir() else [path])
    return files


def _top_level_functions(tree: ast.Module) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    """Module-level functions and class methods; nested defs excluded."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield item


def check_annotations(files: list[Path]) -> list[str]:
    """One line per missing annotation (``path:line: TYPnnn ...``)."""
    problems: list[str] = []
    for path in files:
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as exc:
            problems.append(f"{path}:1: TYP000 unparseable: {exc}")
            continue
        lines = source.splitlines()
        for func in _top_level_functions(tree):
            if NOQA_TYP_RE.search(lines[func.lineno - 1]):
                continue
            args = [
                *func.args.posonlyargs, *func.args.args, *func.args.kwonlyargs,
                *([func.args.vararg] if func.args.vararg else []),
                *([func.args.kwarg] if func.args.kwarg else []),
            ]
            for arg in args:
                if arg.arg not in ("self", "cls") and arg.annotation is None:
                    problems.append(
                        f"{path}:{func.lineno}: TYP001 `{func.name}` parameter "
                        f"`{arg.arg}` is unannotated"
                    )
            if func.returns is None:
                problems.append(f"{path}:{func.lineno}: TYP002 `{func.name}` has no return annotation")
    return problems


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.annotations",
        description="annotation completeness of the port's serving packages",
    )
    parser.add_argument(
        "paths", nargs="*", default=list(TARGETS),
        help="files or directories (default: the serving packages)",
    )
    args = parser.parse_args(argv)
    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        parser.error(f"no such path(s): {', '.join(missing)}")
    files = target_files(args.paths)
    problems = check_annotations(files)
    for problem in problems:
        print(problem)
    if not problems:
        print(f"repro_torch.analysis.annotations: OK ({len(files)} files)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
