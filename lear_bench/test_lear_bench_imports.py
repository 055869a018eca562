"""Nothing under lear_bench/ imports JAX or the JAX package, and the
yardstick imports nothing of the program (top-level names compared whole:
``repro_torch`` begins with ``repro`` and is another package)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# The yardstick: what it computes may not come from the program.
YARDSTICK = {
    "reference.py", "check.py", "work.py", "weights.py", "generator.py", "trace.py",
}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path",
    [p for p in MODULES if p.name in YARDSTICK or p.parent.name == "metrics"],
    ids=lambda p: str(p.relative_to(BENCH)),
)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_the_scan_sees_every_module():
    assert {p.name for p in MODULES} >= YARDSTICK | {"run.py", "harness.py"}
    # Imports inside functions count too: the harness imports the program there.
    assert "repro_torch" in top_level_imports(BENCH / "harness.py")
