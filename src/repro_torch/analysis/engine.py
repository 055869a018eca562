"""The analysis engine: file discovery, suppression parsing, rule running,
and finding formatting (the port of :mod:`repro.analysis.engine`).

Suppression syntax (checked per physical line)::

    risky_call()  # repro: noqa(TS001)
    other()       # repro: noqa(TS001,TS003) -- why this is safe

A suppressed finding is dropped; rules that COUNT sites (TS006) consult
suppression themselves so a waived site does not poison the count.
"""

from __future__ import annotations

import json
import re
from collections.abc import Iterable, Sequence
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.callgraph import ProjectIndex

NOQA_RE = re.compile(r"#\s*repro:\s*noqa\(\s*([A-Z0-9_,\s]+?)\s*\)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str
    path: str
    line: int
    col: int
    message: str
    hint: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"
            f"\n    hint: {self.hint}"
        )

    def as_dict(self) -> dict[str, object]:
        return {
            "code": self.code, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message, "hint": self.hint,
        }


class Suppressions:
    """Per-file map of line → suppressed rule codes."""

    def __init__(self) -> None:
        self._by_file: dict[str, dict[int, set[str]]] = {}

    def load(self, path: Path, lines: Sequence[str]) -> None:
        per_line: dict[int, set[str]] = {}
        for i, text in enumerate(lines, start=1):
            match = NOQA_RE.search(text)
            if not match:
                continue
            codes = {c.strip() for c in match.group(1).split(",") if c.strip()}
            target = i
            if text.lstrip().startswith("#"):
                # a comment-only noqa (usually followed by justification
                # comment lines) waives the next CODE line
                for j in range(i + 1, len(lines) + 1):
                    stripped = lines[j - 1].strip()
                    if stripped and not stripped.startswith("#"):
                        target = j
                        break
            per_line.setdefault(target, set()).update(codes)
        self._by_file[str(path)] = per_line

    def is_suppressed(self, path: str | Path, line: int, code: str) -> bool:
        return code in self._by_file.get(str(path), {}).get(line, set())


def discover(paths: Iterable[str | Path]) -> list[Path]:
    """Expand files/directories into the sorted .py file set."""
    out: list[Path] = []
    for raw in paths:
        path = Path(raw)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def run_paths(
    paths: Iterable[str | Path],
    codes: Iterable[str] | None = None,
) -> list[Finding]:
    """Run all (or selected) rules over the given files/directories."""
    from repro_torch.analysis.rules import all_rules

    files = discover(paths)
    project = ProjectIndex(files)
    suppressions = Suppressions()
    for mod in project.modules.values():
        suppressions.load(mod.path, mod.source_lines)

    wanted = set(codes) if codes is not None else None
    findings: list[Finding] = []
    for rule in all_rules():
        if wanted is not None and rule.code not in wanted:
            continue
        findings.extend(rule.check(project, suppressions))
    findings = [
        f
        for f in findings
        if not suppressions.is_suppressed(f.path, f.line, f.code)
    ]
    for path, err in project.errors:
        findings.append(
            Finding(
                code="TS000", path=str(path), line=1, col=0,
                message=f"file could not be parsed: {err}",
                hint="fix the syntax error; the analyzer needs a parseable tree",
            )
        )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def format_findings(findings: list[Finding], fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps([f.as_dict() for f in findings], indent=2)
    if not findings:
        return "repro_torch.analysis: no findings"
    lines = [f.format() for f in findings]
    lines.append(f"repro_torch.analysis: {len(findings)} finding(s)")
    return "\n".join(lines)
