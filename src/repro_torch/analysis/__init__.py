"""Repo-specific static analysis of the port: host-sync and
engine-contract rules over the serving hot path, re-aimed at eager PyTorch.

The port of :mod:`repro.analysis`. Run as ``python -m repro_torch.analysis
[paths...]``; the default target is ``src/repro_torch``. Exit status 1 when
there is an unsuppressed finding. Device scope (the counterpart of the
reference's jit scope) and every project contract are named in
:mod:`repro_torch.analysis.config`. Rules:

- TS001 host syncs in device scope (``.item()``, ``.cpu()``, ``nonzero``, …);
- TS002 Python ``if``/``while`` on a tensor value in device scope;
- TS003 a bare sum or ``+=`` loop on the tree-sum path (plain kernel
  versions, reordering), where ``pairwise_tree_sum`` is required;
- TS004 environment reads in device scope;
- TS005 engine calls off the batcher's worker thread;
- TS006 more than one transfer site reachable from ``rank_batch``;
- TS007 unbounded buffers or blind ``except`` in the worker-loop classes.

A finding that is safe is waived on its line (or on a comment line just
above it) with ``# repro: noqa(TSnnn) -- why``. The annotation-completeness
check of the port's serving packages is
``python -m repro_torch.analysis.annotations``.
"""

from __future__ import annotations

from repro_torch.analysis.engine import Finding, format_findings, run_paths

__all__ = ["Finding", "format_findings", "run_paths", "main"]


def main(argv: list[str] | None = None) -> int:
    """CLI entry point; returns the process exit code (0 = clean)."""
    import argparse
    from pathlib import Path

    from repro_torch.analysis.rules import all_rules

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "host-sync & invariant linter for the port's LEAR serving engine"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories to analyze (default: src/repro_torch)",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule codes to run (default: all)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name}")
            print(f"       fix: {rule.hint}")
        return 0

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        parser.error(f"no such path(s): {', '.join(missing)}")
    codes = (
        [c.strip() for c in args.select.split(",")] if args.select else None
    )
    findings = run_paths(args.paths, codes=codes)
    print(format_findings(findings, fmt=args.fmt))
    return 1 if findings else 0
