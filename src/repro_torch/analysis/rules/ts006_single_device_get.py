"""TS006 — the single-transfer contract on the serving hot path.

``RankingService.rank_batch`` fetches its whole result — top-k, scores,
per-stage survivors, trees traversed, overflow, docs, exited queries —
through exactly ONE packed ``device_get``. A second transfer site
reachable from it is a second round trip to the card per batch.

The walk is HOST-side: it starts at the configured roots and does not
descend into device-scope roots (transfers there are TS001's problem) or
into ``device_get`` itself (its call is the transfer). Every transfer site
reachable per root is counted; sites beyond the first are flagged. A
``# repro: noqa(TS006)`` on a site line removes it from the count
(waived, e.g. a debug-only branch).
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions
from repro_torch.analysis.rules.common import body_nodes, classify_transfer

HINT = (
    "fold the value into the packed tensor rank_batch reads with its one "
    "device_get instead of adding a second transfer"
)


class SingleDeviceGetRule:
    code = "TS006"
    name = "single-device-get-contract"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        roots = project.functions_matching(config.SINGLE_TRANSFER_ROOT_SUFFIXES)
        for root in sorted(roots):
            yield from self._check_root(project, suppressions, root)

    def _check_root(
        self, project: ProjectIndex, suppressions: Suppressions, root: str
    ) -> Iterator[Finding]:
        reached = self._host_reachable(project, root)
        sites: list[tuple[str, int, int, str, str]] = []
        for fid in sorted(reached):
            func = project.functions[fid]
            mod = project.modules[func.module]
            for node in body_nodes(project, func):
                if not isinstance(node, ast.Call):
                    continue
                transfer = classify_transfer(project, mod, node, func)
                if transfer is None:
                    continue
                if suppressions.is_suppressed(
                    str(func.path), node.lineno, self.code
                ):
                    continue
                sites.append(
                    (
                        str(func.path), node.lineno, node.col_offset,
                        transfer, func.qualname,
                    )
                )
        if len(sites) <= 1:
            return
        sites.sort(key=lambda s: (s[0], s[1]))
        root_name = root.split(":", 1)[-1]
        for idx, (path, line, col, transfer, qualname) in enumerate(sites):
            if idx == 0:
                continue  # the sanctioned single transfer
            yield Finding(
                code=self.code,
                path=path,
                line=line,
                col=col,
                message=(
                    f"{transfer} in `{qualname}` is transfer site "
                    f"{idx + 1} of {len(sites)} reachable from "
                    f"`{root_name}` (contract: exactly one)"
                ),
                hint=self.hint,
            )

    def _host_reachable(self, project: ProjectIndex, root: str) -> set[str]:
        """BFS over host code only: stop at device-scope roots (transfers
        there are TS001 findings) and at transfer primitives (their call is
        the transfer)."""
        stop = project.device_roots | project.functions_matching(
            config.TRANSFER_PRIMITIVE_SUFFIXES
        )
        seen = {root}
        frontier = [root]
        while frontier:
            fid = frontier.pop()
            func = project.functions.get(fid)
            if func is None:
                continue
            for nxt in func.calls:
                if nxt in seen or nxt in stop:
                    continue
                seen.add(nxt)
                frontier.append(nxt)
        return seen
