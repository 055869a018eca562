"""TS003 — reassociation hazard on the tree axis.

The plain versions of the forest kernels are bit-exact with the CUDA
kernels (and with the reference's Pallas kernel) ONLY because every
tree-axis total goes through ``pairwise_tree_sum`` — contiguous halves,
the reference kernel's order — and the tree blocks are added left to
right. A bare ``torch.sum``/``.sum()`` or a ``+=`` accumulation loop in
that scope reduces in another order and silently breaks the bit-exactness
the parity tests and the card's checks pin.

The same discipline covers tree reordering: a permuted ensemble
(``forest/reorder.py``) scores bit-exactly with identity ordering only
while every tree-axis total it reaches goes through the sanctioned
reducer. The scope is everything reachable from
``config.TREE_SUM_ROOT_SUFFIXES``.

Reductions that are provably order-free (integer adds, one-hot
selection) may be waived with ``# repro: noqa(TS003) -- <why>``.
"""

from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis import config
from repro_torch.analysis.callgraph import FunctionInfo, ProjectIndex
from repro_torch.analysis.engine import Finding, Suppressions
from repro_torch.analysis.rules.common import body_nodes

HINT = (
    "reduce through pairwise_tree_sum (kernels/forest_score.py) so the "
    "association order stays fixed; waive with `# repro: noqa(TS003)` only "
    "for provably order-free reductions"
)


class ReassociationRule:
    code = "TS003"
    name = "reassociation-hazard-on-tree-axis"
    hint = HINT

    def check(
        self, project: ProjectIndex, suppressions: Suppressions
    ) -> Iterator[Finding]:
        roots = project.functions_matching(config.TREE_SUM_ROOT_SUFFIXES)
        for func in project.functions_in(project.reachable_from(roots)):
            if func.name in config.TREE_SUM_ALLOWED:
                continue
            mod = project.modules[func.module]
            in_loops = _nodes_inside_loops(project, func)
            for node in body_nodes(project, func):
                if isinstance(node, ast.Call):
                    canon = project.canonical(mod, node.func)
                    is_fn_sum = canon in ("torch.sum", "numpy.sum")
                    is_method_sum = (
                        isinstance(node.func, ast.Attribute) and node.func.attr == "sum"
                    )
                    if is_fn_sum or is_method_sum:
                        yield self._finding(func, node, "bare sum()")
                elif (
                    isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Add)
                    and id(node) in in_loops
                ):
                    yield self._finding(func, node, "`+=` accumulation inside a loop")

    def _finding(self, func: FunctionInfo, node: ast.AST, what: str) -> Finding:
        return Finding(
            code=self.code,
            path=str(func.path),
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{what} on the tree-sum path (`{func.qualname}`) bypasses "
                "pairwise_tree_sum"
            ),
            hint=self.hint,
        )


def _nodes_inside_loops(project: ProjectIndex, func: FunctionInfo) -> set[int]:
    """ids of body nodes that sit inside a for/while loop."""
    inside: set[int] = set()
    for loop in body_nodes(project, func):
        if isinstance(loop, (ast.For, ast.While)):
            inside.update(id(n) for n in ast.walk(loop) if n is not loop)
    return inside
