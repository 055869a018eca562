"""Project model for the analysis rules: modules, functions, a resolved
call graph, device scope, and a light taint analysis.

The port of :mod:`repro.analysis.callgraph`, re-aimed at eager PyTorch.
Everything here is pure ``ast`` — the analyzed tree is never imported, so
the pass is safe to run on broken or heavyweight code and needs no torch at
analysis time.

The model answers four questions the rules ask:

1. **Which functions are device-scope roots?** Those named in
   :data:`repro_torch.analysis.config.DEVICE_ROOT_SUFFIXES`, functions
   decorated with ``torch.compile`` / ``torch.jit.script`` (bare or through
   ``functools.partial``), and functions passed to ``torch.compile(f)`` or
   ``torch.cuda.make_graphed_callables(f)``. Eager PyTorch has no trace:
   device scope is where a host read would stall the step (and where a
   CUDA graph capture would fail).
2. **What does a function reach?** Call edges plus *reference* edges — a
   bare ``Name`` load that resolves to a project function (callbacks,
   dict/tuple dispatch through module-level containers, and
   ``partial(f, ...)``).
3. **Which values are tensors?** Parameters are tainted unless their
   annotation is host-like (``int``/``str``/config objects/...);
   tensor annotations (``torch.Tensor``, ``Tensor["b f", ...]``) and
   *missing* annotations taint. Shape, dtype and device reads, host-valued
   methods (``numel()``, ``is_contiguous()``, ...), ``len()``/
   ``isinstance()`` and ``is``/``is not`` comparisons break taint.
4. **What is this call, canonically?** Import aliases are followed so
   ``np.asarray`` names ``numpy.asarray`` and ``torch.nonzero`` names
   ``torch.nonzero`` — the rules match canonical dotted names, not surface
   spellings.
"""

from __future__ import annotations

import ast
from collections.abc import Iterable, Iterator
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis import config

# Calls that make their (first) argument a device-scope root.
ROOT_CANONICAL = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
}
PARTIAL_CANONICAL = {"functools.partial"}

# Attribute reads (and host-valued methods) that yield host Python values
# even on tensors: shapes, dtypes, devices, layout facts.
SHAPE_ATTRS = frozenset({
    "shape", "ndim", "dtype", "size", "itemsize", "device", "is_cuda", "layout",
    "requires_grad", "dim", "numel", "nelement", "element_size", "stride",
    "is_contiguous", "is_floating_point", "data_ptr", "get_device", "index",
    "type",
})

# Calls whose result is a host value regardless of argument taint.
# int()/float()/bool() of a tensor sync — TS001 owns flagging them; for
# control-flow purposes their result is host.
UNTAINT_CALLS = frozenset(
    {"len", "isinstance", "issubclass", "range", "enumerate", "type",
     "repr", "str", "hash", "id", "int", "float", "bool", "callable"}
)

# Annotation roots that mark a parameter as carrying device values.
ARRAY_ANNOTATION_ROOTS = frozenset({"Tensor", "Parameter"})

# Attribute method calls never resolved to project methods — ubiquitous
# names on dicts/arrays/stdlib objects that would mis-link the graph.
ATTR_FALLBACK_SKIP = frozenset(
    {"get", "put", "pop", "append", "extend", "add", "update", "copy",
     "items", "keys", "values", "join", "split", "read", "write",
     "close", "sum", "mean", "max", "min", "astype", "reshape", "result",
     "submit", "start", "stop", "set", "setdefault", "format", "index",
     # tensor methods that share a name with a project method
     "to", "float", "double", "long", "int", "bool", "view", "clone",
     "detach", "cpu", "cuda", "item", "numpy", "tolist", "forward",
     "params", "step", "state_dict"}
)


def _attr_chain(expr: ast.expr) -> tuple[list[str], ast.expr]:
    """Peel ``a.b.c`` into ([\"b\", \"c\"], Name(\"a\"))-style parts."""
    parts: list[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    parts.reverse()
    return parts, cur


def annotation_is_arrayish(ann: ast.expr | None) -> bool:
    """True when an annotation says \"this is (or may be) a device array\"."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return any(root in ann.value for root in ARRAY_ANNOTATION_ROOTS)
    if isinstance(ann, ast.Name):
        return ann.id in ARRAY_ANNOTATION_ROOTS
    if isinstance(ann, ast.Attribute):
        return ann.attr in ARRAY_ANNOTATION_ROOTS
    if isinstance(ann, ast.Subscript):
        if _attr_chain(ann.value)[0][-1:] == ["Callable"] or (
            isinstance(ann.value, ast.Name) and ann.value.id == "Callable"
        ):
            return False  # a callable returning a tensor is not a tensor
        return annotation_is_arrayish(ann.value) or annotation_is_arrayish(ann.slice)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return annotation_is_arrayish(ann.left) or annotation_is_arrayish(ann.right)
    if isinstance(ann, ast.Tuple):
        return any(annotation_is_arrayish(e) for e in ann.elts)
    return False


@dataclass
class FunctionInfo:
    """One function (or compiled lambda) in the analyzed tree."""

    qualname: str  # dotted within the module, e.g. "CascadeRanker.rank"
    module: str
    path: Path
    node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
    class_name: str | None = None
    is_root: bool = False  # torch.compile'd (or graphed) function
    calls: set[str] = field(default_factory=set)  # resolved full ids
    _taint: set[str] | None = None

    @property
    def full_id(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


@dataclass
class ModuleInfo:
    name: str
    path: Path
    tree: ast.Module
    source_lines: list[str]
    aliases: dict[str, str] = field(default_factory=dict)  # name -> dotted
    top_level_defs: dict[str, str] = field(default_factory=dict)  # name -> qualname
    containers: dict[str, set[str]] = field(default_factory=dict)  # name -> full ids


def module_name_for(path: Path) -> str:
    """Derive a dotted module name; falls back to the file stem for
    fixture files analyzed outside a package tree."""
    parts = list(path.with_suffix("").parts)
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)
    return path.stem


class ProjectIndex:
    """Parsed modules + resolved call graph + scope/taint queries."""

    def __init__(self, paths: Iterable[Path]) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.canonical_to_id: dict[str, str] = {}
        self.methods_by_name: dict[str, list[str]] = {}
        self.errors: list[tuple[Path, str]] = []
        for path in paths:
            self._parse(Path(path))
        for mod in self.modules.values():
            self._index_module(mod)
        for mod in self.modules.values():
            self._collect_containers(mod)
        for func in list(self.functions.values()):
            self._collect_edges(func)
        self._device_scope: set[str] | None = None

    # -- parsing --------------------------------------------------------

    def _parse(self, path: Path) -> None:
        try:
            text = path.read_text()
            tree = ast.parse(text, filename=str(path))
        except (OSError, SyntaxError) as exc:
            self.errors.append((path, str(exc)))
            return
        name = module_name_for(path)
        self.modules[name] = ModuleInfo(
            name=name, path=path, tree=tree, source_lines=text.splitlines()
        )

    def _index_module(self, mod: ModuleInfo) -> None:
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    mod.aliases[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
            elif isinstance(stmt, ast.ImportFrom) and stmt.module and stmt.level == 0:
                for alias in stmt.names:
                    mod.aliases[alias.asname or alias.name] = (
                        f"{stmt.module}.{alias.name}"
                    )
        self._index_scope(mod, mod.tree.body, prefix="", class_name=None)

    def _index_scope(
        self,
        mod: ModuleInfo,
        body: list[ast.stmt],
        prefix: str,
        class_name: str | None,
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qualname = f"{prefix}{stmt.name}"
                info = FunctionInfo(
                    qualname=qualname,
                    module=mod.name,
                    path=mod.path,
                    node=stmt,
                    class_name=class_name,
                )
                info.is_root = self._has_root_decorator(mod, stmt)
                self._register(mod, info)
                self._index_scope(
                    mod, stmt.body, prefix=f"{qualname}.", class_name=class_name
                )
            elif isinstance(stmt, ast.ClassDef):
                qualname = f"{prefix}{stmt.name}"
                self._index_scope(
                    mod, stmt.body, prefix=f"{qualname}.", class_name=stmt.name
                )
            elif isinstance(stmt, (ast.If, ast.Try, ast.With)):
                # conditional defs (TYPE_CHECKING guards, try/except imports)
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.stmt):
                        self._index_scope(mod, [child], prefix, class_name)

    def _register(self, mod: ModuleInfo, info: FunctionInfo) -> None:
        self.functions[info.full_id] = info
        self.canonical_to_id[f"{mod.name}.{info.qualname}"] = info.full_id
        if "." not in info.qualname:
            mod.top_level_defs[info.qualname] = info.qualname
        if info.class_name is not None and info.qualname.count(".") == 1:
            self.methods_by_name.setdefault(info.name, []).append(info.full_id)

    # -- canonical names ------------------------------------------------

    def canonical(self, mod: ModuleInfo, expr: ast.expr) -> str | None:
        """Canonical dotted name for a Name/Attribute chain, following
        import aliases (``np.asarray`` → ``numpy.asarray``)."""
        parts, base = _attr_chain(expr)
        if not isinstance(base, ast.Name):
            return None
        root = mod.aliases.get(base.id)
        if root is None:
            if base.id in mod.top_level_defs:
                root = f"{mod.name}.{base.id}"
            else:
                root = base.id
        return ".".join([root, *parts])

    def resolve_name_in_scope(
        self, func: FunctionInfo, name: str
    ) -> str | None:
        """Resolve a bare name lexically: sibling/parent nested scopes
        first (``step`` calling ``fused_body``), then module level."""
        parts = func.qualname.split(".")
        for i in range(len(parts), -1, -1):
            prefix = ".".join([func.module, *parts[:i], name])
            if prefix in self.canonical_to_id:
                return self.canonical_to_id[prefix]
        return None

    def resolve_canonical(self, canon: str, depth: int = 0) -> str | None:
        """Map a canonical dotted name to a project function id,
        following re-export chains (``from x import f``) across modules."""
        if depth > 8 or canon is None:
            return None
        if canon in self.canonical_to_id:
            return self.canonical_to_id[canon]
        if "." not in canon:
            return None
        owner, leaf = canon.rsplit(".", 1)
        mod = self.modules.get(owner)
        if mod is not None and leaf in mod.aliases:
            return self.resolve_canonical(mod.aliases[leaf], depth + 1)
        return None

    # -- edges ----------------------------------------------------------

    def _collect_containers(self, mod: ModuleInfo) -> None:
        """Module-level assignments whose value references functions —
        the dispatch tables (``_LEAF_VALUE_FNS``, ``COMPACTORS``)."""
        for stmt in mod.tree.body:
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            # a function CALLED to compute the constant is not a stored
            # reference — only names in value position count
            call_positions = {
                id(node.func)
                for node in ast.walk(value)
                if isinstance(node, ast.Call)
            }
            refs = set()
            for node in ast.walk(value):
                if (
                    isinstance(node, (ast.Name, ast.Attribute))
                    and id(node) not in call_positions
                ):
                    canon = self.canonical(mod, node)
                    target = self.resolve_canonical(canon) if canon else None
                    if target is not None:
                        refs.add(target)
            if not refs:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    mod.containers[tgt.id] = refs

    def _has_root_decorator(
        self, mod: ModuleInfo, node: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        for deco in node.decorator_list:
            expr = deco
            if isinstance(expr, ast.Call):
                canon = self.canonical(mod, expr.func)
                if canon in ROOT_CANONICAL:
                    return True
                if canon in PARTIAL_CANONICAL and expr.args:
                    inner = self.canonical(mod, expr.args[0])
                    if inner in ROOT_CANONICAL:
                        return True
            else:
                if self.canonical(mod, expr) in ROOT_CANONICAL:
                    return True
        return False

    def _resolve_call_target(
        self,
        mod: ModuleInfo,
        func: FunctionInfo,
        call: ast.Call,
    ) -> set[str]:
        """Project function ids a call may dispatch to."""
        out: set[str] = set()
        target = call.func
        if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
            out |= mod.containers.get(target.value.id, set())
            return out
        if isinstance(target, ast.Name):
            scoped = self.resolve_name_in_scope(func, target.id)
            if scoped is not None:
                return {scoped}
        canon = self.canonical(mod, target)
        if canon is not None:
            resolved = self.resolve_canonical(canon)
            if resolved is not None:
                out.add(resolved)
                return out
        if isinstance(target, ast.Attribute):
            parts, base = _attr_chain(target)
            leaf = parts[-1]
            if (
                isinstance(base, ast.Name)
                and base.id == "self"
                and func.class_name is not None
            ):
                own = self.canonical_to_id.get(
                    f"{func.module}.{func.class_name}.{leaf}"
                )
                if own is not None:
                    out.add(own)
                    return out
            if leaf not in ATTR_FALLBACK_SKIP:
                candidates = self.methods_by_name.get(leaf, [])
                if len(candidates) == 1:
                    out.add(candidates[0])
        return out

    def _collect_edges(self, func: FunctionInfo) -> None:
        mod = self.modules[func.module]
        body = (
            [func.node.body]
            if isinstance(func.node, ast.Lambda)
            else func.node.body
        )
        index = self

        class EdgeVisitor(ast.NodeVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                func.calls.update(index._resolve_call_target(mod, func, node))
                canon = index.canonical(mod, node.func)
                if canon in ROOT_CANONICAL and node.args:
                    index._mark_root_argument(mod, func, node.args[0])
                self.generic_visit(node)

            def visit_Name(self, node: ast.Name) -> None:
                if isinstance(node.ctx, ast.Load):
                    scoped = index.resolve_name_in_scope(func, node.id)
                    if scoped is not None:
                        func.calls.add(scoped)
                        return
                    canon = index.canonical(mod, node)
                    resolved = (
                        index.resolve_canonical(canon) if canon else None
                    )
                    if resolved is not None:
                        func.calls.add(resolved)
                    elif node.id in mod.containers:
                        func.calls.update(mod.containers[node.id])

            def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                pass  # nested defs are their own FunctionInfo

            visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

            def visit_Lambda(self, node: ast.Lambda) -> None:
                # lambdas have no FunctionInfo of their own (unless
                # compiled) — their references belong to the enclosing
                # function
                self.generic_visit(node)

        visitor = EdgeVisitor()
        for stmt in body:
            visitor.visit(stmt)

    def _mark_root_argument(
        self, mod: ModuleInfo, func: FunctionInfo, arg: ast.expr
    ) -> None:
        """``torch.compile(target)``: mark the target (or a synthetic
        lambda) as a device-scope root."""
        if isinstance(arg, ast.Lambda):
            qualname = f"{func.qualname}.<lambda:{arg.lineno}>"
            info = FunctionInfo(
                qualname=qualname,
                module=func.module,
                path=func.path,
                node=arg,
                class_name=func.class_name,
                is_root=True,
            )
            self.functions[info.full_id] = info
            self._collect_edges(info)
            return
        if isinstance(arg, ast.Call):
            canon = self.canonical(mod, arg.func)
            if canon in PARTIAL_CANONICAL and arg.args:
                arg = arg.args[0]
        canon = self.canonical(mod, arg) if not isinstance(arg, ast.Call) else None
        resolved = self.resolve_canonical(canon) if canon else None
        if resolved is not None:
            self.functions[resolved].is_root = True

    # -- scopes ---------------------------------------------------------

    def functions_matching(self, suffixes: tuple[str, ...]) -> set[str]:
        """Ids of the functions whose fully-qualified id ends with one of
        ``suffixes``."""
        return {fid for fid in self.functions if fid.endswith(suffixes)}

    def reachable_from(self, roots: set[str]) -> set[str]:
        """``roots`` and every function they reach; the walk does not
        descend into a transfer primitive (``device_get``)."""
        stop = self.functions_matching(config.TRANSFER_PRIMITIVE_SUFFIXES)
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            fid = frontier.pop()
            func = self.functions.get(fid)
            if func is None or fid in stop:
                continue
            for nxt in func.calls:
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    @property
    def device_roots(self) -> set[str]:
        return {
            fid for fid, f in self.functions.items() if f.is_root
        } | self.functions_matching(config.DEVICE_ROOT_SUFFIXES)

    @property
    def device_scope(self) -> set[str]:
        if self._device_scope is None:
            stop = self.functions_matching(config.TRANSFER_PRIMITIVE_SUFFIXES)
            self._device_scope = self.reachable_from(self.device_roots) - stop
        return self._device_scope

    def functions_in(self, scope: set[str]) -> Iterator[FunctionInfo]:
        for fid in sorted(scope):
            func = self.functions.get(fid)
            if func is not None:
                yield func

    # -- taint ----------------------------------------------------------

    def taint(self, func: FunctionInfo) -> set[str]:
        """Names in ``func`` holding (possibly) traced values."""
        if func._taint is None:
            func._taint = _compute_taint(func)
        return func._taint

    def expr_tainted(self, func: FunctionInfo, expr: ast.expr) -> bool:
        return _expr_tainted(expr, self.taint(func))


def _params_of(
    node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda,
) -> list[ast.arg]:
    args = node.args
    return [
        *args.posonlyargs, *args.args, *args.kwonlyargs,
        *([args.vararg] if args.vararg else []),
        *([args.kwarg] if args.kwarg else []),
    ]


def _expr_tainted(expr: ast.expr, tainted: set[str]) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Constant):
        return False
    if isinstance(expr, ast.Attribute):
        if expr.attr in SHAPE_ATTRS:
            return False
        return _expr_tainted(expr.value, tainted)
    if isinstance(expr, ast.Subscript):
        return _expr_tainted(expr.value, tainted) or _expr_tainted(
            expr.slice, tainted
        )
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) and expr.func.id in UNTAINT_CALLS:
            return False
        if _expr_tainted(expr.func, tainted):
            return True
        return any(
            _expr_tainted(a, tainted)
            for a in [*expr.args, *[kw.value for kw in expr.keywords]]
        )
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        # `"key" in pytree` is a structure check — static under trace
        if (
            all(isinstance(op, (ast.In, ast.NotIn)) for op in expr.ops)
            and isinstance(expr.left, ast.Constant)
        ):
            return False
        return _expr_tainted(expr.left, tainted) or any(
            _expr_tainted(c, tainted) for c in expr.comparators
        )
    if isinstance(expr, ast.BoolOp):
        return any(_expr_tainted(v, tainted) for v in expr.values)
    if isinstance(expr, ast.BinOp):
        return _expr_tainted(expr.left, tainted) or _expr_tainted(
            expr.right, tainted
        )
    if isinstance(expr, ast.UnaryOp):
        return _expr_tainted(expr.operand, tainted)
    if isinstance(expr, ast.IfExp):
        return any(
            _expr_tainted(e, tainted) for e in (expr.test, expr.body, expr.orelse)
        )
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return any(_expr_tainted(e, tainted) for e in expr.elts)
    if isinstance(expr, ast.Dict):
        return any(
            _expr_tainted(e, tainted)
            for e in [*expr.keys, *expr.values]
            if e is not None
        )
    if isinstance(expr, ast.Starred):
        return _expr_tainted(expr.value, tainted)
    if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return any(_expr_tainted(g.iter, tainted) for g in expr.generators)
    if isinstance(expr, ast.DictComp):
        return any(_expr_tainted(g.iter, tainted) for g in expr.generators)
    return False


def _assign_names(target: ast.expr) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _assign_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _assign_names(target.value)


def _compute_taint(func: FunctionInfo) -> set[str]:
    tainted: set[str] = set()
    for param in _params_of(func.node):
        if param.arg in ("self", "cls"):
            continue
        ann = getattr(param, "annotation", None)
        if ann is None or annotation_is_arrayish(ann):
            tainted.add(param.arg)
    if isinstance(func.node, ast.Lambda):
        return tainted

    def walk(stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign):
                if _expr_tainted(stmt.value, tainted):
                    for tgt in stmt.targets:
                        tainted.update(_assign_names(tgt))
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name) and (
                    _expr_tainted(stmt.value, tainted)
                    or annotation_is_arrayish(stmt.annotation)
                ):
                    tainted.add(stmt.target.id)
            elif isinstance(stmt, ast.AugAssign):
                if _expr_tainted(stmt.value, tainted):
                    tainted.update(_assign_names(stmt.target))
            elif isinstance(stmt, ast.For):
                if _expr_tainted(stmt.iter, tainted):
                    tainted.update(_assign_names(stmt.target))
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.While):
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.If):
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.With):
                walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body)
                for handler in stmt.handlers:
                    walk(handler.body)
                walk(stmt.orelse)
                walk(stmt.finalbody)

    # two passes: a name assigned late then used earlier inside a loop
    walk(func.node.body)
    walk(func.node.body)
    return tainted
