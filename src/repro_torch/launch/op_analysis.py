"""Cost analysis of one eager step from its aten ops: the counterpart of
:mod:`repro.launch.hlo_analysis`.

Eager PyTorch compiles no program, so there is no HLO to walk. Instead
:class:`OpTrace`, a ``TorchDispatchMode``, records every aten op that one
step dispatches (run it on ``meta`` tensors: shapes only, nothing
computed), with its name, its tensor operands' and results' shapes and
dtypes, and the FLOPs ``torch.utils.flop_counter``'s formulas give a
matmul-class op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
fused attention). Identical records are kept once with a count, and
:func:`save` writes them as ``.ops.json.gz``.

:func:`analyze` turns a trace into an :class:`OpCost`:

- FLOPs: the matmul-class ops' by their operands' dtype (tensor-core rates
  differ per dtype; float32 runs outside them, TF32 being off), and one
  FLOP an element for elementwise ops and one per input element for
  reductions (the reference's ``_EW_OPS`` rule), kept apart as
  ``"elementwise"``;
- bytes: operand plus result bytes of every op that is not a view (a view
  moves nothing; every other eager op reads its inputs from memory and
  writes its outputs there: there is no fusion boundary to honour, and no
  later fusion is assumed) and is not an ``empty``;
- collective bytes by kind, from the ``_c10d_functional`` ops of the trace:
  the larger of result and operand bytes, an all-reduce counted twice
  (ring ≈ reduce-scatter + all-gather), as the reference counts them.

Trip counts need no walker here: an eager loop dispatches its body every
time it runs. The numbers are those of the traced program: on one device,
the whole step.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
from collections.abc import Callable
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
# One FLOP (or vector op) an element of the result.
_EW_OPS = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne", "lt", "le", "gt", "ge",
    "where", "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "exp", "log", "rsqrt", "sqrt", "tanh", "sigmoid", "pow", "neg", "abs", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "sin", "cos", "reciprocal", "sign", "silu", "gelu",
    "relu", "threshold_backward", "sigmoid_backward", "tanh_backward", "gelu_backward",
    "silu_backward", "addcmul", "addcdiv", "lerp", "fill", "masked_fill", "erf", "log1p",
    "expm1", "remainder", "fmod", "floor_divide", "isinf", "isnan", "isfinite",
}
# One FLOP an element of the (first) input.
_REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax", "argmin",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data", "sort", "topk",
    "nll_loss_forward", "nll_loss_backward", "embedding_dense_backward",
    "index_add", "index_put", "scatter_add", "scatter_reduce", "_segment_reduce",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _spec(t: torch.Tensor) -> tuple[tuple[int, ...], str]:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


# The sparse ops a sparse-gradient step makes that meta tensors lack. A
# coalesce keeps every stored row (an upper bound: the real count depends
# on the data).
_SPARSE_META = {
    torch.ops.aten._coalesce.default: lambda x: torch.sparse_coo_tensor(
        x._indices(), x._values(), x.shape, is_coalesced=True, check_invariants=False),
    torch.ops.aten._to_dense.default: lambda x: torch.empty(
        x.shape, dtype=x.dtype, device="meta"),
}


def run_op(func, args: tuple, kwargs: dict) -> Any:
    """``func(*args, **kwargs)``, with :data:`_SPARSE_META`'s stand-ins for
    the sparse ops meta tensors lack."""
    x = args[0] if args else None
    if isinstance(x, torch.Tensor) and x.is_meta and x.is_sparse and func in _SPARSE_META:
        return _SPARSE_META[func](x)
    return func(*args, **kwargs)


@dataclasses.dataclass
class OpTrace(TorchDispatchMode):
    """Records every aten op dispatched inside ``with OpTrace() as tr:``.
    ``records`` maps ``(op, operands, results)`` → ``[count, matmul FLOPs
    of one call]``; operands and results are ``(shape, dtype)`` tuples."""

    records: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        super().__init__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = run_op(func, args, kwargs)
        self.record(func, args, kwargs, out)
        return out

    def record(self, func, args: tuple, kwargs: dict, out: Any) -> None:
        """Count one call of ``func`` on ``args`` and ``kwargs`` that gave
        ``out``."""
        flops = 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        key = (str(func), tuple(_spec(t) for t in _tensors((args, kwargs))),
               tuple(_spec(t) for t in _tensors(out)))
        rec = self.records.setdefault(key, [0, flops])
        rec[0] += 1


def trace(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[OpTrace, Any]:
    """Run ``fn`` under an :class:`OpTrace`; (the trace, ``fn``'s result)."""
    with OpTrace() as tr:
        out = fn(*args, **kwargs)
    return tr, out


def save(tr: OpTrace, path: str) -> None:
    """The trace as gzipped JSON, one entry per distinct record."""
    rows = [{"op": op, "in": ins, "out": outs, "count": n, "matmul_flops": f}
            for (op, ins, outs), (n, f) in tr.records.items()]
    with gzip.open(path, "wt") as f:
        json.dump(rows, f)


def load(path: str) -> OpTrace:
    with gzip.open(path, "rt") as f:
        rows = json.load(f)
    tr = OpTrace()
    for r in rows:
        key = (r["op"], tuple((tuple(s), d) for s, d in r["in"]),
               tuple((tuple(s), d) for s, d in r["out"]))
        tr.records[key] = [r["count"], r["matmul_flops"]]
    return tr


@dataclasses.dataclass
class OpCost:
    flops: dict = dataclasses.field(default_factory=dict)  # "bfloat16"/"float32"/…
    #   (matmul-class, by operand dtype) and "elementwise"
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES}
    )
    n_ops: int = 0

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def _bytes(specs: tuple) -> int:
    total = 0
    for shape, dtype in specs:
        n = getattr(torch, dtype).itemsize
        for d in shape:
            n *= d
        total += n
    return total


def _numel(specs: tuple) -> int:
    n = 1
    for d in specs[0][0] if specs else ():
        n *= d
    return n if specs else 0


def _parts(op: str) -> tuple[str, str]:
    """``("aten", "add")`` of ``"aten.add.Tensor"``; an in-place or out
    variant counts as its op."""
    ns, name = op.split(".")[:2]
    return ns, name.rstrip("_")


def analyze(tr: OpTrace) -> OpCost:
    cost = OpCost()
    for (op, ins, outs), (count, mm_flops) in tr.records.items():
        cost.n_ops += count
        ns, name = _parts(op)
        kind = _COLLECTIVE_OPS.get(name) if "c10d" in ns else None
        if kind is not None:
            moved = max(_bytes(ins), _bytes(outs)) * (2 if kind == "all-reduce" else 1)
            cost.coll_bytes += count * moved
            cost.coll_breakdown[kind] += count * moved
            continue
        if mm_flops:
            dtype = ins[0][1] if ins else "float32"
            cost.flops[dtype] = cost.flops.get(dtype, 0.0) + count * mm_flops
        elif name in _EW_OPS:
            cost.flops["elementwise"] = cost.flops.get("elementwise", 0.0) + count * _numel(outs)
        elif name in _REDUCE_OPS:
            cost.flops["elementwise"] = cost.flops.get("elementwise", 0.0) + count * _numel(ins)
        if name in _NO_TRAFFIC or _is_view(op):
            continue
        cost.bytes += count * (_bytes(ins) + _bytes(outs))
    return cost


@functools.cache
def _is_view(op: str) -> bool:
    """Whether the aten op returns a view of an input (moves no data)."""
    ns, name, *overload = op.split(".")
    packet = getattr(getattr(torch.ops, ns, None), name, None)
    fn = getattr(packet, overload[0] if overload else "default", None)
    return bool(getattr(fn, "is_view", False))
