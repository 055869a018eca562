"""Shape and dtype annotations for tensors, and a runtime-checked lane.

The port of :mod:`repro.typecheck`, without jaxtyping. Two parts:

1. **An annotation type.** ``Tensor["b f", torch.float32]`` names a tensor
   of two dims, ``b`` and ``f``, of dtype float32, in jaxtyping's
   dim-string grammar: a name binds a size, an integer fixes one, ``_``
   takes any one dim, ``...`` any number of dims, and ``*name`` binds a run
   of dims. The dtype may be a ``torch.dtype``, a tuple of them, or left
   out (any dtype). At run time an annotation is a plain class that
   describes itself; reading code and the analyzer treat it as a tensor.
2. **A runtime-checked lane.** :func:`shape_checked` wraps a function so
   that its ``Tensor[...]`` annotations are checked at every call: the
   rank, the dtype, fixed sizes, and each named dim bound ACROSS the
   arguments and the return value (``"t n"`` on two operands means the
   same ``t`` and ``n``). It raises ``TypeError`` naming the argument. The
   tests drive the kernel wrappers through it; production call sites stay
   unwrapped, so the hot path pays nothing.
"""

from __future__ import annotations

import functools
import inspect
import re
import typing
from collections.abc import Callable
from typing import Any

import torch

__all__ = ["Tensor", "shape_checked"]

_DIM = re.compile(r"^(\*?[A-Za-z_][A-Za-z0-9_]*|\d+|\.\.\.)$")


class _TensorSpec:
    """Base of every ``Tensor[...]`` annotation class."""

    dims: tuple[str, ...] = ()
    dtypes: tuple[torch.dtype, ...] | None = None

    @classmethod
    def describe(cls) -> str:
        dt = "any" if cls.dtypes is None else "|".join(str(d) for d in cls.dtypes)
        return f'Tensor["{" ".join(cls.dims)}", {dt}]'

    @classmethod
    def check(cls, value: object, bound: dict[str, Any]) -> bool:
        """Whether ``value`` satisfies the annotation given the dims bound
        so far; binds the dims it names first (into ``bound``) on success."""
        if not isinstance(value, torch.Tensor):
            return False
        if cls.dtypes is not None and value.dtype not in cls.dtypes:
            return False
        shape = tuple(value.shape)
        dims = cls.dims
        star = [i for i, d in enumerate(dims) if d == "..." or d.startswith("*")]
        if star:
            i = star[0]
            n_tail = len(dims) - i - 1
            if len(shape) < len(dims) - 1:
                return False
            pairs = list(zip(dims[:i], shape[:i]))
            pairs.append((dims[i], shape[i:len(shape) - n_tail]))
            pairs += list(zip(dims[i + 1:], shape[len(shape) - n_tail:]))
        elif len(shape) != len(dims):
            return False
        else:
            pairs = list(zip(dims, shape))
        new: dict[str, Any] = {}
        for dim, size in pairs:
            if dim in ("_", "..."):
                continue
            if dim.isdigit():
                if size != int(dim):
                    return False
                continue
            name = dim.lstrip("*")
            want = bound.get(name, new.get(name))
            if want is None:
                new[name] = size
            elif want != size:
                return False
        bound.update(new)
        return True


class _TensorMeta(type):
    def __repr__(cls) -> str:
        return cls.describe() if issubclass(cls, _TensorSpec) and cls.dims else "Tensor"


class Tensor(_TensorSpec, metaclass=_TensorMeta):
    """``Tensor["dims", dtype]``: the annotation of a tensor's shape and
    dtype (see the module docstring for the grammar)."""

    def __class_getitem__(cls, item: object) -> type[_TensorSpec]:
        spec, dtype = (item, None) if isinstance(item, str) else item
        if not isinstance(spec, str):
            raise TypeError(f"Tensor[...] takes a dim string first, got {spec!r}")
        dims = tuple(spec.split())
        bad = [d for d in dims if not _DIM.match(d)]
        variadic = [d for d in dims if d == "..." or d.startswith("*")]
        if bad or len(variadic) > 1:
            raise TypeError(f"Tensor[{spec!r}]: bad dims {bad or variadic}")
        if dtype is None:
            dtypes = None
        elif isinstance(dtype, torch.dtype):
            dtypes = (dtype,)
        else:
            dtypes = tuple(dtype)
            if not all(isinstance(d, torch.dtype) for d in dtypes):
                raise TypeError(f"Tensor[{spec!r}, ...]: not a torch dtype: {dtype!r}")
        return _TensorMeta(
            "Tensor", (_TensorSpec,), {"dims": dims, "dtypes": dtypes, "__module__": __name__}
        )


def _is_spec(hint: object) -> bool:
    return isinstance(hint, type) and issubclass(hint, _TensorSpec) and hint is not Tensor


def _describe(value: object) -> str:
    shape = getattr(value, "shape", None)
    if shape is None:
        return repr(type(value))
    return f"shape={tuple(shape)} dtype={getattr(value, 'dtype', None)}"


def shape_checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so its ``Tensor[...]`` annotations are enforced per call,
    with named dims bound across the arguments and the return value.

    Hints are read through ``__wrapped__``; the wrapped callable is still
    what runs. A function without such annotations is returned unchanged.
    The wrapper carries ``__shape_checked__ = True``.
    """
    target = inspect.unwrap(fn)
    hints = {n: h for n, h in typing.get_type_hints(target).items() if _is_spec(h)}
    if not hints:
        return fn
    sig = inspect.signature(target)
    return_hint = hints.pop("return", None)

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        bound_args = sig.bind(*args, **kwargs)
        dims: dict[str, Any] = {}
        for name, hint in hints.items():
            if name not in bound_args.arguments:
                continue
            value = bound_args.arguments[name]
            if not hint.check(value, dims):
                raise TypeError(
                    f"{target.__name__}: argument `{name}` ({_describe(value)}) "
                    f"does not satisfy {hint!r} (dim variables bind across arguments)"
                )
        out = fn(*args, **kwargs)
        if return_hint is not None and not return_hint.check(out, dims):
            raise TypeError(
                f"{target.__name__}: return value ({_describe(out)}) "
                f"does not satisfy {return_hint!r}"
            )
        return out

    wrapper.__shape_checked__ = True
    return wrapper
