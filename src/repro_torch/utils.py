"""Device resolution shared by the port's public entry points, the
device timer of its measurement scripts, and the path walk of nested
states (:func:`tree_items`, :func:`tree_map`).

Every entry point that creates tensors (ensemble constructors, the ranking
service, the calibration probe) takes an explicit ``device``. ``None`` means
the card: the port is written for one CUDA device, and a run that finds no
card fails instead of quietly scoring on the CPU. The CPU path (the plain
PyTorch version of every kernel) is taken only when the caller asks for it
with ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is requested and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default when no "
            "device is given) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and dev.index is None:
        # Concrete index, so it compares equal to the device of its tensors.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# Cycles of the sleep kernel ahead of a timed run (about 50 ms at 1.98 GHz):
# longer than the host takes to enqueue the run's calls.
SLEEP_CYCLES = 100_000_000


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` on the current CUDA stream:
    ``reps`` back-to-back calls between one pair of CUDA events, divided by
    ``reps``, after ``warmup`` calls.

    A sleep kernel queued first keeps the card busy while the host enqueues
    the calls, so the window holds the calls' device work and the gaps
    between launches, not the host's call time.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _children(tree: Any) -> Iterator[tuple[str, Any]] | None:
    """``(key, child)`` pairs of a dict, list, tuple or dataclass instance
    (its ``init`` fields, by name); ``None`` for a leaf."""
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init)
    return None


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Every leaf of a nested state with its ``/``-joined path, in the
    reference's spelling of ``jax.tree_util.tree_flatten_with_path``: dict
    keys, sequence indices and dataclass field names
    (``params/tables/t0``, ``opt_state/acc/bot/0/1``, ``step``). A flat
    dict whose keys are already paths flattens to the same strings."""
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for key, child in children:
        yield from tree_items(child, f"{prefix}/{key}" if prefix else key)


def tree_map(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """The same structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), f"{prefix}/{f.name}" if prefix else f.name)
            for f in dataclasses.fields(tree) if f.init
        })
    return fn(prefix, tree)
