"""Device resolution shared by the port's public entry points, the
device timer of its measurement scripts, the path walk of nested states
(:func:`tree_items`, :func:`tree_map`), the one sanctioned device→host
read (:func:`device_get`, into page-locked memory on the card; and
:func:`host_pinned`, which tells) and the guard that counts host reads
(:func:`count_host_transfers`).

Every entry point that creates tensors (ensemble constructors, the ranking
service, the calibration probe) takes an explicit ``device``. ``None`` means
the card: the port is written for one CUDA device, and a run that finds no
card fails instead of quietly scoring on the CPU. The CPU path (the plain
PyTorch version of every kernel) is taken only when the caller asks for it
with ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
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


def device_ms(fn: Callable[[], object], reps: int, warmup: int = 3) -> float:
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


# ---------------------------------------------------------------------------
# Host reads: the sanctioned one, and the guard that counts the others.
# ---------------------------------------------------------------------------

# Tensor methods that hand a tensor's values to the host. ``to`` counts only
# with a CPU target.
_READS = (
    "item", "tolist", "__bool__", "__int__", "__float__", "__index__",
    "numpy", "__array__", "cpu", "to",
)
# What torch.cuda.set_sync_debug_mode("warn") says of a synchronizing op.
_SYNC_WARNING = r".*synchronizing CUDA operation"


class _ThreadState(threading.local):
    in_get = 0   # device_get calls in progress on this thread
    in_read = 0  # patched tensor reads in progress on this thread


_THREAD = _ThreadState()
_GUARD_LOCK = threading.Lock()
_ACTIVE: list[TransferCounts] = []  # the running guard's tally, if any


@dataclasses.dataclass
class TransferCounts:
    """Tally yielded by :func:`count_host_transfers`.

    ``explicit_gets``: :func:`device_get` calls. ``implicit_syncs``: every
    other host read, a Python-level tensor read or (on the card) an
    operation the sync debug mode flagged. ``sync_warnings``: all the sync
    debug mode's warnings, those inside ``device_get`` included (the card
    only). ``sites``: what each implicit sync was (``Tensor.item`` or the
    flagged call's ``file:line``)."""

    explicit_gets: int = 0
    implicit_syncs: int = 0
    sync_warnings: int = 0
    sites: list[str] = dataclasses.field(default_factory=list)

    def _implicit(self, site: str) -> None:
        with _GUARD_LOCK:
            self.implicit_syncs += 1
            self.sites.append(site)


def device_get(tensor: torch.Tensor) -> np.ndarray:
    """The sanctioned, explicit device→host read: ``tensor``'s values as a
    numpy array (the counterpart of ``jax.device_get``).

    A CUDA tensor is copied asynchronously into a fresh page-locked block
    of PyTorch's caching host allocator, and the call waits on the
    tensor's stream before it returns. The array holds the block (the host
    tensor is its ``base``), which goes back to the cache once the last
    view of it is dropped, so no later read overwrites it. A CPU tensor is
    returned as a view, with no copy. A running :func:`count_host_transfers`
    counts the call as explicit, with whatever the card's sync debug mode
    flags inside it (the wait on the stream)."""
    if _ACTIVE:
        with _GUARD_LOCK:
            _ACTIVE[0].explicit_gets += 1
    _THREAD.in_get += 1
    try:
        tensor = tensor.detach()
        if tensor.is_cuda:
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            torch.cuda.current_stream(tensor.device).synchronize()
            tensor = host
        return tensor.numpy()
    finally:
        _THREAD.in_get -= 1


def host_pinned(array: np.ndarray) -> bool:
    """Whether ``array``, a :func:`device_get` result or a view of one, lies
    in page-locked host memory."""
    base = array
    while isinstance(base, np.ndarray):
        base = base.base
    return isinstance(base, torch.Tensor) and base.is_pinned()


def _targets_cpu(args: tuple, kwargs: dict) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` names the CPU as its device."""
    for a in (*args, kwargs.get("device")):
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type == "cpu"
    return False


def _counting_read(name: str, real: Callable) -> Callable:
    def read(self: torch.Tensor, *args: Any, **kwargs: Any) -> Any:
        counts = _ACTIVE[0] if _ACTIVE else None
        outermost = not (_THREAD.in_get or _THREAD.in_read)
        if counts is not None and outermost and (name != "to" or _targets_cpu(args, kwargs)):
            counts._implicit(f"Tensor.{name}")
        _THREAD.in_read += 1
        try:
            return real(self, *args, **kwargs)
        finally:
            _THREAD.in_read -= 1

    return read


@contextlib.contextmanager
def count_host_transfers() -> Iterator[TransferCounts]:
    """Count device→host reads while the ``with`` block runs, on every
    thread; read the yielded :class:`TransferCounts` after the block.

    Explicit: :func:`device_get` calls. Implicit: everything else —

    - ``Tensor.item``, ``tolist``, ``__bool__``, ``__int__``, ``__float__``,
      ``__index__``, ``numpy``, ``__array__``, ``cpu``, and ``to`` with a
      CPU target, patched on ``torch.Tensor`` for the block (a read made
      inside another, such as ``__array__`` calling ``numpy``, counts once);
    - on a CUDA machine, every operation that
      ``torch.cuda.set_sync_debug_mode("warn")`` flags while the block runs
      (``nonzero``, boolean-mask indexing, ``repeat_interleave`` without
      ``output_size``, blocking copies either way), on any thread: the
      tier's worker serves the batches. A flag raised inside
      ``device_get`` is part of the explicit read; one raised inside a
      patched read is that read. The previous mode is restored on exit,
      also when the block raises.

    Blind spots. On the CPU a tensor never syncs: only the Python-level
    reads above are seen, so the C++ syncs (``nonzero`` and the rest) show
    only on the card. The sync debug mode does not flag every wait for the
    card either. Found on an H100 (torch 2.11, CUDA 12.8): it flags
    ``.item()``, boolean-mask indexing, ``nonzero``, ``torch.where(mask)``,
    ``masked_select``, ``unique``, ``repeat_interleave`` without
    ``output_size`` (twice), ``Stream.synchronize()`` and blocking copies
    both ways (``torch.as_tensor(array, device="cuda")``, ``.cpu()``); it
    does not flag ``torch.cuda.synchronize()`` or ``Event.synchronize()``,
    nor an asynchronous copy from pageable host memory, which CUDA makes
    wait for the stream all the same. ``torch.distributed`` and
    ``torch.sparse`` are not covered (PyTorch's own caveat).

    Not re-entrant; it patches process-wide state, so it belongs in tests
    and measurement scripts, never in serving code.
    """
    counts = TransferCounts()
    with _GUARD_LOCK:
        if _ACTIVE:
            raise RuntimeError("count_host_transfers is not re-entrant")
        _ACTIVE.append(counts)
    saved = {n: torch.Tensor.__dict__.get(n) for n in _READS}
    on_card = torch.cuda.is_available()
    mode = torch.cuda.get_sync_debug_mode() if on_card else None
    try:
        with warnings.catch_warnings():
            show = warnings.showwarning

            def hook(message, category, filename, lineno, file=None, line=None):
                if not (issubclass(category, UserWarning)
                        and "synchronizing CUDA operation" in str(message)):
                    return show(message, category, filename, lineno, file, line)
                with _GUARD_LOCK:
                    counts.sync_warnings += 1
                if not (_THREAD.in_get or _THREAD.in_read):
                    counts._implicit(f"{filename}:{lineno}")
                return None

            warnings.filterwarnings("always", message=_SYNC_WARNING, category=UserWarning)
            # PyTorch's notice that the mode is a prototype (the blind spots
            # are in the docstring).
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            warnings.showwarning = hook
            for n in _READS:
                setattr(torch.Tensor, n, _counting_read(n, getattr(torch.Tensor, n)))
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield counts
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(mode)
                for n, real in saved.items():
                    if real is None:
                        delattr(torch.Tensor, n)
                    else:
                        setattr(torch.Tensor, n, real)
    finally:
        with _GUARD_LOCK:
            _ACTIVE.clear()
