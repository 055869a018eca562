"""Spans of the ranking path: where a request's host time goes, and which
layer enqueued each kernel.

A span is a named interval of one thread's host time: its start and end
(``time.perf_counter_ns``), the request it belongs to, the span that was
open on its thread when it opened (its parent), the thread's id
(``threading.get_native_id``) and a few attributes that are host values
(ints, strings, tuples of ints). ``RankingService.rank_batch`` opens the
root span of a request, ``service.rank_batch``; every span opened inside
it, on its thread, shares its request id.

Recording is off unless a :func:`recording` block is open. Then
:func:`span` returns one shared object that does nothing, after one check
of a module flag: it reads no clock, builds no record and touches no
tensor. On or off, a span never reads a tensor's value and never waits for
the device; where the device's work goes is the profiler's to say. A reader
puts the spans on the profiler's clock through the anchors, pairs of
``(time.perf_counter_ns(), time.time_ns())`` read back to back when
recording starts and at each :func:`drain`::

    with tracing.recording():
        svc.rank_batch(X, mask)
    trace = tracing.drain()

The buffer holds ``capacity`` spans; past it, a span is counted in
``Trace.dropped`` and not recorded, until a drain empties the buffer.
:func:`active` hands a callee the innermost open span, so it can set
attributes that only it knows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections.abc import Iterator

Attr = int | str | tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Record:
    """One closed span. ``parent``: the index in :attr:`Trace.records` of
    the span open on the thread when this one opened; -1 for a root (or a
    parent dropped or drained earlier)."""

    name: str
    request: int
    parent: int
    start_ns: int
    end_ns: int
    thread: int
    attrs: dict[str, Attr]


@dataclasses.dataclass(frozen=True)
class Trace:
    """What :func:`drain` returns: the spans closed since the last drain
    (in the order they opened), the spans dropped since, and the anchor
    pairs ``(perf_counter_ns, time_ns)`` that bound the interval."""

    records: list[Record]
    dropped: int
    anchors: list[tuple[int, int]]


def _anchor() -> tuple[int, int]:
    return time.perf_counter_ns(), time.time_ns()


class _Off:
    """The span while recording is off: one shared object doing nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set(self, **attrs: Attr) -> None:
        """Attributes known only inside the span (dropped while off)."""


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "attrs", "parent", "request", "thread", "start_ns", "end_ns")

    def __init__(self, rec: _Recorder, name: str, attrs: dict[str, Attr]) -> None:
        self.rec, self.name, self.attrs = rec, name, attrs
        self.end_ns: int | None = None

    def set(self, **attrs: Attr) -> None:
        """Attributes known only inside the span (a capacity, a mode)."""
        self.attrs.update(attrs)

    def __enter__(self) -> _Span:
        self.rec.open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        self.end_ns = time.perf_counter_ns()
        self.rec.local.stack.pop()


class _Recorder:
    """The bounded buffer of one :func:`recording` block, and the
    per-thread stacks of open spans."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self.capacity = capacity
        self.lock = threading.Lock()
        self.spans: list[_Span] = []
        self.dropped = 0
        self.requests = 0
        self.anchor = _anchor()
        self.local = threading.local()

    def open(self, s: _Span) -> None:
        local = self.local
        if not hasattr(local, "stack"):
            # The thread id once a thread: reading it is a system call.
            local.stack, local.tid = [], threading.get_native_id()
        stack = local.stack
        s.parent = stack[-1] if stack else None
        s.thread = local.tid
        with self.lock:
            if s.parent is None:
                s.request, self.requests = self.requests, self.requests + 1
            else:
                s.request = s.parent.request
            if len(self.spans) < self.capacity:
                self.spans.append(s)
            else:
                self.dropped += 1
        # A dropped span still nests: the spans inside it keep their request.
        stack.append(s)

    def drain(self) -> Trace:
        anchor = _anchor()
        with self.lock:
            spans = self.spans
            self.spans = [s for s in spans if s.end_ns is None]   # still open
            dropped, self.dropped = self.dropped, 0
            anchors = [self.anchor, anchor]
            self.anchor = anchor
        closed = [s for s in spans if s.end_ns is not None]
        index = {id(s): i for i, s in enumerate(closed)}
        return Trace(
            records=[
                Record(s.name, s.request, index.get(id(s.parent), -1), s.start_ns,
                       s.end_ns, s.thread, dict(s.attrs))
                for s in closed
            ],
            dropped=dropped,
            anchors=anchors,
        )


_ON = False
_RECORDER: _Recorder | None = None


def span(name: str, **attrs: Attr) -> _Span | _Off:
    """A span named ``name`` for a ``with`` block: recorded while a
    :func:`recording` block is open, else the shared no-op."""
    if not _ON:
        return _OFF
    return _Span(_RECORDER, name, attrs)


def active() -> _Span | None:
    """The innermost span open on this thread while recording, else None:
    a callee sets attributes only it knows (a kernel's launch plan) on the
    span its caller opened."""
    if not _ON:
        return None
    stack = getattr(_RECORDER.local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording(capacity: int = 1 << 16) -> Iterator[None]:
    """Record spans, into a fresh buffer of ``capacity``, while the block
    runs; :func:`drain` reads them, inside the block or after it."""
    global _ON, _RECORDER
    if _ON:
        raise RuntimeError("recording is already on")
    _RECORDER = _Recorder(capacity)
    _ON = True
    try:
        yield
    finally:
        _ON = False


def drain() -> Trace:
    """The spans of the last :func:`recording` block closed since the last
    drain, and the anchors; the buffer is emptied (open spans stay)."""
    if _RECORDER is None:
        return Trace([], 0, [])
    return _RECORDER.drain()
