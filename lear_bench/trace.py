"""The profiler's events reduced to what the per-layer metrics read.

A traced run profiles a few requests with ``torch.profiler`` inside a span
named :data:`WINDOW`. On the card it records device activity alone: the
kernels and copies, and on the host the CUDA runtime's calls that launched
them (recording every host op would cost the host more than the requests
do, and the idle share would read the profiler). :func:`collect` takes the
device's spans and the host's; :func:`summarize` reduces them:

- ``busy_s``: the union of the device's kernel and copy intervals inside
  the window; ``window_s``: the window's length (the :data:`WINDOW` span
  where the host's spans were recorded, else the device's first start to
  its last end);
- ``kernels``: each device kernel's name and seconds (copies and memsets
  are not kernels); ``kernel_busy_s``: the union of their intervals;
- ``device_ops``: device time summed by name, the longest first;
- ``idle_gaps``: the window's idle intervals summed by what the host was
  doing at their midpoint (the innermost host span open there, such as the
  runtime call that waits for a copy; ``host (no span)`` is Python and
  numpy between calls), the longest first.

The host spans the harness opens (:data:`WINDOW`) are mirrored on the
device's timeline as annotations, which are not device work and are left
out. Forest kernels are the kernels whose name holds :data:`FOREST_KERNEL`
(``forest_score_kernel`` in ``csrc/forest_score.cu``); every other kernel
is the engine's glue.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

WINDOW = "lear_bench.window"
FOREST_KERNEL = "forest_score"
ANNOTATIONS = (WINDOW,)
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float]]
    device_ops: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]
    kernel_busy_s: float = 0.0

    @property
    def forest_s(self) -> float:
        return sum(s for name, s in self.kernels if FOREST_KERNEL in name)

    @property
    def glue_s(self) -> float:
        return sum(s for name, s in self.kernels if FOREST_KERNEL not in name)


def collect(prof: object) -> tuple[list[Span], list[Span], Span]:
    """(device spans, host spans of the window's thread, the window) of a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    window, thread = None, None
    events = list(prof.events())
    for e in events:
        if e.name == WINDOW and e.device_type == DeviceType.CPU:
            window, thread = Span(e.name, e.time_range.start, e.time_range.end), e.thread
    device, host = [], []
    for e in events:
        span = Span(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA and e.name not in ANNOTATIONS:
            device.append(span)
        elif e.device_type == DeviceType.CPU and e.name not in ANNOTATIONS and (
            thread is None or e.thread == thread
        ):
            host.append(span)
    if window is None:
        if not device:
            raise RuntimeError(f"the profiler recorded no {WINDOW!r} span and no device work")
        window = Span(WINDOW, min(s.start_us for s in device), max(s.end_us for s in device))
    return device, host, window


def _union(spans: list[Span], lo: float, hi: float) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s in sorted(spans, key=lambda s: s.start_us):
        a, b = max(s.start_us, lo), min(s.end_us, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(host: list[Span], points: list[float]) -> list[str]:
    """For each point (ascending), the name of the innermost host span open
    there (host spans of one thread nest), or ``"host (no span)"``."""
    order = sorted(host, key=lambda s: (s.start_us, -s.end_us))
    starts = [s.start_us for s in order]
    names, stack, i = [], [], 0
    for p in points:
        j = bisect.bisect_right(starts, p)
        while i < j:
            s = order[i]
            while stack and stack[-1].end_us <= s.start_us:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1].end_us < p:
            stack.pop()
        names.append(stack[-1].name if stack else "host (no span)")
    return names


def _top(pairs: dict[str, float], n: int = 10) -> list[tuple[str, float]]:
    return sorted(pairs.items(), key=lambda kv: -kv[1])[:n]


def summarize(device: list[Span], host: list[Span], window: Span) -> Summary:
    lo, hi = window.start_us, window.end_us
    inside = [s for s in device if s.end_us > lo and s.start_us < hi]
    busy = _union(inside, lo, hi)
    busy_us = sum(b - a for a, b in busy)
    kernel_spans = [s for s in inside if not s.name.startswith(COPY_PREFIXES)]
    kernels = [(s.name, (s.end_us - s.start_us) * 1e-6) for s in kernel_spans]
    by_op: dict[str, float] = defaultdict(float)
    for s in inside:
        by_op[s.name[:120]] += (s.end_us - s.start_us) * 1e-6
    edges = [lo, *(x for ab in busy for x in ab), hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    by_host: dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        by_host[name[:120]] += (b - a) * 1e-6
    return Summary(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, kernels=kernels,
        device_ops=_top(by_op), idle_gaps=_top(by_host),
        kernel_busy_s=sum(b - a for a, b in _union(kernel_spans, lo, hi)) * 1e-6,
    )
