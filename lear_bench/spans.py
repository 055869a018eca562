"""The program's spans beside the profiler's events: which span of the
program enqueued each kernel and copy, and what the host was doing in each
of the card's idle gaps.

The program records spans (``repro_torch.tracing``: a name, a request, a
parent, start and end on ``time.perf_counter_ns``, a thread, attributes)
while a recording block is open; the profiler records the device's kernels
and copies and, on the host, the CUDA runtime's calls that enqueued them,
each pair joined by a correlation id. :func:`collect` reads the profiler's
events with their correlation ids (times in Unix-epoch nanoseconds, as
Kineto keeps them: the clock of ``time.time_ns``); :func:`on_profiler_clock`
puts the program's spans on that clock through the recorder's anchors
(``(perf_counter_ns, time_ns)`` pairs read back to back); :func:`summarize`
joins them:

- each kernel and copy goes to the innermost program span open on the
  thread of the runtime call that enqueued it, when that call was made
  (``device``: seconds by that span's path, root first, and the op's kind);
- each idle gap of the window is named by what was open at its midpoint,
  counting the runtime's calls and the program's spans: the innermost
  program span, ``<program span>/<runtime call>`` for a runtime call
  inside one, a runtime call alone outside the program, or
  ``host (no span)`` (``idle_gaps``); ``idle_split`` cuts each gap where a
  span or call opens or closes and names each piece alike;
- the alignment check: the share of the window's kernel launches and
  copies (their runtime calls) that fall inside a ``service.rank_batch``
  span within :data:`SLACK_NS`, and the share of device time attributed to
  a program span;
- ``stage``: device seconds by the innermost span's name and its ``stage``
  attribute (``engine.features@1``), for spans that carry one.

:func:`request_attrs` reads what a request's spans say it launched (their
attributes). Readers of one number each (``*_ms(ctx)``) take the context a run builds:
``ctx["spans"]`` (the :class:`Spans` of the profiled segment) and
``ctx["span_requests"]`` (:func:`request_times` of a segment recorded
without the profiler); each returns ``None`` where its part is missing.
This module imports nothing of the program: it reads the records as
attributes (``name``, ``request``, ``parent``, ``start_ns``, ``end_ns``,
``thread``, ``attrs``).
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from collections import Counter, defaultdict
from collections.abc import Callable, Iterable, Sequence

ROOT = "service.rank_batch"
NO_SPAN = "host (no span)"
SLACK_NS = 50_000                       # 50 µs: the alignment criterion
LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync")
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass(frozen=True)
class Op:
    """A profiler event: a device op (kind ``kernel`` or ``copy``) or a
    host call (kind ``host``); times in epoch nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    corr: int
    thread: int
    kind: str


@dataclasses.dataclass(frozen=True)
class PSpan:
    """A program span on the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    path: tuple[str, ...]          # names from the root to this span
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Spans:
    """:func:`summarize`'s result over one window."""

    window_s: float
    busy_s: float                                  # union of kernels and copies
    requests: int                                  # roots inside the window
    device: dict[tuple[tuple[str, ...], str], float]   # (path, kind) -> s
    unattributed_s: float                          # device time of no span
    stage: dict[str, float]                        # "name@stage" of the innermost span -> s
    idle_gaps: dict[str, float]                    # name at a gap's midpoint -> s
    idle_split: dict[str, float]                   # each piece of a gap by its name -> s
    gaps: list[tuple[str, int, int]]               # (name, start, end) of each gap, in ns
    longest_gaps: list[tuple[str, float, float]]   # (name, start from the window's, s)
    launches: int                                  # LAUNCHES calls in the window
    launches_aligned: int                          # of those, inside a root ± slack
    worst_outside_ns: int                          # the farthest one outside a root

    @property
    def device_s(self) -> float:
        return sum(self.device.values()) + self.unattributed_s

    @property
    def attributed_share(self) -> float:
        return 1.0 - self.unattributed_s / self.device_s if self.device_s else 0.0

    @property
    def aligned_share(self) -> float:
        return self.launches_aligned / self.launches if self.launches else 0.0

    def inside(self, name: str, kinds: Iterable[str]) -> float:
        """Device seconds of ``kinds`` enqueued inside a span named
        ``name`` (its own and its descendants')."""
        kinds = set(kinds)
        return sum(s for (path, kind), s in self.device.items() if kind in kinds and name in path)

    def by_innermost(self) -> dict[str, float]:
        """Device seconds by innermost span (kernels and copies)."""
        out: dict[str, float] = defaultdict(float)
        for (path, _), s in self.device.items():
            out[path[-1]] += s
        if self.unattributed_s:
            out[NO_SPAN] += self.unattributed_s
        return dict(out)


def collect(prof: object) -> tuple[list[Op], list[Op]]:
    """(device ops, host calls) of a finished ``torch.profiler.profile``,
    from Kineto's events. With device activity alone the host calls are the
    CUDA runtime's, and a ``record_function`` annotation is not among them
    (an H100 with torch 2.11): a window is given by the host's clock."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), int(e.start_ns())
        op = Op(name, start, start + int(e.duration_ns()), int(e.correlation_id()),
                int(e.start_thread_id()), "host")
        if e.device_type() == DeviceType.CUDA:
            kind = "copy" if name.startswith(COPY_PREFIXES) else "kernel"
            device.append(dataclasses.replace(op, kind=kind))
        else:
            host.append(op)
    return device, host


def profiler_clock(anchors: Sequence[tuple[int, int]]) -> Callable[[int], int]:
    """A ``perf_counter_ns`` reading -> the profiler's clock: moved by the
    ``time_ns - perf_counter_ns`` offset, interpolated between the first
    and last of ``anchors``."""
    (p0, t0), (p1, t1) = anchors[0], anchors[-1]
    slope = (t1 - p1 - (t0 - p0)) / (p1 - p0) if p1 > p0 else 0.0

    def move(p: int) -> int:
        return p + (t0 - p0) + round(slope * (p - p0))

    return move


def on_profiler_clock(trace: object) -> list[PSpan]:
    """The records of a drained ``repro_torch.tracing.Trace`` on the
    profiler's clock (:func:`profiler_clock` of its anchors)."""
    move = profiler_clock(trace.anchors)
    paths: list[tuple[str, ...]] = []
    out = []
    for r in trace.records:
        path = (paths[r.parent] if r.parent >= 0 else ()) + (r.name,)
        paths.append(path)
        out.append(PSpan(r.name, move(r.start_ns), move(r.end_ns), r.thread, path, r.attrs))
    return out


class _Open:
    """Per point (ascending), the innermost interval ``[start, end)`` open
    there among intervals that nest (those of one thread). Times stay whole
    nanoseconds: a float holds an epoch time only to 256 ns."""

    def __init__(self, items: Sequence) -> None:
        self.order = sorted(items, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.order]

    def at(self, points: Sequence[int]) -> list:
        out, stack, i = [], [], 0
        for p in points:
            j = bisect.bisect_right(self.starts, p)
            while i < j:
                s = self.order[i]
                while stack and stack[-1].end_ns <= s.start_ns:
                    stack.pop()
                stack.append(s)
                i += 1
            while stack and stack[-1].end_ns <= p:
                stack.pop()
            out.append(stack[-1] if stack else None)
        return out


def _innermost(items: Sequence, points: Sequence[int]) -> list:
    """The innermost of ``items`` open at each of ``points`` (any order)."""
    order = sorted(range(len(points)), key=points.__getitem__)
    found = _Open(items).at([points[i] for i in order])
    out: list = [None] * len(points)
    for i, f in zip(order, found):
        out[i] = f
    return out


def _union(ops: Sequence[Op], lo: int, hi: int) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for o in sorted(ops, key=lambda o: o.start_ns):
        a, b = max(o.start_ns, lo), min(o.end_ns, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _thread_map(calls: Sequence[Op], roots: Sequence[PSpan]) -> dict[int, int]:
    """The profiler's thread id of each runtime thread -> the program's
    thread id: the program thread whose roots hold most of its calls (the
    two number threads differently)."""
    votes: dict[int, Counter] = defaultdict(Counter)
    for t in {r.thread for r in roots}:
        own = [r for r in roots if r.thread == t]
        for c, r in zip(calls, _innermost(own, [c.start_ns for c in calls])):
            if r is not None:
                votes[c.thread][t] += 1
    return {k: v.most_common(1)[0][0] for k, v in votes.items()}


def summarize(
    device: Sequence[Op], host: Sequence[Op], program: Sequence[PSpan],
    window: tuple[int, int],
) -> Spans:
    lo, hi = window
    inside = [o for o in device if o.end_ns > lo and o.start_ns < hi]
    roots = [s for s in program if len(s.path) == 1 and s.name == ROOT]
    calls = [h for h in host if lo <= h.start_ns < hi]
    tmap = _thread_map(calls, roots)
    by_thread: dict[int, list[PSpan]] = defaultdict(list)
    for s in program:
        by_thread[s.thread].append(s)

    # Each device op -> its runtime call -> the span open on that thread then.
    call_of = {h.corr: h for h in calls if h.corr}
    per_thread: dict[int, list[tuple[Op, Op]]] = defaultdict(list)
    unattributed = 0
    for o in inside:
        c = call_of.get(o.corr)
        if c is None or c.thread not in tmap:
            unattributed += o.end_ns - o.start_ns
        else:
            per_thread[tmap[c.thread]].append((o, c))
    dev: dict[tuple[tuple[str, ...], str], float] = defaultdict(float)
    stage: dict[str, float] = defaultdict(float)
    for t, pairs in per_thread.items():
        spans = _innermost(by_thread[t], [c.start_ns for _, c in pairs])
        for (o, _), s in zip(pairs, spans):
            if s is None:
                unattributed += o.end_ns - o.start_ns
            else:
                dev[s.path, o.kind] += (o.end_ns - o.start_ns) * 1e-9
                if "stage" in s.attrs:
                    stage[f"{s.name}@{s.attrs['stage']}"] += (o.end_ns - o.start_ns) * 1e-9

    # Idle gaps, named on the thread that recorded the most spans.
    busy = _union(inside, lo, hi)
    edges = [lo, *(x for ab in busy for x in ab), hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    main = max(by_thread, key=lambda t: len(by_thread[t]), default=None)
    own_spans = by_thread.get(main, [])
    own_calls = [h for h in calls if tmap.get(h.thread) == main] if main is not None else calls

    def names_at(points: list[int]) -> list[str]:
        out = []
        for p, s, c in zip(points, _innermost(own_spans, points), _innermost(own_calls, points)):
            if c is not None and (s is None or c.start_ns >= s.start_ns):
                out.append(f"{s.name}/{c.name}" if s is not None else c.name)
            else:
                out.append(s.name if s is not None else NO_SPAN)
        return [n[:120] for n in out]

    idle: dict[str, float] = defaultdict(float)
    named = []
    for (a, b), name in zip(gaps, names_at([(a + b) // 2 for a, b in gaps])):
        idle[name] += (b - a) * 1e-9
        named.append((name, (a - lo) * 1e-9, (b - a) * 1e-9))
    # The same gaps cut where a span or call opens or closes, each piece
    # named alone: what the host did over the whole of each gap.
    cuts = sorted({x for s in (*own_spans, *own_calls) for x in (s.start_ns, s.end_ns)})
    pieces = []
    for a, b in gaps:
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        edges_ab = [a, *inner, b]
        pieces += list(zip(edges_ab, edges_ab[1:]))
    split: dict[str, float] = defaultdict(float)
    for (a, b), name in zip(pieces, names_at([(a + b) // 2 for a, b in pieces])):
        split[name] += (b - a) * 1e-9

    # Alignment: every launch and copy call inside a root, within the slack.
    launches = [h for h in calls if h.name.startswith(LAUNCHES)]
    aligned, worst = 0, 0
    starts = sorted(roots, key=lambda r: r.start_ns)
    keys = [r.start_ns for r in starts]
    for h in launches:
        j = bisect.bisect_right(keys, h.start_ns + SLACK_NS)
        near = starts[max(j - 2, 0):j + 1]
        out = min(
            (max(r.start_ns - h.start_ns, h.end_ns - r.end_ns, 0) for r in near),
            default=hi - lo,
        )
        aligned += out <= SLACK_NS
        worst = max(worst, out)
    return Spans(
        window_s=(hi - lo) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        requests=sum(lo <= r.start_ns < hi for r in roots),
        device=dict(dev),
        unattributed_s=unattributed * 1e-9,
        stage=dict(stage),
        idle_gaps=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        idle_split=dict(sorted(split.items(), key=lambda kv: -kv[1])),
        gaps=[(name, a, b) for (a, b), name in zip(gaps, (g[0] for g in named))],
        longest_gaps=sorted(named, key=lambda g: -g[2])[:8],
        launches=len(launches),
        launches_aligned=aligned,
        worst_outside_ns=worst,
    )


def request_times(records: Sequence) -> list[dict[str, tuple[int, int]]]:
    """Per request (root ``service.rank_batch`` record): each span name's
    first (start offset from the root's start, duration) in nanoseconds, the
    root's own under ``ROOT``."""
    out: dict[int, dict[str, tuple[int, int]]] = {}
    roots: dict[int, int] = {}
    for r in records:
        if r.parent < 0 and r.name == ROOT:
            roots[r.request] = r.start_ns
            out[r.request] = {}
    for r in records:
        t0 = roots.get(r.request)
        if t0 is not None:
            out[r.request].setdefault(r.name, (r.start_ns - t0, r.end_ns - r.start_ns))
    return [out[k] for k in sorted(out)]


def request_attrs(records: Sequence) -> list[dict]:
    """Per request (root ``service.rank_batch`` record), what its spans'
    attributes say: ``grid`` (Q, D), ``mode`` and ``capacities`` as
    ``service.pick`` picked them, ``engine`` (mode, stages) as
    ``engine.rank_progressive`` ran, ``bytes`` read, and ``rows`` and
    ``trees`` of each launch by span name (``name@stage`` where the span
    has a stage; rows summed over shards)."""
    out: dict[int, dict] = {}
    for r in records:
        if r.parent < 0 and r.name == ROOT:
            out[r.request] = {"grid": (r.attrs["Q"], r.attrs["D"]), "rows": {}, "trees": {}}
    for r in records:
        req, a = out.get(r.request), r.attrs
        if req is None:
            continue
        if r.name == "service.pick":
            req["mode"], req["capacities"] = a["mode"], tuple(a["capacities"])
        elif r.name == "engine.rank_progressive":
            req["engine"] = (a["mode"], a["stages"])
        elif r.name == "service.read":
            req["bytes"] = a["bytes"]
        key = f"{r.name}@{a['stage']}" if "stage" in a else r.name
        if "rows" in a:
            req["rows"][key] = req["rows"].get(key, 0) + a["rows"]
        if "trees" in a:
            req["trees"][key] = a["trees"]
    return [out[k] for k in sorted(out)]


def _median_ms(ctx: dict, name: str, part: int) -> float | None:
    reqs = ctx.get("span_requests") or []
    values = [req[name][part] for req in reqs if name in req]
    return statistics.median(values) * 1e-6 if values else None


def enqueue_ms(ctx: dict) -> float | None:
    """Median over requests of ``service.read``'s start less the request's
    start: the host's time to enqueue a request's work."""
    return _median_ms(ctx, "service.read", 0)


def unpack_ms(ctx: dict) -> float | None:
    """Median ``service.unpack`` duration."""
    return _median_ms(ctx, "service.unpack", 1)


def _device_ms(ctx: dict, name: str, kinds: tuple[str, ...]) -> float | None:
    s = ctx.get("spans")
    if s is None or not s.requests:
        return None
    value = s.inside(name, kinds)
    return value * 1e3 / s.requests if value else None


def read_ms(ctx: dict) -> float | None:
    """Device time a request of the copies enqueued inside ``service.read``."""
    return _device_ms(ctx, "service.read", ("copy",))


def features_ms(ctx: dict) -> float | None:
    """Device time a request of the kernels enqueued inside
    ``engine.features`` (every stage's)."""
    return _device_ms(ctx, "engine.features", ("kernel",))


def tail_ms(ctx: dict) -> float | None:
    """Device time a request of the kernels enqueued inside ``engine.tail``
    (its compaction, gather, launch and scatter)."""
    return _device_ms(ctx, "engine.tail", ("kernel",))


READERS = {
    "service.enqueue_ms": enqueue_ms,
    "service.unpack_ms": unpack_ms,
    "service.read_ms": read_ms,
    "engine.features_ms": features_ms,
    "engine.tail_ms": tail_ms,
}
