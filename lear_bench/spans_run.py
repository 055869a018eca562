"""One cell's requests with the program's spans recorded, beside the
profiler: where the device's time and its idle gaps go, span by span.

From the root of a checkout, on the card::

    python3 -m lear_bench.spans_run --workload msn1-bulk --seed 7 --seconds 10

Set-up and warm-up are the harness's (:func:`lear_bench.harness.run`'s),
then, over the same pool:

1. the cost of a span site, off and on (a loop of empty spans);
2. a window of ``--seconds`` with recording off, as the benchmark's;
3. ``--passes`` passes under ``torch.profiler`` (device activity and the
   CUDA runtime's calls) with recording off, and as many with it on (the
   profiled segment): kernels and copies a request in each, and
   :func:`lear_bench.spans.summarize` over the second. The loop between
   two requests is watched there too: spans around the harness's sampler
   (``bench.offer``), the free of the last response (``bench.release``),
   the loop test (``bench.more``) and Python's garbage collection
   (``host.gc``), and a watcher process keeping how late
   its wake-ups come, so an idle gap that no span holds is set beside
   whether the whole machine stood over it;
4. as many passes with recording on and no profiler (host span times
   carry none of the profiler's cost a launch), with the service's
   counters (``ServiceStats``) read before and after: the spans'
   attributes set against them;
5. twice as many requests, recording off and on in turns, each pool batch
   twice in a row: their answers compared, their times set side by side.

It prints one JSON line: the five span metrics (:data:`lear_bench.spans.READERS`),
device time and idle time a request by span (and by stage), the alignment
shares, the cost of a span, spans a request, what their attributes say was
launched, the idle that no span holds beside the GC and the watcher, and
the window's and the third segment's request times. No correctness check: the benchmark makes that.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from collections.abc import Iterator
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COST_LOOPS = 1_000      # span sites a timed loop; a loop's spans are drained after it
COST_REPEATS = 200
LATE_PERIOD_S = 0.001   # the watcher's sleep between wake-ups


def _span_cost_ns(tracing: object) -> dict[str, float]:
    """ns a ``with span(name, attr=...)`` site adds to a loop, recording
    off and on (medians of the timed loops, less the bare loop's)."""
    def loop(site: object) -> float:
        times = []
        for _ in range(COST_REPEATS):
            t = time.perf_counter_ns()
            if site is None:
                for _ in range(COST_LOOPS):
                    pass
            else:
                for _ in range(COST_LOOPS):
                    with site("cost", rows=1):
                        pass
            times.append((time.perf_counter_ns() - t) / COST_LOOPS)
            tracing.drain()
        return statistics.median(times)

    bare = loop(None)
    off = loop(tracing.span)
    with tracing.recording(capacity=COST_LOOPS):
        on = loop(tracing.span)
    return {"off": off - bare, "on": on - bare}


# The watcher process: sleeps the period at a time until its stdin closes,
# then prints (perf_counter_ns its wake-up was due, ns late) of each.
WATCHER = """
import os, select, sys, time
period, cpu = float(sys.argv[1]), int(sys.argv[2])
if cpu >= 0:
    os.sched_setaffinity(0, {cpu})
out = []
print("ready", flush=True)
while not select.select([sys.stdin], [], [], 0)[0]:
    due = time.perf_counter_ns() + round(period * 1e9)
    time.sleep(period)
    out.append(f"{due} {time.perf_counter_ns() - due}")
print(chr(10).join(out))
"""


@contextlib.contextmanager
def _watcher(cpu: int | None) -> Iterator[list[tuple[int, int]]]:
    """A process of its own (on ``cpu`` where given) waking every
    :data:`LATE_PERIOD_S` while the block runs; the list it yields is filled
    with its wake-ups (:data:`WATCHER`) once the block ends. It shares no
    lock and no GIL with this process, on the same clock: a wake-up late by
    most of a gap says the whole machine stalled over it, one on time that
    this process alone did."""
    proc = subprocess.Popen(
        [sys.executable, "-c", WATCHER, str(LATE_PERIOD_S), str(-1 if cpu is None else cpu)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    proc.stdout.readline()
    wakes: list[tuple[int, int]] = []
    try:
        yield wakes
    finally:
        out, _ = proc.communicate("")
        wakes += [(int(d), int(late)) for d, late in map(str.split, filter(None, out.splitlines()))]


class _Offered:
    """A sampler whose ``offer`` runs inside a ``bench.offer`` span. It
    holds each offered answer until the next offer and drops it inside a
    ``bench.release`` span: the loop would free a response's arrays between
    two requests, outside any span."""

    def __init__(self, sampler: object, tracing: object) -> None:
        self.sampler, self.tracing, self.held = sampler, tracing, None

    def offer(self, item: object) -> None:
        with self.tracing.span("bench.release"):
            self.held = None
        with self.tracing.span("bench.offer"):
            self.sampler.offer(item)
        self.held = item


@contextlib.contextmanager
def _gc_spans(tracing: object) -> Iterator[None]:
    """Each garbage collection inside a ``host.gc`` span while the block runs."""
    opened = []

    def hook(phase: str, info: dict) -> None:
        if phase == "start":
            s = tracing.span("host.gc", generation=info["generation"])
            s.__enter__()
            opened.append(s)
        elif opened:
            opened.pop().__exit__(None, None, None)

    gc.callbacks.append(hook)
    try:
        yield
    finally:
        gc.callbacks.remove(hook)


def _no_span(
    summary: object, program: list, wakes: list[tuple[int, int]], move: object, lo: int,
) -> dict:
    """The profiled segment's idle gaps named ``host (no span)``: their
    milliseconds, the share of them in gaps over which the watcher's
    latest wake-up came late by half the gap or more (``stalled``: the
    whole machine stood), and the longest eight as ``[start ms, ms, where,
    the watcher's latest ms]`` (where: between two requests, before the
    first, after the last); beside them the GC's milliseconds (``host.gc``
    spans), the spans opened outside a request by name with their median
    and longest milliseconds, and the watcher's lateness over the segment."""
    from lear_bench import spans

    roots = sorted((s.start_ns, s.end_ns) for s in program if s.name == spans.ROOT)
    loop = [s for s in program if len(s.path) == 1 and s.name != spans.ROOT]
    due = sorted((move(d), late) for d, late in wakes)
    keys = [d for d, _ in due]

    def latest(a: int, b: int) -> int:
        inside = due[bisect.bisect_left(keys, a):bisect.bisect_left(keys, b)]
        return max((late for _, late in inside), default=0)

    def where(a: int, b: int) -> str:
        if not roots or b <= roots[0][0]:
            return "before the first request"
        return "after the last request" if a >= roots[-1][1] else "between two requests"

    gaps = sorted((g for g in summary.gaps if g[0] == spans.NO_SPAN), key=lambda g: g[1] - g[2])
    stalled = sum(b - a for _, a, b in gaps if latest(a, b) >= (b - a) / 2)
    lates = [late * 1e-6 for _, late in due]
    return {
        "ms": sum(b - a for _, a, b in gaps) * 1e-6,
        "stalled_ms": stalled * 1e-6,
        "longest": [[(a - lo) * 1e-6, (b - a) * 1e-6, where(a, b), latest(a, b) * 1e-6]
                    for _, a, b in gaps[:8]],
        "gc_ms": sum(s.end_ns - s.start_ns for s in program if s.name == "host.gc") * 1e-6,
        "loop_spans": dict(Counter(s.name for s in loop)),
        "loop_ms_p50_max": {
            name: [statistics.median(ds), max(ds)]
            for name in sorted({s.name for s in loop})
            for ds in [[(s.end_ns - s.start_ns) * 1e-6 for s in loop if s.name == name]]
        },
        "watcher_wakes": len(due),
        "watcher_late_ms_p50": statistics.median(lates) if lates else None,
        "watcher_late_ms_max": max(lates, default=None),
    }


def _launched(records: list, before: dict | None, after: dict | None) -> dict:
    """What the spans' attributes say the requests launched, beside what
    the service's counters moved by over the same requests: the picked
    mode and capacities, the tail rows, rows and tree-rows a request by
    span, and the grid, engine and bytes read."""
    from lear_bench import harness, spans

    reqs = spans.request_attrs(records)
    moved = harness.stats_delta(after, before) or {}
    picked = Counter(f"{r['mode']} {list(r['capacities'])}" for r in reqs)
    tail = sum(r["rows"].get("engine.tail", 0) for r in reqs)
    counted = sum(c[-1] * n for c, n in moved.get("capacities", {}).items())
    keys = sorted({k for r in reqs for k in r["rows"]})

    def p50(values: list) -> float | None:
        return statistics.median(values) if values else None

    continued = moved.get("docs_continued")
    return {
        "picked": dict(picked),
        "stats_capacities": {str(list(c)): n for c, n in moved.get("capacities", {}).items()},
        "stats_staged": moved.get("batches_staged", 0),
        "spans_staged": sum(r["mode"] == "staged" for r in reqs),
        "tail_rows": {"spans": tail, "stats": counted},
        "capacity_waste": {"spans": tail / continued if continued else None,
                           "stats": counted / continued if continued else None},
        "rows_a_request": {k: p50([r["rows"][k] for r in reqs if k in r["rows"]]) for k in keys},
        "tree_rows_a_request": {
            k: p50([r["rows"][k] * r["trees"][k] for r in reqs if k in r["trees"]])
            for k in keys if any(k in r["trees"] for r in reqs)
        },
        "grid": {str(list(g)): n for g, n in Counter(r["grid"] for r in reqs).items()},
        "engine": {f"{m} {n}": c for (m, n), c in Counter(r["engine"] for r in reqs).items()},
        "read_bytes_p50": p50([r["bytes"] for r in reqs]),
    }


def _host_ms(requests: list[dict[str, tuple[int, int]]]) -> dict[str, float]:
    """Median host milliseconds of each span name over requests."""
    names = sorted({n for r in requests for n in r})
    return {n: statistics.median(r[n][1] for r in requests if n in r) * 1e-6 for n in names}


def measure(
    cell: object, seed: int, seconds: float, passes: int, device: str,
    pin_cpus: list[int] | None = None,
) -> dict:
    """The measurements above for ``cell``, as the printed line's object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lear_bench import generator, harness, spans, weights
    from repro_torch import tracing

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels import forest_score as fs

        fs.set_build_dir(harness.BUILD_DIR)
        fs.library()
    if pin_cpus:
        os.sched_setaffinity(0, {pin_cpus[0]})
        torch.set_num_threads(1)
    cfg, traffic, wl = cell.config, cell.traffic, cell.workload
    sentinels = harness.sentinels_of(cfg)
    F = cfg["n_features"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 64))
    ranker = weights.draw_ranker(gen, cfg["n_trees"], cfg["depth"], F, dev)
    clfs = [
        weights.draw_classifier(cfg["classifier_seed"] + k, cfg["classifier_trees"],
                                cfg["classifier_depth"], F + 4, dev)
        for k in range(len(sentinels))
    ]
    pool = generator.make_pool(traffic, F, seed, gen, dev)
    svc = harness.system_build(cfg.get("system", "ranking_service"))(
        ranker, clfs, sentinels, cfg, wl["threshold"], dev,
    )
    P, clients = len(pool.batches), traffic["clients"]

    def passes_of(n: int, first: int, watch: bool = False) -> tuple[harness.Record, int]:
        if not watch:
            return harness.closed_loop(
                svc, pool, harness.Sampler(seed, 0), first, clients, pin_cpus,
                lambda started, t0: started < n * P,
            )

        def more(started: int, t0: float) -> bool:
            with tracing.span("bench.more"):
                return started < n * P

        with _gc_spans(tracing):
            return harness.closed_loop(
                svc, pool, _Offered(harness.Sampler(seed, 0), tracing), first, clients,
                pin_cpus, more,
            )

    _, i = passes_of(harness.WARMUP_PASSES, 0)
    cost = _span_cost_ns(tracing)

    window, i = harness.closed_loop(
        svc, pool, harness.Sampler(seed, 0), i, clients, pin_cpus,
        lambda started, t0: time.perf_counter() - t0 < seconds,
    )

    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    profiled = {}
    other_cpu = pin_cpus[1] if pin_cpus and len(pin_cpus) > 1 else None
    for on in (False, True):
        tracing.drain()
        # The watcher and the loop's spans in the second segment only.
        with _watcher(other_cpu) if on else contextlib.nullcontext([]) as wakes, \
                tracing.recording() if on else contextlib.nullcontext(), \
                profile(activities=acts) as prof:
            win = time.time_ns()
            seg, i = passes_of(passes, i, watch=on)
            if cuda:
                torch.cuda.synchronize(dev)
            win = (win, time.time_ns())
        profiled[on] = (prof, seg, tracing.drain(), win)
    device_ops, host = spans.collect(profiled[True][0])
    trace, win = profiled[True][2], profiled[True][3]
    program = spans.on_profiler_clock(trace)
    summary = spans.summarize(device_ops, host, program, win)
    no_span = _no_span(summary, program, wakes, spans.profiler_clock(trace.anchors), win[0])

    tracing.drain()
    before = harness.stats_of(svc)
    with tracing.recording():
        third, i = passes_of(passes, i)
    third_trace = tracing.drain()
    launched = _launched(third_trace.records, before, harness.stats_of(svc))
    ms = lambda xs: statistics.median(xs) * 1e3   # noqa: E731
    ctx = {"spans": summary,
           "span_requests": spans.request_times(third_trace.records)}

    # Recording off and on, request by request: the same answers, and the
    # cost a request (alternating, so the host's slow spells fall on both).
    same, times = True, {False: [], True: []}
    for n in range(passes * 2 * P):
        p = (n // 2) % P
        on = n % 2 == 1
        with tracing.recording() if on else contextlib.nullcontext():
            t = time.perf_counter()
            out = svc.rank_batch(*pool.batches[p])
            times[on].append(time.perf_counter() - t)
        tracing.drain()
        if on:
            same &= all(a.tobytes() == b.tobytes() for a, b in zip(last, out))
        last = out
    alternating = {"off": ms(times[False]), "on": ms(times[True])}

    def per_request(prof: object, n: int) -> dict[str, float]:
        ops = spans.collect(prof)[0]
        return {kind: sum(o.kind == kind for o in ops) / n for kind in ("kernel", "copy")}

    n_seg = len(profiled[True][1].latencies_s)
    result = {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "torch": torch.__version__, "os_release": os.uname().release,
        "metrics": {name: read(ctx) for name, read in spans.READERS.items()},
        "requests": {"profiled": n_seg, "third": len(third.latencies_s),
                     "window": len(window.latencies_s)},
        "device_ms_by_span": {k: v * 1e3 / n_seg for k, v in summary.by_innermost().items()},
        "device_ms_by_stage": {k: v * 1e3 / n_seg for k, v in summary.stage.items()},
        "device_ms_inside": {
            name: summary.inside(name, ("kernel", "copy")) * 1e3 / n_seg
            for name in ("service.put", "service.pick", "engine.head", "engine.features",
                         "engine.classifier", "engine.compact", "engine.middle",
                         "engine.tail", "service.topk", "service.read", "service.unpack")
        },
        "idle_ms_by_span": {k: v * 1e3 / n_seg for k, v in summary.idle_gaps.items()},
        "idle_split_ms": {k: v * 1e3 / n_seg for k, v in summary.idle_split.items()},
        "longest_gaps_ms": [[name, a * 1e3, s * 1e3] for name, a, s in summary.longest_gaps],
        "no_span": no_span,
        "launched": launched,
        "roots_ms": [[(r.start_ns - win[0]) * 1e-6, (r.end_ns - win[0]) * 1e-6]
                     for r in program if r.name == spans.ROOT],
        "idle_share": 1 - summary.busy_s / summary.window_s,
        "aligned_share": summary.aligned_share, "launches": summary.launches,
        "worst_outside_us": summary.worst_outside_ns * 1e-3,
        "attributed_share": summary.attributed_share,
        "ops_a_request": {
            "off": per_request(profiled[False][0], len(profiled[False][1].latencies_s)),
            "on": per_request(profiled[True][0], n_seg),
        },
        "span_cost_ns": cost,
        "request_ms_p50_alternating": alternating,
        "spans_a_request": len(third_trace.records) / max(len(third.latencies_s), 1),
        "dropped": trace.dropped + third_trace.dropped,
        "request_ms_p50": {"window": ms(window.latencies_s), "third": ms(third.latencies_s),
                           "profiled": ms(profiled[True][1].latencies_s)},
        "outputs_equal_on_off": bool(same),
        "host_ms_by_span_p50": _host_ms(ctx["span_requests"]),
        "profiled_host_ms_by_span_p50": _host_ms(spans.request_times(trace.records)),
    }
    return result


def main(argv: list[str] | None = None) -> int:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "lear_bench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from lear_bench import harness

    if not torch.cuda.is_available():
        print("lear_bench.spans_run: needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(
        harness.load_cell(args.workload), args.seed, args.seconds, args.passes, "cuda",
        pin_cpus=sorted(os.sched_getaffinity(0), reverse=True),
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
