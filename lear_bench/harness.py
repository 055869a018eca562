"""One run of one cell: set-up, the measured window, an optional traced
segment, the check against the reference, and the result line.

:func:`run` is the whole of it; :mod:`lear_bench.run` is its command line
(which insists on a card). Tests call :func:`run` on the CPU at small sizes.

Everything of one cell is found by name, so a cell, a configuration, a
traffic mix, a system or a metric is added as files and manifest entries:
``workloads/<cell>.json`` (configuration, traffic, threshold, the check's
limits), ``configs/<name>.json`` (sizes; ``system`` names the module of
:mod:`lear_bench.systems` that builds what the window drives, by default
``ranking_service``), ``traffic/<name>.json`` (parameters of the one
generator, :mod:`lear_bench.generator`), ``metrics/<name>.py`` (a
``read(ctx)`` over the run's readings: see ``ctx`` in :func:`run`).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import threading
import time
from collections import Counter
from collections.abc import Callable
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD_DIR = ROOT / "build" / "repro_torch"   # the kernel library, inside the checkout
WARMUP_PASSES = 16   # passes over the pool before the window: the first second
#   of back-to-back requests after start-up runs slower (measured on the H100)
TRACED_PASSES = 4    # passes over the pool in a traced run's profiled segment
SAMPLE = 6           # requests of the window checked against the reference
DRAIN_S = 60.0       # an open loop serves what arrived in the window until
#   this long past its close; a request not served by then never came
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


@dataclasses.dataclass
class Cell:
    """A cell and what it names, as files of this folder."""

    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int = 1


def _json(path: Path) -> dict:
    with path.open() as f:
        return json.load(f)


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files."""
    manifest = manifest if manifest is not None else _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} != BENCHMARK.json's {entry[key]!r}")
    config = _json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = _json(BENCH / "traffic" / f"{entry['traffic']}.json")
    applies = lambda m: name in m.get("workloads", (name,))
    return Cell(
        name=name, config=config, traffic=traffic, workload=workload,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
        chips=entry["chips"],
    )


def _module(folder: str, name: str) -> object:
    """``<folder>/<name>.py`` of this folder, loaded by its file name (a
    name may hold dots and dashes)."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py in {BENCH}")
    spec = importlib.util.spec_from_file_location(f"lear_bench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable[[dict], float | None]:
    """``metrics/<name>.py``'s ``read``."""
    return _module("metrics", name).read


def system_build(name: str) -> Callable[..., object]:
    """``systems/<name>.py``'s ``build``."""
    return _module("systems", name).build


def sentinels_of(config: dict) -> tuple[int, ...]:
    return tuple(s for s in (config["sentinel"], config.get("sentinel2", 0)) if s)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Sampler:
    """A uniform sample of ``k`` requests of a stream, drawn from the seed
    (reservoir sampling), kept with the program's answers."""

    def __init__(self, seed: int, k: int) -> None:
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.k = k
        self.seen = 0
        self.kept: list[tuple[int, np.ndarray, np.ndarray]] = []

    def offer(self, item: tuple[int, np.ndarray, np.ndarray]) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def stats_of(svc: object) -> dict | None:
    """A copy of the system's counters (its ``stats`` dataclass), or None."""
    st = getattr(svc, "stats", None)
    if st is None or not dataclasses.is_dataclass(st):
        return None
    return copy.deepcopy(dataclasses.asdict(st))


def stats_delta(after: dict | None, before: dict | None) -> dict | None:
    """What the counters moved by between two copies: numbers subtracted,
    dicts of counts subtracted key by key (keys that did not move left out)."""
    if after is None or before is None:
        return None
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, dict):
            b = b or {}
            out[k] = {kk: vv - b.get(kk, 0) for kk, vv in v.items() if vv != b.get(kk, 0)}
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = v - (b or 0)
        else:
            out[k] = v
    return out


def on_device(batch: tuple, dev: object) -> tuple:
    """A pool batch as tensors on ``dev`` (host inputs are numpy arrays)."""
    import torch

    return tuple(torch.as_tensor(a, device=dev) for a in batch)


@dataclasses.dataclass
class Record:
    """What a loop served: each request's seconds, requests a pool batch,
    real documents, its first start and last return, and (an open loop's)
    requests that arrived and were not served."""

    latencies_s: list[float]
    served: Counter
    docs: int
    start: float
    end: float
    unserved: int = 0

    def add(self, p: int, docs: int, a: float, b: float) -> None:
        self.latencies_s.append(b - a)
        self.served[p] += 1
        self.docs += docs
        self.end = max(self.end, b)


def closed_loop(
    svc: object, pool: object, sampler: Sampler, first: int, clients: int,
    cpus: list[int] | None, more: Callable[[int, float], bool],
) -> tuple[Record, int]:
    """``clients`` callers, each sending the pool's next request once its
    last one returned, from request ``first`` on while ``more(requests
    started, start)`` holds: (what they served, the next request's index).
    One client runs on the calling thread; more run on threads of their own,
    client ``j`` on ``cpus[j]`` where given, and a client's error is raised
    here once every client has stopped."""
    P = len(pool.batches)
    rec = Record([], Counter(), 0, time.perf_counter(), 0.0)
    lock = threading.Lock()
    nxt = [first]
    errors: list[BaseException] = []

    def client(cpu: int | None) -> None:
        if cpu is not None:
            os.sched_setaffinity(0, {cpu})
        while True:
            with lock:
                if errors or not more(nxt[0] - first, rec.start):
                    return
                k = nxt[0]
                nxt[0] += 1
            p = k % P
            a = time.perf_counter()
            top, scores = svc.rank_batch(*pool.batches[p])
            b = time.perf_counter()
            with lock:
                rec.add(p, pool.real_docs[p], a, b)
                sampler.offer((p, top, scores))

    def guarded(cpu: int | None) -> None:
        try:
            client(cpu)
        except BaseException as e:   # re-raised on the calling thread below
            with lock:
                errors.append(e)

    if clients == 1:
        client(None)
    else:
        threads = [
            threading.Thread(target=guarded, args=(cpus[j % len(cpus)] if cpus else None,))
            for j in range(clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    return rec, nxt[0]


def open_loop(
    svc: object, pool: object, sampler: Sampler, due: np.ndarray, limit_s: float,
) -> tuple[Record, int]:
    """One dispatcher serving requests that arrive at ``due`` (seconds from
    the start) in arrival order, each timed from its arrival; arrivals not
    started within ``limit_s`` are left unserved."""
    P = len(pool.batches)
    rec = Record([], Counter(), 0, time.perf_counter(), 0.0)
    i = 0
    while i < len(due) and time.perf_counter() - rec.start < limit_s:
        wait = rec.start + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        p = i % P
        top, scores = svc.rank_batch(*pool.batches[p])
        rec.add(p, pool.real_docs[p], rec.start + due[i], time.perf_counter())
        sampler.offer((p, top, scores))
        i += 1
    rec.unserved = len(due) - i
    return rec, i


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(
    cell: Cell, seed: int, seconds: float, trace: bool, device: str,
    t_start: float, log: Callable[[str], None] = _stderr,
    service: Callable[..., object] | None = None, pin_cpus: list[int] | None = None,
) -> dict:
    """One run of ``cell``: the result line's object. ``service`` builds
    what the window drives (default: the configuration's ``system``, a
    module of :mod:`lear_bench.systems`); the control puts the reference
    there (:mod:`lear_bench.control`). ``pin_cpus``: the CPUs that the
    calling thread (the first) and the loop's clients keep to once the card
    is up (threads started before stay free), with torch's host ops on one
    thread."""
    mark = time.perf_counter()
    import torch

    from lear_bench import check, generator, reference, weights, work
    from lear_bench import trace as tr
    from repro_torch.kernels import forest_score as fs

    parts: dict[str, float] = {"start": mark - t_start}

    def lap(name: str) -> None:
        nonlocal mark
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.init()
    lap("import")
    if dev.type == "cuda":
        fs.set_build_dir(BUILD_DIR)
        fs.library()
    if pin_cpus:
        os.sched_setaffinity(0, {pin_cpus[0]})
        torch.set_num_threads(1)
    lap("kernels")

    cfg, traffic, wl = cell.config, cell.traffic, cell.workload
    sentinels = sentinels_of(cfg)
    F, T = cfg["n_features"], cfg["n_trees"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 64))
    ranker = weights.draw_ranker(gen, T, cfg["depth"], F, dev)
    clfs = [
        weights.draw_classifier(
            cfg["classifier_seed"] + k, cfg["classifier_trees"], cfg["classifier_depth"],
            F + 4, dev,
        )
        for k in range(len(sentinels))
    ]
    lap("weights")
    pool = generator.make_pool(traffic, F, seed, gen, dev)
    lap("inputs")

    make = service or system_build(cfg.get("system", "ranking_service"))
    svc = make(ranker, clfs, sentinels, cfg, wl["threshold"], dev)
    lap("service")
    P = len(pool.batches)
    closed_loop(svc, pool, Sampler(seed, 0), 0, traffic["clients"], pin_cpus,
                lambda started, t0: started < WARMUP_PASSES * P)
    lap("warmup")
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{k} {v:.6f} s" for k, v in parts.items())
        + f"; total {setup_s:.6f} s from process start")

    cuda = dev.type == "cuda"
    cards = [torch.device("cuda", c) for c in range(cell.chips)] if cuda else []
    setup_peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    touches = fs.first_touches()
    sampler = Sampler(seed, SAMPLE)
    due = generator.arrivals(traffic, seed, seconds)   # None: a closed loop
    stats_start = stats_of(svc)
    if due is None:
        rec, i = closed_loop(
            svc, pool, sampler, 0, traffic["clients"], pin_cpus,
            lambda started, t0: time.perf_counter() - t0 < seconds,
        )
    else:
        rec, i = open_loop(svc, pool, sampler, due, seconds + DRAIN_S)
    lat, served, docs, unserved = rec.latencies_s, rec.served, rec.docs, rec.unserved
    window_s = rec.end - rec.start
    stats_window = stats_delta(stats_of(svc), stats_start)
    window_peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)
    memory_peak = max(setup_peak, window_peak)
    q = np.percentile(np.asarray(lat) * 1e3, [0, 50, 90, 95, 99, 100])
    log(f"window: {len(lat)} requests in {window_s:.6f} s ({unserved} arrived and not "
        f"served); request ms min/p50/p90/p95/p99/max " + "/".join(f"{x:.3f}" for x in q))
    if stats_window is not None:
        log(f"service counters over the window: {stats_window}")

    summary, traced, stats_traced = None, Counter(), None
    if trace:
        # Device activity alone: recording every host op would cost the
        # host more than the requests do, and the idle share would read
        # the profiler. The host's side is the CUDA runtime's calls.
        from torch.profiler import ProfilerActivity, profile, record_function

        before = stats_of(svc)
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                seg, _ = closed_loop(
                    svc, pool, sampler, i, traffic["clients"], pin_cpus,
                    lambda started, t0: started < TRACED_PASSES * P,
                )
            if cuda:
                torch.cuda.synchronize(dev)
        traced = seg.served
        summary = tr.summarize(*tr.collect(prof))
        stats_traced = stats_delta(stats_of(svc), before)
    moved = {k: v - touches[k] for k, v in fs.first_touches().items() if v != touches[k]}
    if moved:
        log(f"warning: first touches inside the window: {moved}")

    # The program's state goes before the reference runs on the card.
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    limits = wl["limits"]
    # A traced run checks every pool batch: its work counts need them all.
    needed = range(P) if trace else sorted({p for p, _, _ in sampler.kept})
    refs = {}
    for p in needed:
        X, mask = on_device(pool.batches[p], dev)
        refs[p] = reference.reference(
            X, mask, ranker, clfs, sentinels, wl["threshold"], cfg["top_k"],
            eps=limits["score_gap"],
        )
    gaps = [
        check.score_gaps(s, t, on_device(pool.batches[p], "cpu")[1], refs[p])
        for p, t, s in sampler.kept
    ]
    numbers = {
        "score_gap": max(g[0] for g in gaps),
        "topk_gap": max(g[1] for g in gaps),
    }
    correct = check.judge(numbers, limits) and unserved == 0
    for p, r in refs.items():
        log(f"reference: pool batch {p}: real {r.real}, survivors {r.survivors} "
            f"(share {[n / r.real for n in r.survivors]}), fragile {r.fragile}")
    log(f"check: {len(gaps)} sampled requests of {sampler.seen}, "
        f"reference {time.perf_counter() - t_ref:.3f} s")

    def request_work(p: int) -> work.Work:
        r = refs[p]
        return work.request_work(
            r.real, r.survivors, sentinels, T, cfg["depth"], cfg["classifier_trees"],
            cfg["classifier_depth"], F,
        )

    # What a metric's reader (metrics/<name>.py) may read.
    ctx = {
        "window_s": window_s, "latencies_s": lat, "docs": docs, "setup_s": setup_s,
        "unserved": unserved,
        "window_peak_bytes": window_peak, "pool_bytes": pool.device_bytes,
        "stats_window": stats_window, "stats_traced": stats_traced,
        "trace": summary, "traced_requests": sum(traced.values()),
        "traced_work": sum((request_work(p) * n for p, n in traced.items()), work.Work()),
        "window_work": (
            sum((request_work(p) * n for p, n in served.items()), work.Work())
            if trace else None
        ),
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": bool(correct),
        "attempted": len(lat) + unserved,
        "failed": unserved,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in summary.device_ops],
            "idle_gaps": [list(x) for x in summary.idle_gaps],
        }
    result["check"] = {
        name: {"value": numbers[name], "limit": limits[name]} for name in limits
    }
    return result
