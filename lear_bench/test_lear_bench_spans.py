"""The program's spans beside the profiler's events (``lear_bench.spans``):
a summary by hand, the readers without spans, and the spans command on the
CPU and (``-m cuda``) on the card."""

import time

import pytest

torch = pytest.importorskip("torch")

from lear_bench import spans, spans_run  # noqa: E402
from lear_bench.smallcell import small_cell  # noqa: E402
from repro_torch.tracing import Record, Trace  # noqa: E402

OFF = 1_790_000_000_000_000_000     # the profiler's clock less the program's
TID, RUNTIME_TID = 4242, 1          # the two number one thread differently


def _by_hand():
    """One request on the program's clock, its runtime calls and device ops
    on the profiler's (times in ns)."""
    def rec(name, parent, a, b, **attrs):
        return Record(name, 0, parent, a, b, TID, attrs)

    records = [
        rec("service.rank_batch", -1, 0, 100, Q=1, D=8),
        rec("engine.tail", 0, 10, 40, rows=4, trees=10),
        rec("engine.compact", 1, 12, 18, stage=0, rows=4),
        rec("service.read", 0, 48, 80, bytes=120),
        rec("service.unpack", 0, 80, 95),
    ]
    trace = Trace(records, 0, [(-5, -5 + OFF), (300_000, 300_000 + OFF)])

    def op(name, a, b, corr, kind):
        return spans.Op(name, a + OFF, b + OFF, corr, RUNTIME_TID, kind)

    host = [
        op("cudaLaunchKernel", 13, 14, 1, "host"),      # inside the compaction
        op("cudaLaunchKernel", 20, 22, 2, "host"),      # inside the tail
        op("cudaMemcpyAsync", 50, 78, 3, "host"),       # inside the read
        op("cudaLaunchKernel", 60_200, 60_300, 5, "host"),   # 60 µs past the request
    ]
    device = [
        op("compact_kernel", 15, 30, 1, "kernel"),
        op("forest_score_kernel", 30, 45, 2, "kernel"),
        op("Memcpy DtoH (Device -> Pageable)", 60, 70, 3, "copy"),
        op("stray_kernel", 96, 98, 99, "kernel"),        # no runtime call: no span
    ]
    return trace, device, host, (OFF, 100_000 + OFF)


def test_summary_by_hand():
    trace, device, host, window = _by_hand()
    program = spans.on_profiler_clock(trace)     # the clock offset undone
    assert [(s.start_ns - OFF, s.end_ns - OFF) for s in program][:2] == [(0, 100), (10, 40)]
    s = spans.summarize(device, host, program, window)
    assert s.requests == 1 and s.window_s == pytest.approx(100_000e-9)
    # Kernels and copies by the span open when their runtime call was made
    # (the correlation id joins them); the stray kernel has no span.
    tail = ("service.rank_batch", "engine.tail")
    assert s.device == {
        ((*tail, "engine.compact"), "kernel"): pytest.approx(15e-9),
        (tail, "kernel"): pytest.approx(15e-9),
        (("service.rank_batch", "service.read"), "copy"): pytest.approx(10e-9),
    }
    assert s.unattributed_s == pytest.approx(2e-9)
    assert s.stage == {"engine.compact@0": pytest.approx(15e-9)}   # by the span's stage
    assert s.inside("engine.tail", ("kernel",)) == pytest.approx(30e-9)
    assert s.attributed_share == pytest.approx(40 / 42)
    assert s.by_innermost()[spans.NO_SPAN] == pytest.approx(2e-9)
    # Idle gaps by what was open at their midpoints.
    assert s.idle_gaps == {
        "service.rank_batch": pytest.approx(15e-9),                  # [0, 15)
        "service.read/cudaMemcpyAsync": pytest.approx(15e-9),        # [45, 60)
        "service.unpack": pytest.approx(26e-9),                      # [70, 96)
        spans.NO_SPAN: pytest.approx((100_000 - 98) * 1e-9),         # after the request
    }
    assert sum(s.idle_gaps.values()) + s.busy_s == pytest.approx(s.window_s)
    # Cut where a span or call opens or closes, the gaps split further.
    assert s.idle_split == {
        "service.rank_batch": pytest.approx(16e-9),    # [0, 10) [45, 48) [95, 96) [98, 100)
        "engine.tail": pytest.approx(2e-9),                          # [10, 12)
        "engine.compact": pytest.approx(2e-9),                       # [12, 13) [14, 15)
        "engine.compact/cudaLaunchKernel": pytest.approx(1e-9),      # [13, 14)
        "service.read": pytest.approx(4e-9),                         # [48, 50) [78, 80)
        "service.read/cudaMemcpyAsync": pytest.approx(18e-9),        # [50, 60) [70, 78)
        "service.unpack": pytest.approx(15e-9),                      # [80, 95)
        "cudaLaunchKernel": pytest.approx(100e-9),                   # outside the program
        spans.NO_SPAN: pytest.approx(99_800e-9),
    }
    assert s.longest_gaps[0] == (spans.NO_SPAN, pytest.approx(98e-9), pytest.approx(99_902e-9))
    assert [(n, a - OFF, b - OFF) for n, a, b in s.gaps] == [
        ("service.rank_batch", 0, 15), ("service.read/cudaMemcpyAsync", 45, 60),
        ("service.unpack", 70, 96), (spans.NO_SPAN, 98, 100_000),
    ]
    # Three of the four launches lie inside the request; the fourth 60 µs out.
    assert (s.launches, s.launches_aligned) == (4, 3)
    assert s.worst_outside_ns == 60_300 - 100


def test_a_wrong_clock_misplaces_the_spans():
    trace, device, host, window = _by_hand()
    shifted = Trace(trace.records, 0, [(p, t + 1_000_000) for p, t in trace.anchors])
    s = spans.summarize(device, host, spans.on_profiler_clock(shifted), window)
    assert s.launches_aligned == 0 and s.attributed_share == 0.0


def test_request_attrs():
    trace, *_ = _by_hand()
    pick = Record("service.pick", 0, 0, 1, 2, TID, {"capacities": (4, 4), "mode": "staged"})
    engine = Record("engine.rank_progressive", 0, 0, 3, 9, TID, {"mode": "staged", "stages": 2})
    stray = Record("engine.tail", 7, -1, 0, 1, TID, {"rows": 9, "trees": 1})   # no root
    (req,) = spans.request_attrs([*trace.records, pick, engine, stray])
    assert req == {
        "grid": (1, 8), "mode": "staged", "capacities": (4, 4), "engine": ("staged", 2),
        "bytes": 120, "rows": {"engine.tail": 4, "engine.compact@0": 4},
        "trees": {"engine.tail": 10},
    }


def test_readers_of_the_spans():
    trace, device, host, window = _by_hand()
    s = spans.summarize(device, host, spans.on_profiler_clock(trace), window)
    ctx = {"spans": s, "span_requests": spans.request_times(trace.records)}
    got = {name: read(ctx) for name, read in spans.READERS.items()}
    assert got == {
        "service.enqueue_ms": pytest.approx(48e-6),    # read start less the request's
        "service.unpack_ms": pytest.approx(15e-6),
        "service.read_ms": pytest.approx(10e-6),
        "engine.features_ms": None,                    # no such span
        "engine.tail_ms": pytest.approx(30e-6),
    }


@pytest.mark.parametrize("ctx", [
    {},                                                   # no recording at all
    {"spans": None, "span_requests": []},                 # off the card, nothing recorded
    # The control (the reference in the program's place) opens no span: the
    # profiler's events are there, the program's are not.
    {"spans": "control", "span_requests": spans.request_times([])},
], ids=["empty", "nothing recorded", "control"])
def test_readers_give_none_without_spans(ctx):
    if ctx.get("spans") == "control":
        _, device, host, window = _by_hand()
        ctx["spans"] = spans.summarize(device, host, [], window)
    assert {name: read(ctx) for name, read in spans.READERS.items()} == dict.fromkeys(
        spans.READERS
    )


@pytest.mark.parametrize("sentinel2,n_spans", [(0, 12), (12, 16)])
def test_spans_command_on_the_cpu(sentinel2, n_spans, monkeypatch):
    monkeypatch.setattr(spans_run, "COST_REPEATS", 3)
    cell = small_cell(sentinel2=sentinel2, mode="staged" if sentinel2 else "auto")
    r = spans_run.measure(cell, 2**31 + 31, 0.05, 1, "cpu")
    host = {"service.enqueue_ms", "service.unpack_ms"}
    assert {k for k, v in r["metrics"].items() if v is not None} == host   # no device here
    assert all(r["metrics"][k] > 0 for k in host)
    assert r["spans_a_request"] == n_spans and r["dropped"] == 0
    assert r["outputs_equal_on_off"] is True
    # The attributes agree with the service's counters over the same requests.
    got = r["launched"]
    assert got["tail_rows"]["spans"] == got["tail_rows"]["stats"] > 0
    assert got["capacity_waste"]["spans"] == got["capacity_waste"]["stats"]
    assert got["spans_staged"] == got["stats_staged"]
    assert sum(got["picked"].values()) == sum(got["stats_capacities"].values())
    assert {k.split(" ", 1)[1] for k in got["picked"]} == set(got["stats_capacities"])
    assert got["grid"] == {"[16, 32]": r["requests"]["third"]}
    assert ("engine.middle@1" in got["rows_a_request"]) == bool(sentinel2)
    # The watcher woke through the profiled segment; the loop's spans were there.
    no_span = r["no_span"]
    assert no_span["watcher_wakes"] > 0 and no_span["watcher_late_ms_max"] >= 0
    assert 0 <= no_span["stalled_ms"] <= no_span["ms"]
    assert no_span["loop_spans"]["bench.offer"] == r["requests"]["profiled"]
    assert no_span["loop_spans"]["bench.release"] == r["requests"]["profiled"]
    assert no_span["loop_spans"]["bench.more"] == r["requests"]["profiled"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel2", [0, 12])
def test_spans_command_on_the_card(sentinel2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = time.perf_counter()
    r = spans_run.measure(small_cell(sentinel2=sentinel2, queries=64), 2**31 + 5, 0.3, 2, "cuda")
    assert all(v is not None and v > 0 for v in r["metrics"].values()), r["metrics"]
    assert r["aligned_share"] == 1.0 and r["attributed_share"] >= 0.99
    assert r["ops_a_request"]["on"] == r["ops_a_request"]["off"]
    assert r["launched"]["tail_rows"]["spans"] == r["launched"]["tail_rows"]["stats"] > 0
    assert r["device_ms_by_stage"]["engine.features@0"] > 0
    assert r["outputs_equal_on_off"] is True and time.perf_counter() - t < 300
