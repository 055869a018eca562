"""The harness end to end on the CPU at the smoke config's sizes: a sound
run is correct, the control and each fault the cells can have are not,
the manifest names only files that exist, and the trace reduction."""

import json
import re
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from lear_bench import harness, trace  # noqa: E402
from lear_bench.control import ControlService  # noqa: E402
from lear_bench.smallcell import small_cell  # noqa: E402

SEED = 2**31 + 977     # larger than 32 signed bits hold
SECONDS = 0.15


def _run(cell, trace_on=False, service=None):
    return harness.run(cell, SEED, SECONDS, trace_on, "cpu", time.perf_counter(),
                       log=lambda msg: None, service=service)


@pytest.mark.parametrize("clients", [1, 2])
@pytest.mark.parametrize("sentinel2", [0, 12])
def test_sound_run_is_correct(sentinel2, clients):
    cell = small_cell(sentinel2=sentinel2)
    cell.traffic["clients"] = clients
    result = _run(cell)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"docs_per_s", "setup_s"}  # peak_gib: card only
    assert list(result)[-1] == "check"
    for c in result["check"].values():
        assert 0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("clients", [1, 2])
def test_traced_run_reports_per_layer_metrics(clients):
    cell = small_cell(sentinel2=12)
    cell.traffic["clients"] = clients
    result = _run(cell, trace_on=True)
    assert result["correct"] is True
    # On the CPU no device metric is reported; the service's are.
    assert set(result["metrics"]) == {
        "service.capacity_waste", "service.batch_ms_p50", "service.batch_ms_p95",
    }
    assert result["metrics"]["service.capacity_waste"]["value"] > 1
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_control_is_not_correct():
    result = _run(small_cell(), service=ControlService)
    assert result["correct"] is False
    assert result["check"]["score_gap"]["value"] > result["check"]["score_gap"]["limit"]


def _altered_answer(monkeypatch):
    from repro_torch.core import cascade

    real = cascade.CascadeRanker.rank_progressive

    def altered(self, X, mask, *args, **kwargs):
        result = real(self, X, mask, *args, **kwargs)
        scores = result.scores.clone()
        scores[0, 0] += 0.1              # slot 0 of a query is always real
        result.scores = scores
        return result

    monkeypatch.setattr(cascade.CascadeRanker, "rank_progressive", altered)


def _altered_top(monkeypatch):
    from repro_torch.serve import ranking_service as rs

    real = rs.RankingService._rank_shard

    def altered(self, *args, **kwargs):
        top, scores, stats, counts = real(self, *args, **kwargs)
        return top.roll(1, dims=1), scores, stats, counts

    monkeypatch.setattr(rs.RankingService, "_rank_shard", altered)


def _tail_left_out(monkeypatch):
    from repro_torch.core import cascade

    monkeypatch.setattr(
        cascade, "_final_tail",
        lambda pf, S, flat, scores, alive, overflow, *a, **k: (scores, overflow),
    )


def _half_the_batch(monkeypatch):
    from repro_torch.serve import ranking_service as rs

    real = rs.RankingService._rank_shard

    def half(self, X, mask, *args, **kwargs):
        Q = X.shape[0] // 2
        top, scores, stats, counts = real(self, X[:Q], mask[:Q], *args, **kwargs)
        top = torch.cat([top, torch.zeros_like(top)])
        return top, torch.cat([scores, torch.zeros_like(scores)]), stats, counts

    monkeypatch.setattr(rs.RankingService, "_rank_shard", half)


@pytest.mark.parametrize(
    "fault", [_altered_answer, _altered_top, _tail_left_out, _half_the_batch],
    ids=lambda f: f.__name__.strip("_"),
)
@pytest.mark.parametrize("sentinel2", [0, 12])
def test_faults_are_not_correct(fault, sentinel2, monkeypatch):
    fault(monkeypatch)
    result = _run(small_cell(sentinel2=sentinel2))
    assert result["correct"] is False


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_names_files_that_exist():
    m = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["lear_bench"] and 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert NAME.match(c["name"])
        assert c["file"] == f"lear_bench/configs/{c['name']}.json"
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] == c["name"]
    names = [w["name"] for w in m["workloads"]]
    assert names[:1] == ["msn1-bulk"] and len(set(names)) == len(names)
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"], m)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert cell.chips == w["chips"] and cell.workload["limits"]
        assert callable(harness.system_build(cell.config.get("system", "ranking_service")))
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= e["bound"] <= 0.25 for e in e2e.values())
    for metric in (*m["end_to_end"], *m["per_layer"]):
        assert NAME.match(metric["name"])
        assert callable(harness.metric_reader(metric["name"]))
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e


def test_run_refuses_without_a_card(capsys, monkeypatch):
    from lear_bench import run

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    # main() points caches and the import path into the checkout: undo it after.
    monkeypatch.setattr(sys, "path", sys.path[:])
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")
    assert run.main(["--workload", "msn1-bulk", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("flax", "repro.core", "repro_torch_extra", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"flax", "repro.core"} <= set(found)
    assert not {"repro_torch_extra", "jaxtyping"} & set(found)
    assert all(n.split(".")[0] in harness.FORBIDDEN for n in found)


def test_trace_summary_by_hand():
    window = trace.Span(trace.WINDOW, 0.0, 100.0)
    device = [
        trace.Span("void forest_score_kernel<16, false, false>", 10.0, 40.0),
        trace.Span("elementwise_kernel", 35.0, 50.0),      # overlaps: counted once
        trace.Span("Memcpy DtoH (Device -> Pinned)", 60.0, 70.0),
        trace.Span("elementwise_kernel", 95.0, 120.0),     # clipped at the window
    ]
    host = [
        trace.Span("rank_batch", 0.0, 80.0),
        trace.Span("cudaLaunchKernel", 2.0, 8.0),
        trace.Span("aten::copy_", 52.0, 75.0),
    ]
    s = trace.summarize(device, host, window)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((40 + 10 + 5) * 1e-6)
    assert s.forest_s == pytest.approx(30e-6)
    assert s.kernel_busy_s == pytest.approx((40 + 5) * 1e-6)   # [10, 50) and [95, 100)
    assert s.glue_s == pytest.approx(40e-6)
    assert len(s.kernels) == 3
    gaps = dict(s.idle_gaps)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)    # [0, 10)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)         # [50, 60)
    assert gaps["host (no span)"] == pytest.approx(25e-6)      # [70, 95)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_sampler_keeps_a_seeded_uniform_sample():
    a, b = harness.Sampler(5, 3), harness.Sampler(5, 3)
    for i in range(100):
        a.offer((i, None, None))
        b.offer((i, None, None))
    assert [x[0] for x in a.kept] == [x[0] for x in b.kept]
    assert len(a.kept) == 3 and a.seen == 100


def test_open_loop_counts_the_wait_from_arrival():
    cell = small_cell()
    cell.traffic.update(loop="open", rate=200.0)
    result = _run(cell)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0


def test_host_inputs_are_served_and_checked():
    cell = small_cell(sentinel2=12)
    cell.traffic["inputs"] = "host"
    result = _run(cell, trace_on=True)
    assert result["correct"] is True
    assert result["metrics"]["service.capacity_waste"]["value"] > 1


def test_stats_delta_subtracts_numbers_and_counts():
    before = {"batches": 2, "capacities": {(8,): 2}, "name": "x"}
    after = {"batches": 5, "capacities": {(8,): 3, (16,): 2}, "name": "x"}
    assert harness.stats_delta(after, before) == {
        "batches": 3, "capacities": {(8,): 1, (16,): 2}, "name": "x",
    }
    assert harness.stats_delta(after, None) is None


def test_capacity_waste_reads_the_traced_counters():
    read = harness.metric_reader("service.capacity_waste")
    ctx = {"stats_traced": {"docs_continued": 50, "capacities": {(64, 100): 2, (64, 50): 1}}}
    assert read(ctx) == pytest.approx((2 * 100 + 50) / 50)
    assert read({"stats_traced": None}) is None


class _Counting:
    """A stand-in service that answers at once and counts its calls."""

    def __init__(self, fail_at=None):
        self.calls, self.fail_at = 0, fail_at
        self.lock = threading.Lock()

    def rank_batch(self, X, mask):
        with self.lock:
            self.calls += 1
            if self.calls == self.fail_at:
                raise RuntimeError("planted")
        return None, None


def _pool(n=3):
    from lear_bench.generator import Pool

    return Pool([(None, None)] * n, [10 * (i + 1) for i in range(n)])


def test_closed_loop_counts_every_request_once_under_many_clients():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        svc, pool = _Counting(), _pool()
        rec, nxt = harness.closed_loop(
            svc, pool, harness.Sampler(1, 2), 5, 16, None, lambda started, t0: started < 600,
        )
    finally:
        sys.setswitchinterval(old)
    assert nxt == 605 and svc.calls == 600 and len(rec.latencies_s) == 600
    assert sum(rec.served.values()) == 600 and rec.docs == 200 * (10 + 20 + 30)


def test_closed_loop_raises_a_client_error():
    with pytest.raises(RuntimeError, match="planted"):
        harness.closed_loop(
            _Counting(fail_at=7), _pool(), harness.Sampler(1, 2), 0, 4, None,
            lambda started, t0: started < 100,
        )
