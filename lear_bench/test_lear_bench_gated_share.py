"""``engine.gated_share``: the gated rows of the compacted forest launches
over their rows, from the traced segment's counters, where a forest kernel
ran on the device."""

from lear_bench import harness, trace


def _trace(forest_s):
    kernels = [("void forest_score_kernel<16, false, true>", forest_s), ("gather", 0.002)]
    return trace.Summary(window_s=1.0, busy_s=0.5, kernels=kernels, device_ops=[],
                         idle_gaps=[])


def test_gated_share_reads_the_traced_counters():
    read = harness.metric_reader("engine.gated_share")
    stats = {"rows_compacted": 1_048_576, "rows_gated": 836_000, "docs_continued": 64_100}
    assert read({"stats_traced": stats, "trace": _trace(0.01)}) == 100.0 * 836_000 / 1_048_576


def test_gated_share_is_none_without_the_counters_or_a_device_forest_kernel():
    read = harness.metric_reader("engine.gated_share")
    stats = {"rows_compacted": 524_288, "rows_gated": 376_588}
    parent = {"docs_continued": 147_700, "capacities": {(524_288,): 16}}
    assert read({"stats_traced": parent, "trace": _trace(0.01)}) is None
    assert read({"stats_traced": None, "trace": _trace(0.01)}) is None
    assert read({"stats_traced": {"rows_compacted": 0, "rows_gated": 0},
                 "trace": _trace(0.01)}) is None
    assert read({"stats_traced": stats, "trace": None}) is None      # the CPU
    assert read({"stats_traced": stats, "trace": _trace(0.0)}) is None
