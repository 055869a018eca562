"""``lear-istella``'s shapes on the CPU: the program, built as the cell
builds it (``systems/ranking_service``), against :mod:`lear_bench.reference`
at 220 features and 512 slots, on the blocked rank compare and (at 256
slots) the direct one, with one sentinel and with two; a planted fault
reads incorrect; the reader of ``engine.rank_pairs_per_doc``; and, with
``-m cuda``, the same service on the card with its spans' launch plans."""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

from lear_bench import check, generator, harness, reference, weights  # noqa: E402

F = 220                 # Istella's features; the classifier reads F + 4 = 224
SEED = 2**31 + 2029     # larger than 32 signed bits hold
THRESHOLD = 0.5
CELL = json.loads((harness.BENCH / "workloads" / "istella-bulk.json").read_text())
CONFIG = json.loads((harness.BENCH / "configs" / "lear-istella.json").read_text())


def _traffic(slots):
    return {
        "loop": "closed", "clients": 1, "queries": 6, "slots": slots,
        "candidates": {"draw": "poisson", "mean": 317, "min": 8, "max": 512},
        "features": {"draw": "normal"}, "pool": 1,
    }


def _serve(slots, sentinels, fault=None, device="cpu"):
    """One request of 6 queries x ``slots`` through the cell's system, and
    the reference's answer for it: (scores, top, mask, reference result,
    the service)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED % (1 << 64))
    ranker = weights.draw_ranker(gen, 40, 6, F, dev)
    clfs = [weights.draw_classifier(26 + k, 4, 5, F + 4, dev) for k in range(len(sentinels))]
    X, mask = generator.make_pool(_traffic(slots), F, SEED, gen, dev).batches[0]
    cfg = copy.deepcopy(CONFIG)
    cfg["service"]["launch_overhead_trees"] = 64.0    # no timing probe
    svc = harness.system_build("ranking_service")(ranker, clfs, sentinels, cfg, THRESHOLD, dev)
    top, scores = svc.rank_batch(X, mask)
    if fault is not None:
        scores = fault(scores.copy())
    ref = reference.reference(X, mask, ranker, clfs, sentinels, THRESHOLD, cfg["top_k"],
                              eps=CELL["limits"]["score_gap"])
    return scores, top, mask, ref, svc


@pytest.mark.parametrize("sentinels", [(8,), (8, 20)], ids=["one", "two"])
@pytest.mark.parametrize("slots", [512, 256], ids=["blocked", "direct"])
def test_program_agrees_with_the_reference_at_istella_width(slots, sentinels):
    scores, top, mask, ref, svc = _serve(slots, sentinels)
    assert 0 < ref.survivors[0] < ref.real                   # some exit, some go on
    gaps = check.score_gaps(scores, top, mask, ref)
    assert check.judge(dict(zip(("score_gap", "topk_gap"), gaps)), CELL["limits"]), gaps
    # The counter: each stage ranks the whole grid, padded to the tile.
    D_pad = 512 if slots == 512 else 256
    assert svc.stats.rank_pairs == len(sentinels) * 6 * D_pad**2


@pytest.mark.cuda
@pytest.mark.parametrize("sentinels", [(8,), (8, 20)], ids=["one", "two"])
def test_on_the_card_at_istella_width(sentinels):
    """The same on the card, recording: the blocked compare's span, and each
    forest launch's plan on its span with a document tile below 256 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import tracing

    with tracing.recording():
        scores, top, mask, ref, svc = _serve(512, sentinels, device="cuda")
    gaps = check.score_gaps(scores, top, mask, ref)
    assert check.judge(dict(zip(("score_gap", "topk_gap"), gaps)), CELL["limits"]), gaps
    records = tracing.drain().records
    ranks = [r.attrs for r in records if r.name == "engine.ranks"]
    assert ranks == [{"method": "blocked", "D": 512, "tiles": 16}] * len(sentinels)
    launches = [r for r in records if r.name in (
        "engine.head", "engine.middle", "engine.tail", "engine.classifier")]
    assert {r.name for r in launches} >= {"engine.head", "engine.tail", "engine.classifier"}
    for r in launches:
        assert 0 < r.attrs["tile_rows"] < 256, (r.name, r.attrs)
        assert r.attrs["tree_warps"] >= 1 and r.attrs["ctas_per_sm"] >= 1, (r.name, r.attrs)


def _altered(scores):
    scores[0, 0] += 0.1              # slot 0 of a query is always real
    return scores


def test_an_altered_answer_is_not_correct_at_istella_width():
    scores, top, mask, ref, _ = _serve(512, (8,), fault=_altered)
    gaps = check.score_gaps(scores, top, mask, ref)
    assert gaps[0] > CELL["limits"]["score_gap"]
    assert not check.judge(dict(zip(("score_gap", "topk_gap"), gaps)), CELL["limits"])


def _trace(kernels):
    from lear_bench import trace

    return trace.Summary(window_s=1.0, busy_s=0.5, kernels=kernels, device_ops=[],
                         idle_gaps=[])


def test_rank_pairs_per_doc_reads_the_traced_counters():
    read = harness.metric_reader("engine.rank_pairs_per_doc")
    on_card = _trace([("void forest_score_kernel<16, false, true>", 0.01)])
    # istella-bulk's request: 4,096 queries x 512 slots, one stage, ~317 real a query.
    stats = {"rank_pairs": 4096 * 512**2, "docs": 4096 * 317}
    assert read({"stats_traced": stats, "trace": on_card}) == pytest.approx(512**2 / 317)
    assert read({"stats_traced": {"docs": 100, "batches": 1}, "trace": on_card}) is None  # parent
    assert read({"stats_traced": None, "trace": on_card}) is None
    assert read({"stats_traced": {"rank_pairs": 0, "docs": 0}, "trace": on_card}) is None
    assert read({"stats_traced": stats, "trace": None}) is None          # the CPU
    assert read({"stats_traced": stats, "trace": _trace([])}) is None


def test_the_new_cell_and_config_are_in_the_manifest():
    m = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("istella-bulk", m)
    assert (cell.workload["config"], cell.workload["traffic"], cell.chips) == (
        "lear-istella", "istella-bulk", 1)
    assert cell.workload["limits"] == {"score_gap": 0.01, "topk_gap": 0.02}
    assert [p["name"] for p in cell.per_layer] == ["engine.rank_pairs_per_doc"]
    cfg = cell.config
    assert (cfg["n_trees"], cfg["depth"], cfg["n_features"], cfg["max_docs"]) == (1469, 6, 220, 512)
    assert cell.traffic["slots"] == cfg["max_docs"]
