"""The span recorder (``repro_torch.tracing``) and the spans of the ranking
path: off records nothing; nesting, parents and request ids; one stack a
thread; a bounded buffer; the span tree of ``RankingService.rank_batch``
with its attributes; and recording changes no output, launch or read."""

import contextlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.forest.ensemble import random_ensemble  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.utils import count_host_transfers  # noqa: E402

F, T = 12, 48


def _service(sentinels, mode):
    clfs = [
        LearClassifier(random_ensemble(10 + i, 6, 3, F + 4, device="cpu"), s)
        for i, s in enumerate(sentinels)
    ]
    return RankingService(
        random_ensemble(0, T, 4, F, device="cpu"), clfs[0],
        ServiceConfig(threshold=0.5, execution_mode=mode, launch_overhead_trees=0.0),
        extra_classifiers=clfs[1:], device="cpu",
    )


def _batch(Q=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(4, D + 1, size=(Q, 1))
    return X, mask


def test_off_records_nothing():
    assert tracing.span("a", x=1) is tracing.span("b")   # the one shared no-op
    with tracing.span("a") as sp:
        sp.set(rows=3)
    with tracing.recording():
        pass
    _service((8,), "fused").rank_batch(*_batch())   # off again: nothing reaches the buffer
    trace = tracing.drain()
    assert trace.records == [] and trace.dropped == 0 and len(trace.anchors) == 2


def test_nesting_parents_and_requests():
    with tracing.recording():
        with tracing.span("root", Q=2) as root:
            with tracing.span("child"):
                with tracing.span("leaf", stage=1):
                    pass
            with tracing.span("sibling") as sib:
                sib.set(mode="fused")
            root.set(D=8)
        with tracing.span("second"):
            pass
    trace = tracing.drain()
    names = [r.name for r in trace.records]
    assert names == ["root", "child", "leaf", "sibling", "second"]   # in opening order
    by = {r.name: r for r in trace.records}
    assert [by[n].parent for n in names] == [-1, 0, 1, 0, -1]
    assert {by[n].request for n in names[:4]} == {by["root"].request}
    assert by["second"].request != by["root"].request
    assert by["root"].attrs == {"Q": 2, "D": 8}
    assert by["sibling"].attrs == {"mode": "fused"} and by["leaf"].attrs == {"stage": 1}
    for r in trace.records:
        assert r.start_ns <= r.end_ns and r.thread == threading.get_native_id()
        if r.parent >= 0:
            p = trace.records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    a0, a1 = trace.anchors
    assert a0[0] <= by["root"].start_ns and by["second"].end_ns <= a1[0]
    assert tracing.drain().records == []          # a drain empties the buffer


def test_two_threads_keep_separate_stacks():
    both_open = threading.Barrier(2, timeout=10)

    def client(tag):
        with tracing.span(f"root{tag}"):
            both_open.wait()          # both roots open at once
            with tracing.span(f"child{tag}"):
                both_open.wait()

    with tracing.recording():
        threads = [threading.Thread(target=client, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    trace = tracing.drain()
    by = {r.name: r for r in trace.records}
    assert set(by) == {"roota", "rootb", "childa", "childb"}
    for tag in "ab":
        root, child = by[f"root{tag}"], by[f"child{tag}"]
        assert root.parent == -1 and trace.records[child.parent] is root
        assert child.request == root.request and child.thread == root.thread
    assert by["roota"].request != by["rootb"].request
    assert by["roota"].thread != by["rootb"].thread


def test_a_full_buffer_drops_and_counts():
    with tracing.recording(capacity=3):
        with tracing.span("root"):
            for i in range(4):
                with tracing.span("child", i=i):
                    pass
        first = tracing.drain()
        with tracing.span("after"):
            pass
    assert [r.attrs.get("i") for r in first.records] == [None, 0, 1]
    assert first.dropped == 2
    second = tracing.drain()
    assert [r.name for r in second.records] == ["after"] and second.dropped == 0
    with pytest.raises(ValueError):
        with tracing.recording(capacity=0):
            pass


def _tree(trace, i=0):
    """(name, attrs, children) of the i-th root."""
    kids: dict[int, list[int]] = {}
    for j, r in enumerate(trace.records):
        kids.setdefault(r.parent, []).append(j)

    def node(j):
        r = trace.records[j]
        return (r.name, r.attrs, [node(c) for c in kids.get(j, [])])

    return node(kids[-1][i])


def _shape(node):
    name, attrs, children = node
    return (name, [_shape(c) for c in children])


def _find(node, name):
    found = [node] if node[0] == name else []
    for c in node[2]:
        found += _find(c, name)
    return found


ENGINE = {
    # One sentinel, fused: head, stage 0's features and classifier, the tail
    # with its compaction.
    ((8,), "fused"): [
        ("engine.head", []), ("engine.features", []), ("engine.classifier", []),
        ("engine.tail", [("engine.compact", [])]),
    ],
    ((8, 28), "fused"): [
        ("engine.head", []), ("engine.features", []), ("engine.classifier", []),
        ("engine.features", []), ("engine.classifier", []),
        ("engine.tail", [("engine.compact", [])]),
    ],
    # Two sentinels, staged: the first stage's survivors compacted, the
    # middle segment on them, then the second stage and the tail.
    ((8, 28), "staged"): [
        ("engine.head", []), ("engine.features", []), ("engine.classifier", []),
        ("engine.compact", []), ("engine.middle", []),
        ("engine.features", []), ("engine.classifier", []),
        ("engine.tail", [("engine.compact", [])]),
    ],
}


@pytest.mark.parametrize("sentinels,mode", list(ENGINE), ids=lambda v: str(v))
def test_rank_batch_span_tree(sentinels, mode):
    svc = _service(sentinels, mode)
    X, mask = _batch()
    Q, D = mask.shape
    with tracing.recording():
        svc.rank_batch(X, mask)
    trace = tracing.drain()
    assert trace.dropped == 0 and len({r.request for r in trace.records}) == 1
    root = _tree(trace)
    assert _shape(root) == ("service.rank_batch", [
        ("service.put", []), ("service.pick", []),
        ("engine.rank_progressive", ENGINE[sentinels, mode]),
        ("service.topk", []), ("service.read", []), ("service.unpack", []),
    ])
    (caps,) = svc.stats.capacities
    assert root[1] == {"Q": Q, "D": D}
    assert _find(root, "service.pick")[0][1] == {"capacities": caps, "mode": mode}
    assert _find(root, "engine.rank_progressive")[0][1] == {
        "mode": mode, "stages": len(sentinels),
    }
    S, k = len(sentinels), svc.top_k
    assert _find(root, "service.read")[0][1] == {
        "bytes": 8 * (S + 4) + 8 * Q * k + 4 * Q * D, "pinned": False,
    }
    head = sentinels[-1] if mode == "fused" else sentinels[0]
    assert _find(root, "engine.head")[0][1] == {"rows": Q * D, "trees": head}
    assert [n[1] for n in _find(root, "engine.features")] == [
        {"stage": s} for s in range(S)
    ]
    assert [n[1] for n in _find(root, "engine.classifier")] == [
        {"stage": s} for s in range(S)
    ]
    # The rows launched are the picked capacities: each compaction's, the
    # middle's (on stage 0's survivors) and the tail's.
    compact = [n[1] for n in _find(root, "engine.compact")]
    assert compact == [{"stage": s, "rows": caps[s]} for s in range(S - len(compact), S)]
    assert _find(root, "engine.tail")[0][1] == {"rows": caps[-1], "trees": T - sentinels[-1]}
    if mode == "staged":
        assert _find(root, "engine.middle")[0][1] == {
            "stage": 1, "rows": caps[0], "trees": sentinels[1] - sentinels[0],
        }


@pytest.mark.parametrize("sentinels,mode", [((8,), "fused"), ((8, 28), "staged")])
def test_recording_changes_no_output_launch_or_read(sentinels, mode):
    batches = [_batch(seed=s) for s in range(3)]
    runs = []
    for on in (False, True):
        svc = _service(sentinels, mode)
        ops.reset_launch_counts()
        recording = tracing.recording() if on else contextlib.nullcontext()
        with recording, count_host_transfers() as counts:
            outs = [svc.rank_batch(X, mask) for X, mask in batches]
        runs.append((outs, dict(ops.launch_counts()), counts, svc.stats))
        assert counts.explicit_gets == len(batches) and counts.implicit_syncs == 0
    (off, launches_off, _, stats_off), (on, launches_on, _, stats_on) = runs
    for (top0, s0), (top1, s1) in zip(off, on):
        np.testing.assert_array_equal(top0, top1)
        assert s0.tobytes() == s1.tobytes()            # bit for bit
    assert launches_on == launches_off and stats_on == stats_off
    assert len({r.request for r in tracing.drain().records}) == len(batches)



def test_active_is_the_innermost_open_span_while_recording():
    assert tracing.active() is None                     # off
    with tracing.recording():
        assert tracing.active() is None                 # no span open
        with tracing.span("outer"):
            with tracing.span("inner") as inner:
                assert tracing.active() is inner
                tracing.active().set(tile_rows=64)
            assert tracing.active().name == "outer"
    by = {r.name: r for r in tracing.drain().records}
    assert by["inner"].attrs == {"tile_rows": 64} and by["outer"].attrs == {}


@pytest.mark.parametrize("D,D_pad,tiles", [(32, 32, 0), (300, 384, 9), (512, 512, 16)],
                         ids=["direct", "blocked-padded", "blocked"])
@pytest.mark.parametrize("sentinels,mode", [((8,), "fused"), ((8, 28), "staged")])
def test_rank_compare_span_and_pair_counter(sentinels, mode, D, D_pad, tiles):
    """Each stage's rank compare: ``engine.ranks`` inside ``engine.features``
    where it is blocked (tile pairs, D), none where it is direct; the pairs
    counted are stages x Q x D_pad² either way; the answers are the same
    bit for bit with recording on and off."""
    Q, S = 3, len(sentinels)
    X, mask = _batch(Q=Q, D=D, seed=D)
    outs, counts = [], []
    for on in (False, True):
        svc = _service(sentinels, mode)
        with tracing.recording() if on else contextlib.nullcontext():
            outs.append(svc.rank_batch(X, mask))
        counts.append(svc.stats.rank_pairs)
    (top0, s0), (top1, s1) = outs
    np.testing.assert_array_equal(top0, top1)
    assert s0.tobytes() == s1.tobytes()
    assert counts == [S * Q * D_pad**2] * 2
    trace = tracing.drain()
    ranks = [r for r in trace.records if r.name == "engine.ranks"]
    assert [trace.records[r.parent].name for r in ranks] == ["engine.features"] * (S if tiles else 0)
    assert [r.attrs for r in ranks] == [{"method": "blocked", "D": D, "tiles": tiles}] * len(ranks)
