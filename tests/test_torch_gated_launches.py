"""Every forest range launch on a compacted block is gated on its count.

The engine passes each launch whose rows are a compacted block (the tail,
a staged middle segment, the hybrid's plain head on the dense gate's
block) the count its compaction returned, as ``n_valid``; the head on all
rows and the classifiers get none. The kernel writes 0 for the padding
rows at or past the count and does no tree work for a tile wholly past
it, so those rows must never reach a result:

- a spy on the kernel wrapper sees each compacted launch receive its
  compaction's count (fused, staged, an overflowing capacity, two shards
  with ``survivors_before``, the hybrid's head), and every other launch
  none;
- a plain version patched to write NaN past the count leaves scores,
  partials, masks and overflow bit-equal to the reference's, and the
  dispatch counts equal the reference's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as ref_cascade  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.core import stage as ref_stage  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import cascade, features, lear, stage, strategies  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import to_port  # noqa: E402

Q, D, F, T = 4, 32, 12, 40


def _classifiers(sentinels):
    return [
        ref_ensemble.random_ensemble(100 + i, n_trees=10, depth=3, n_features=F + 4)
        for i in range(len(sentinels))
    ]


def _lear(pkg_features, clf, partial, mask, features=None):
    aug = pkg_features.augment_features(features, partial, mask)
    return clf.continue_mask(aug, mask, 0.5, use_kernel=True)


def _strategies(sentinels):
    """LEAR classifiers through the kernel, the same in both packages."""
    clfs = _classifiers(sentinels)
    return (
        [functools.partial(_lear, ref_features, ref_lear.LearClassifier(c, s))
         for c, s in zip(clfs, sentinels, strict=True)],
        [functools.partial(_lear, features, lear.LearClassifier(to_port(c), s))
         for c, s in zip(clfs, sentinels, strict=True)],
    )


def _feature0_above(cut):
    def strategy(partial, mask, features=None):
        return mask & (features[..., 0] > cut)
    return strategy


def _dense_stages(capacity=None):
    """An exact scorer (feature 0) and the same keep policy in both packages."""
    return (
        ref_stage.DenseStage(
            scorer=lambda x: x[:, 0], capacity=capacity,
            policy=functools.partial(ref_strategies.dense_keep_fraction, keep_frac=0.6),
        ),
        stage.DenseStage(
            scorer=lambda x: x[:, 0], capacity=capacity,
            policy=functools.partial(strategies.dense_keep_fraction, keep_frac=0.6),
        ),
    )


def _inputs(seed, q=Q):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(q, D, F)).astype(np.float32)
    mask = np.arange(D)[None, :] < rng.integers(D // 2, D + 1, size=(q, 1))
    return X, mask


def _configs(pkg, sentinels, strats, mode, capacities, dense):
    if dense is None:
        return pkg.EngineConfig.trees(sentinels, strats, capacities=capacities, mode=mode)
    return pkg.EngineConfig.hybrid(dense, sentinels, strats, capacities=capacities, mode=mode)


# Each case: sentinels, mode, capacities, hybrid.
CASES = {
    "fused_s1": ((10,), "fused", None, False),
    "fused_s2": ((8, 28), "fused", None, False),
    "staged_s3": ((5, 19, 33), "staged", None, False),
    "staged_overflow": ((8, 28), "staged", 8, False),
    "fused_overflow": ((10,), "fused", 8, False),
    "hybrid_staged": ((10, 20, 35), "staged", None, True),
    "hybrid_fused_s1": ((10,), "fused", None, True),
    "hybrid_fused_s3": ((10, 20, 35), "fused", None, True),
    "hybrid_overflow": ((10, 20), "staged", 8, True),
}


class _Spy:
    """Each launch of the range kernel wrapper as ``(rows, n_valid)``
    (``None`` ungated), and each compaction as ``(stage, capacity, count,
    launched, survivors)``: the count the take returned, checked against
    the survivors it was given, and whether a range launch scores its
    block."""

    def __init__(self, monkeypatch, segmented_head=False):
        self.launches, self.takes = [], []
        kernel, take = ops.forest_score_kernel, cascade._Slots.take

        def spy_kernel(x, *args, n_valid=None, **kw):
            self.launches.append((x.shape[0], None if n_valid is None else int(n_valid)))
            if n_valid is not None:
                assert n_valid.dtype == torch.int32 and n_valid.numel() == 1
            return kernel(x, *args, n_valid=n_valid, **kw)

        def spy_take(slots, cont, cap, limit, stage):
            i = len(slots.counts)
            out = take(slots, cont, cap, limit, stage=stage)
            want = survivors = int(cont.sum())
            if slots.before is not None:   # a shard: the slots its earlier shards left
                want = min(survivors, max(limit - int(slots.before[i]), 0))
            assert int(out[1]) == want
            # The dense gate's block goes to the segmented head in a fused
            # multi-sentinel hybrid: no range launch, so no gate.
            launched = not (segmented_head and stage == 0)
            self.takes.append((stage, cap, want, launched, survivors))
            return out

        monkeypatch.setattr(ops, "forest_score_kernel", spy_kernel)
        monkeypatch.setattr(cascade._Slots, "take", spy_take)

    def gated(self):
        return [(rows, n) for rows, n in self.launches if n is not None]

    def compacted(self):
        return [(cap, n) for _, cap, n, launched, _ in self.takes if launched]


@pytest.mark.parametrize("case", list(CASES))
def test_every_compacted_launch_gets_its_compactions_count(monkeypatch, case):
    sentinels, mode, capacities, hybrid = CASES[case]
    spy = _Spy(monkeypatch, segmented_head=hybrid and mode == "fused" and len(sentinels) > 1)
    _, strats = _strategies(sentinels)
    dense = _dense_stages()[1] if hybrid else None
    X, mask = _inputs(1)
    got = cascade.CascadeRanker(to_port(ref_ensemble.random_ensemble(
        1, n_trees=T, depth=4, n_features=F)), sentinels[0], strats[0]).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        _configs(stage, sentinels, strats, mode, capacities, dense),
        features=torch.as_tensor(X),
    )
    assert spy.gated() == spy.compacted() and spy.gated()
    # The result records each gated launch's stage, as the spy saw them.
    assert got.gated_launches == tuple(st for st, *_, launched, _ in spy.takes if launched)
    # Uncompacted launches (the head on every row, the classifiers) are ungated.
    assert all(rows == Q * D for rows, n in spy.launches if n is None)
    # The tail's count is the last stage's survivors, before its capacity.
    assert spy.gated()[-1][1] == int(got.continue_mask.sum())
    if capacities is not None:   # the small capacity overflows: count > rows
        assert any(n > rows for rows, n in spy.gated())
    else:
        assert all(n < rows for rows, n in spy.gated())


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_two_shards_gate_on_their_share(monkeypatch, mode):
    """Two shards of one batch, the second given the first's counts: each
    shard's launches read the slots left to it, so the second's tail
    count stops where the whole batch's capacity does."""
    sentinels, cap = (8, 28), 96
    strats = [_feature0_above(-0.5)] * 2     # ~69% of the real documents stay
    ranker = cascade.CascadeRanker(to_port(ref_ensemble.random_ensemble(
        2, n_trees=T, depth=4, n_features=F)), sentinels[0], strats[0])
    config = stage.EngineConfig.trees(sentinels, strats, capacities=cap, mode=mode)
    X, mask = _inputs(2, q=2 * Q)
    spy = _Spy(monkeypatch)
    before = None
    for half in (slice(0, Q), slice(Q, 2 * Q)):
        x = torch.as_tensor(X[half])
        before = ranker.rank_progressive(
            x, torch.as_tensor(mask[half]), config, features=x, survivors_before=before,
        ).survivors
    assert spy.gated() == spy.compacted()
    per_shard = 1 if mode == "fused" else 2
    assert len(spy.gated()) == 2 * per_shard
    # The batch's first compaction overflows across the shards: the second
    # shard's launch reads what the first left, fewer than its survivors.
    first, second = spy.takes[0], spy.takes[per_shard]
    assert first[2] == first[4] < cap == first[2] + second[2] < first[4] + second[4]


def _nan_past_count(monkeypatch):
    """The plain version writes NaN, not 0, at and past ``n_valid``."""
    plain = fs.forest_score_plain

    def nan_plain(x, *args, n_valid=None, **kw):
        out = plain(x, *args, **kw)
        if n_valid is None:
            return out
        rows = torch.arange(out.shape[0])
        return torch.where(rows < n_valid.reshape(()), out, torch.full_like(out, torch.nan))

    monkeypatch.setattr(fs, "forest_score_plain", nan_plain)


@pytest.mark.parametrize("case", list(CASES))
def test_padding_rows_never_reach_the_result(monkeypatch, case):
    sentinels, mode, capacities, hybrid = CASES[case]
    ref_ens = ref_ensemble.random_ensemble(3, n_trees=T, depth=4, n_features=F)
    ref_strats, port_strats = _strategies(sentinels)
    ref_dense, port_dense = _dense_stages() if hybrid else (None, None)
    X, mask = _inputs(3)
    ref_ops.reset_launch_counts()
    want = ref_cascade.CascadeRanker(ref_ens, sentinels[0], ref_strats[0]).rank_progressive(
        jnp.asarray(X), jnp.asarray(mask),
        _configs(ref_stage, sentinels, ref_strats, mode, capacities, ref_dense),
        features=jnp.asarray(X),
    )
    ref_counts = ref_ops.launch_counts()
    _nan_past_count(monkeypatch)
    ops.reset_launch_counts()
    got = cascade.CascadeRanker(to_port(ref_ens), sentinels[0], port_strats[0]).rank_progressive(
        torch.as_tensor(X), torch.as_tensor(mask),
        _configs(stage, sentinels, port_strats, mode, capacities, port_dense),
        features=torch.as_tensor(X),
    )
    assert ops.launch_counts() == ref_counts
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.continue_mask.numpy(), np.asarray(want.continue_mask))
    for g, w in zip(got.stage_masks, want.stage_masks, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.partials.numpy(), np.asarray(want.partials))
    assert int(got.overflow) == int(want.overflow)
    assert not np.isnan(got.scores.numpy()).any()
