"""The sentinel-features kernel's host side on the CPU: the fused rank plan
and its pairs, the wrapper's refusals, and the CPU path staying plain.

The kernel itself runs on the card only: ``tests/test_torch_sentinel_cuda.py``
holds it bit for bit against :func:`augment_features_plain` there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import features  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import forest_score as fs  # noqa: E402
from repro_torch.kernels import sentinel_features as sf  # noqa: E402


def _inputs(Q=3, D=20, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(Q, D, F)).astype(np.float32))
    partial = torch.as_tensor(np.round(rng.normal(size=(Q, D)) * 4).astype(np.float32) / 4)
    mask = torch.as_tensor(np.arange(D)[None, :] < rng.integers(0, D + 1, size=(Q, 1)))
    return X, partial, mask


@pytest.mark.parametrize("D", [1, 31, 64, 128, 255, 256, 257, 300, 512, 1000])
def test_the_card_plans_the_fused_compare(D):
    """On a CUDA device "auto" is the kernel's compare, D² pairs in one
    launch; off the card the plan is what it was, and a method asked for by
    name is the plain path's on any device."""
    for dev in ("cuda", "cuda:1", torch.device("cuda", 0)):
        assert features.rank_plan(D, device=dev) == ("fused", D * D, 1)
    plain = features.rank_plan(D)
    assert plain[0] == ("blocked" if D > features.RANK_BLOCKED_MIN_D else "direct")
    for dev in ("cpu", torch.device("cpu"), "meta"):
        assert features.rank_plan(D, device=dev) == plain
    assert features.rank_plan(D, "direct", device="cuda") == ("direct", D * D, 1)


@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
def test_fused_pairs_equal_the_plain_pairs_at_tile_multiples(D):
    """The service's rank_pairs reads the same on the card and off it where
    D is a multiple of the blocked compare's tile: 256 and 512 slots, the
    benchmark's lists, keep their pairs a document."""
    assert features.rank_plan(D, device="cuda")[1] == features.rank_plan(D)[1] == D * D


def test_fused_pairs_leave_out_the_blocked_padding():
    D = 300
    assert features.rank_plan(D)[1] == 384**2
    assert features.rank_plan(D, device="cuda")[1] == D * D


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_query_ranks_refuses_the_fused_method(device):
    """"fused" names no plain compare: asked for by name it is refused,
    whatever the device."""
    _, partial, mask = _inputs()
    with pytest.raises(ValueError, match="fused"):
        features.query_ranks(partial, mask, method="fused")
    with pytest.raises(ValueError, match="fused"):
        features.rank_plan(20, "fused", device=device)


def test_the_plain_cutoff_is_the_reference_constant():
    """The blocked cutoff is a constant of the plain path, 256 as in the
    reference's default."""
    assert features.RANK_BLOCKED_MIN_D == 256
    assert features.rank_plan(256) == ("direct", 256**2, 1)
    assert features.rank_plan(257) == ("blocked", 384**2, 9)


def _no_library():
    raise AssertionError("the CPU path loaded the sentinel-features library")


@pytest.mark.parametrize("case", [
    "X_float64", "partial_float64", "mask_uint8", "X_2d", "partial_shape", "mask_shape",
    "cpu", "meta",
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    monkeypatch.setattr(sf, "library", _no_library)
    X, partial, mask = _inputs()
    if case == "X_float64":
        X, match = X.double(), "X must be torch.float32"
    elif case == "partial_float64":
        partial, match = partial.double(), "partial must be torch.float32"
    elif case == "mask_uint8":
        mask, match = mask.to(torch.uint8), "mask must be torch.bool"
    elif case == "X_2d":
        X, match = X[0], r"X must be \[Q, D, F\]"
    elif case == "partial_shape":
        partial, match = partial[:, :-1], r"partial must be torch.float32 \(3, 20\)"
    elif case == "mask_shape":
        mask, match = mask[:-1], r"mask must be torch.bool \(3, 20\)"
    elif case == "cpu":
        match = "X on cpu; every operand must be on one CUDA device"
    else:
        X, partial, mask = (t.to("meta") for t in (X, partial, mask))
        match = "X on meta"
    with pytest.raises(ValueError, match=match):
        sf.sentinel_features_kernel(X, partial, mask)


def _plain_by_hand(X, partial, mask):
    """The four features from their definitions, element by element."""
    Q, D, F = X.shape
    out = torch.zeros(Q, D, F + 4)
    out[..., :F] = X
    for q in range(Q):
        real = mask[q]
        if not real.any():
            continue
        lo, hi = partial[q][real].min(), partial[q][real].max()
        s = torch.where(real, partial[q], torch.tensor(features.NEG))
        for i in range(D):
            if not real[i]:
                continue
            rank = sum(int(s[j] > s[i] or (s[j] == s[i] and j < i)) for j in range(D))
            norm = torch.clamp((partial[q, i] - lo) / torch.clamp_min(hi - lo, 1e-9), 0, 1)
            out[q, i, F:] = torch.stack([
                partial[q, i], torch.tensor(float(rank)), norm, real.sum().float(),
            ])
    return out


@pytest.mark.parametrize("D,F", [(1, 0), (7, 3), (20, 5), (33, 0)])
def test_the_cpu_path_stays_plain(D, F, monkeypatch):
    """On the CPU augment_features is the plain version: no launch, no
    library, and the features their definitions give, ties, an all-masked
    query and a real document at NEG included."""
    monkeypatch.setattr(sf, "library", _no_library)
    monkeypatch.setattr(features, "sentinel_features_kernel", _no_library)
    X, partial, mask = _inputs(Q=4, D=D, F=F, seed=D)
    mask[0] = False                      # an all-masked query
    mask[1, 0] = True
    partial[1, 0] = features.NEG         # a real document at exactly NEG
    before = build.kernel_launches()
    got = features.augment_features(X, partial, mask)
    assert build.kernel_launches() == before
    assert torch.equal(got, features.augment_features_plain(X, partial, mask))
    assert torch.equal(got, _plain_by_hand(X, partial, mask))
    assert torch.equal(got[0], torch.cat([X[0], torch.zeros(D, 4)], dim=-1))


def test_the_meta_path_shapes_through_the_plain_version():
    X, partial, mask = (t.to("meta") for t in _inputs(Q=2, D=9, F=6))
    out = features.augment_features(X, partial, mask)
    assert out.device.type == "meta" and out.shape == (2, 9, 10)


def test_launch_counter_resets(monkeypatch):
    """One registry counts every kernel library's launches."""
    monkeypatch.setitem(build.KERNEL_LAUNCHES, "sentinel_features", 3)
    monkeypatch.setitem(build.KERNEL_LAUNCHES, "forest_score", 2)
    assert build.kernel_launches() == {
        "forest_score": 2, "forest_score_segments": 0, "sentinel_features": 3,
    }
    assert sf.KERNEL_LAUNCHES is fs.KERNEL_LAUNCHES is build.KERNEL_LAUNCHES
    build.reset_kernel_launches()
    assert build.kernel_launches() == {
        "forest_score": 0, "forest_score_segments": 0, "sentinel_features": 0,
    }
