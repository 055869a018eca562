"""The port's host-read guard (``repro_torch.utils.count_host_transfers``)
against the reference's (``repro.utils.count_host_transfers``).

The reference's own acceptance case (``tests/test_serve.py``: a warmed
``rank_batch`` with a real LEAR classifier in the loop reads the device
once, explicitly) runs in both packages on the same arrays and must give
the same counts. Then the guard's own behavior on the CPU: each
Python-level read it patches counts once, ``device_get`` is explicit,
reads on other threads count, and the patches are undone on exit. On the
CPU a tensor never syncs, so only these Python-level reads are visible
(the card's sync debug mode is exercised in ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import utils as ref_utils  # noqa: E402
from repro.core import lear as ref_lear  # noqa: E402
from repro.forest import ensemble as ref_ensemble  # noqa: E402
from repro.serve import ranking_service as ref_service  # noqa: E402
from repro_torch.core.lear import LearClassifier  # noqa: E402
from repro_torch.serve import BucketPolicy, ServingTier, TierConfig  # noqa: E402
from repro_torch.serve.ranking_service import RankingService, ServiceConfig  # noqa: E402
from repro_torch.utils import TransferCounts, count_host_transfers, device_get  # noqa: E402
from torch_faults import FakeClock, settle  # noqa: E402
from torch_parity import ref_arrays, to_port  # noqa: E402


def _services(mode="auto", query_exit=(None, None)):
    """tests/test_serve.py's guard service, in both packages."""
    ens = ref_ensemble.random_ensemble(60, n_trees=64, depth=4, n_features=12)
    clfs = [
        ref_lear.LearClassifier(
            forest=ref_ensemble.random_ensemble(160 + i, n_trees=10, depth=3, n_features=16),
            sentinel=s,
        )
        for i, s in enumerate((8, 28))
    ]
    ref = ref_service.RankingService(
        ens, clfs[0],
        ref_service.ServiceConfig(
            threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0,
            query_exit=query_exit[0],
        ),
        extra_classifiers=clfs[1:],
    )
    port_clfs = [LearClassifier.from_numpy(ref_arrays(c.forest), c.sentinel, "cpu") for c in clfs]
    port = RankingService(
        to_port(ens), port_clfs[0],
        ServiceConfig(
            threshold=0.4, execution_mode=mode, launch_overhead_trees=512.0,
            query_exit=query_exit[1],
        ),
        extra_classifiers=port_clfs[1:], device="cpu",
    )
    return ref, port


def test_rank_batch_reads_once_in_both_packages():
    ref, port = _services()
    rng = np.random.default_rng(6)
    X = rng.normal(size=(2, 32, 12)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    for _ in range(2):  # warm: cold start, then the ratcheted capacities
        ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
        port.rank_batch(X, mask)
    with ref_utils.count_host_transfers() as want:
        ref_out = ref.rank_batch(jnp.asarray(X), jnp.asarray(mask))
    with count_host_transfers() as got:
        port_out = port.rank_batch(X, mask)
    assert (got.explicit_gets, got.implicit_syncs) == (want.explicit_gets, want.implicit_syncs)
    assert (got.explicit_gets, got.implicit_syncs) == (1, 0), got
    assert got.sync_warnings == 0 and got.sites == []  # no card here
    np.testing.assert_array_equal(port_out[1], np.asarray(ref_out[1]))


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_every_batch_reads_once_with_query_exit(mode):
    from repro.core import strategies as ref_strategies
    from repro_torch.core.strategies import QueryExitConfig

    _, port = _services(
        mode, (ref_strategies.QueryExitConfig(k=5, margin=1.0), QueryExitConfig(k=5, margin=1.0))
    )
    rng = np.random.default_rng(7)
    batches = [
        (rng.normal(size=(4, 32, 12)).astype(np.float32),
         np.arange(32)[None] < rng.integers(8, 33, size=(4, 1)))
        for _ in range(5)
    ]
    for X, mask in batches[:2]:
        port.rank_batch(X, mask)
    with count_host_transfers() as got:
        for X, mask in batches[2:]:
            port.rank_batch(X, mask)
    assert (got.explicit_gets, got.implicit_syncs) == (3, 0), got


READS = {
    "item": lambda t: t.sum().item(),
    "tolist": lambda t: t.tolist(),
    "__bool__": lambda t: bool(t[0] > 0),
    "__int__": lambda t: int(t[0]),
    "__float__": lambda t: float(t[0]),
    "__index__": lambda t: [0, 1, 2][t[0].long()],
    "numpy": lambda t: t.numpy(),
    "__array__": lambda t: np.asarray(t),
    "cpu": lambda t: t.cpu(),
    "to": lambda t: t.to("cpu"),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_python_level_read_counts_once(name):
    t = torch.arange(4, dtype=torch.float32)
    with count_host_transfers() as counts:
        READS[name](t)
    assert (counts.explicit_gets, counts.implicit_syncs) == (0, 1), counts
    assert counts.sites == [f"Tensor.{name}"]


def test_what_is_not_an_implicit_read():
    t = torch.arange(4, dtype=torch.float32)
    with count_host_transfers() as counts:
        out = device_get(t * 2)
        t.to(torch.float64)      # a cast, not a host read
        t.to("meta")             # no CPU target
        (t + 1).sum(), t.shape, t.dtype, len(t)
    assert isinstance(out, np.ndarray) and out.tolist() == [0.0, 2.0, 4.0, 6.0]
    assert counts == TransferCounts(explicit_gets=1)


def test_reads_on_another_thread_count():
    t = torch.ones(3)
    with count_host_transfers() as counts:
        worker = threading.Thread(target=lambda: (device_get(t), t.sum().item()))
        worker.start()
        worker.join()
    assert (counts.explicit_gets, counts.implicit_syncs) == (1, 1)


def test_guard_restores_the_tensor_methods_and_is_not_reentrant():
    before = {n: torch.Tensor.__dict__.get(n) for n in READS}
    with pytest.raises(ZeroDivisionError):
        with count_host_transfers():
            1 / 0
    with count_host_transfers():
        with pytest.raises(RuntimeError, match="re-entrant"):
            with count_host_transfers():
                pass
    assert {n: torch.Tensor.__dict__.get(n) for n in READS} == before
    t = torch.ones(2)
    assert t.sum().item() == 2.0 and bool(t[0]) and np.asarray(t).shape == (2,)
    with count_host_transfers() as counts:  # usable again, counting from 0
        t.sum().item()
    assert counts.implicit_syncs == 1


def test_tier_reads_once_per_flushed_batch():
    _, svc = _services("fused")
    clock = FakeClock()
    tier = ServingTier(
        svc, 12, TierConfig(doc_counts=(32,), persistent_cache=False),
        policy=BucketPolicy(max_queries=4, max_wait_ms=5.0), clock=clock,
    )
    tier.start()
    rng = np.random.default_rng(11)
    queries = [rng.normal(size=(int(rng.integers(8, 33)), 12)).astype(np.float32) for _ in range(50)]
    before = svc.stats.batches
    with count_host_transfers() as counts:
        futs = [tier.submit(q) for q in queries]
        clock.advance(0.006)  # the last, partial bucket flushes on its deadline
        results, errors = settle(futs, timeout_s=120)
    tier.stop()
    assert len(results) == 50 and errors == []
    flushed = svc.stats.batches - before
    assert flushed >= 50 // 4
    assert (counts.explicit_gets, counts.implicit_syncs) == (flushed, 0), counts
