"""Continuous batching: many small concurrent queries → padded engine blocks.

The port of :mod:`repro.serve.batching`. The engine wants padded
``[Q, D, F]`` blocks (one packed device read per batch); traffic is a
stream of single queries with ragged candidate counts.
:class:`ContinuousBatcher` closes the gap:

- **Submit** is non-blocking: a query's features go into the pending set
  of its *document bucket* (candidate count rounded up to a power of two,
  floored at ``BucketPolicy.min_docs``) and the caller gets a ``Future``.
- **One worker thread owns every engine call**: the service's adaptive
  state (per-bucket peaks, EMA, tail-skip rate, the active rung) and the
  kernels' per-stream scratch are touched from that thread alone, so
  neither needs a lock.
- **Flush policy**: a bucket flushes when it holds ``max_queries`` queries
  or when its oldest request has waited ``max_wait_ms``. The worker sleeps
  on a condition variable until the earliest pending flush time.
- **Scatter-back**: the block is padded to the next power-of-two query
  count (``policy.query_bucket``; padding rows are ``mask=False``), scored
  once, and each query's slice goes back to its future with a per-request
  top-k in ``lax.top_k``'s order (descending score, ascending index), so a
  batched response is bit-exact with the query served alone.

Faults (:mod:`repro_torch.serve.errors`): admission control
(``max_queue_depth`` → :class:`Overloaded`), request deadlines (the flush
is pulled forward by the expected engine time of the bucket, seeded from
:func:`repro_torch.serve.calibration.expected_engine_seconds`; a request
that expires in the queue fails with :class:`DeadlineExceeded` before any
engine work), supervision (:class:`~repro_torch.serve.supervisor.WorkerSupervisor`:
a crash fails the in-flight bucket with :class:`WorkerCrashed`, queued
requests survive the restart), engine errors and per-request poison
contained in :meth:`ContinuousBatcher._flush`, and an optional
:class:`~repro_torch.serve.degradation.DegradationController` fed each
flush's queue delay from the worker thread.

Padding rows are inert: scoring is per document, the LEAR features are
per-query masked reductions, and compaction touches alive documents only,
so a query's scores do not depend on its neighbours in the block.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import typing
from collections.abc import Callable, Sequence
from concurrent.futures import Future

import numpy as np

from repro_torch.kernels.forest_score import _next_pow2
from repro_torch.serve.calibration import expected_engine_seconds
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock
from repro_torch.serve.errors import (
    BatcherStopped,
    DeadlineExceeded,
    Overloaded,
    WorkerCrashed,
    WorkerFailed,
)
from repro_torch.serve.supervisor import STATE_NEW, SupervisorHealth, WorkerSupervisor

if typing.TYPE_CHECKING:
    from numpy.typing import ArrayLike

    from repro_torch.serve.degradation import DegradationController
    from repro_torch.serve.placement import ServePlacement
    from repro_torch.serve.ranking_service import RankingService

#: Completed-request latencies kept for ``health()``'s p50/p99.
LATENCY_WINDOW = 512

#: Smoothing of the per-bucket engine-seconds EMA of the flush schedule.
ENGINE_TIME_EMA_ALPHA = 0.3

#: Slack subtracted from a deadline when placing its flush: a wakeup is not
#: instant, and a flush at exactly ``expires_at - engine_time`` would race
#: its own expiry check.
FLUSH_SLACK_S = 5e-3


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """When to flush, which padded shapes exist, how deep the queue goes.

    ``max_queries`` (a power of two) is the full-bucket trigger and the
    largest padded Q. ``max_queue_depth`` bounds the TOTAL pending count:
    a submit past it raises :class:`Overloaded` (``None`` = unbounded, for
    offline use only).
    """

    max_queries: int = 8
    max_wait_ms: float = 2.0
    min_docs: int = 8
    max_docs: int = 4096
    max_queue_depth: int | None = 1024

    def __post_init__(self) -> None:
        if self.max_queries < 1 or _next_pow2(self.max_queries) != self.max_queries:
            raise ValueError(f"max_queries must be a power of two, got {self.max_queries}")
        if not 1 <= self.min_docs <= self.max_docs:
            raise ValueError(f"need 1 <= min_docs <= max_docs: {self}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth {self.max_queue_depth}")

    def doc_bucket(self, n_docs: int) -> int:
        if not 1 <= n_docs <= self.max_docs:
            raise ValueError(f"{n_docs} candidates outside [1, {self.max_docs}]")
        return max(self.min_docs, _next_pow2(n_docs))

    def query_bucket(self, n_queries: int) -> int:
        return min(self.max_queries, _next_pow2(n_queries))

    def buckets(self, doc_counts: Sequence[int]) -> list[tuple[int, int]]:
        """The padded ``(Q, D)`` shapes this policy produces for these doc
        counts — the warmup list: every query bucket up to ``max_queries``
        crossed with each distinct document bucket."""
        qs = [1 << i for i in range(self.max_queries.bit_length())]
        ds = sorted({self.doc_bucket(d) for d in doc_counts})
        return [(q, d) for d in ds for q in qs]


@dataclasses.dataclass
class _Pending:
    features: np.ndarray   # [n_docs, F] f32
    n_docs: int
    future: Future
    flush_at: float        # clock time by which this request must flush
    expires_at: float      # end-to-end deadline (inf = none)
    deadline_ms: float     # as submitted (inf = none), for error messages
    enqueued_at: float     # clock time of submit, for latency accounting


@dataclasses.dataclass
class BatcherStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    flushes_full: int = 0
    flushes_deadline: int = 0
    flushes_drain: int = 0
    padded_query_slots: int = 0   # dead rows shipped (padding overhead)
    max_queue_depth: int = 0      # high-water mark observed
    shed_overload: int = 0        # submits rejected by admission control
    shed_deadline: int = 0        # submits dead on arrival (budget <= 0)
    expired_deadline: int = 0     # requests that timed out in the queue
    worker_crashes: int = 0       # in-flight buckets lost to worker death

    @property
    def flushes(self) -> int:
        return self.flushes_full + self.flushes_deadline + self.flushes_drain

    @property
    def shed_rate(self) -> float:
        return self.shed_overload / max(self.submitted, 1)

    @property
    def deadline_miss_rate(self) -> float:
        return (self.shed_deadline + self.expired_deadline) / max(self.submitted, 1)


@dataclasses.dataclass
class BatcherHooks:
    """Fault-injection seams (``tests/torch_faults.py``).

    ``on_flush(doc_bucket, n_reqs)`` runs on the worker thread after a
    bucket is popped and before the engine call; an exception there is a
    worker crash. ``on_result(future)`` runs per request during
    scatter-back; an exception there fails that request alone.
    """

    on_flush: Callable[[int, int], None] | None = None
    on_result: Callable[[Future], None] | None = None


class ContinuousBatcher:
    """Packs concurrent single-query submissions into engine-sized blocks.

    ``start()`` → any number of ``submit()`` (from any thread) → ``stop()``
    (drains what is queued, then joins the worker). The stop/submit handoff
    is atomic under the condition lock: a submit either lands before the
    drain snapshot (and is served) or raises :class:`BatcherStopped`.
    """

    def __init__(
        self,
        service: RankingService,
        n_features: int,
        policy: BucketPolicy | None = None,
        placement: ServePlacement | None = None,
        *,
        clock: Clock | None = None,
        hooks: BatcherHooks | None = None,
        degradation: DegradationController | None = None,
        max_restarts: int = 5,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
    ) -> None:
        self.service = service
        self.n_features = int(n_features)
        self.policy = policy or BucketPolicy()
        self.placement = placement
        self.hooks = hooks
        self.degradation = degradation
        self.stats = BatcherStats()
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock or SYSTEM_CLOCK
        self._pending: dict[int, list[_Pending]] = {}
        self._inflight: list[_Pending] = []
        self._cond = threading.Condition()
        self._running = False
        self._failed = False
        self._supervisor: WorkerSupervisor | None = None
        self._last_sup_health: SupervisorHealth | None = None
        self._latencies: collections.deque[float] = collections.deque(maxlen=LATENCY_WINDOW)
        self._engine_s_ema: dict[int, float] = {}

    # -- client side ------------------------------------------------------

    def start(self) -> None:
        if self._supervisor is not None:
            raise RuntimeError("batcher already started")
        with self._cond:
            self._running = True
            self._failed = False
        self._supervisor = WorkerSupervisor(
            self._run,
            name="repro-batcher",
            backoff_base_s=self.backoff_base_s,
            backoff_max_s=self.backoff_max_s,
            max_restarts=self.max_restarts,
            clock=self._clock,
            on_crash=self._on_worker_crash,
            on_failed=self._on_worker_failed,
        )
        self._supervisor.start()

    def submit(self, features: ArrayLike, deadline_ms: float | None = None) -> Future:
        """Enqueue one query's ``[n_docs, F]`` candidates; the future
        resolves to ``(top_idx [k] int32, scores [n_docs] f32)``.

        ``deadline_ms`` is the request's end-to-end budget from this call:
        the flush is scheduled early enough for the expected engine time,
        and a request whose budget expires while queued fails with
        :class:`DeadlineExceeded` (a non-positive budget at once, never
        queued). Raises :class:`Overloaded` at ``max_queue_depth`` and
        :class:`BatcherStopped` after (or racing) ``stop()``.
        """
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.n_features:
            raise ValueError(f"features {feats.shape}, expected [n_docs, {self.n_features}]")
        n_docs = feats.shape[0]
        db = self.policy.doc_bucket(n_docs)
        fut: Future = Future()
        now = self._clock.now()
        with self._cond:
            if self._failed:
                raise WorkerFailed("serving worker exhausted its restart budget")
            if not self._running:
                raise BatcherStopped("batcher is not running")
            self.stats.submitted += 1
            if deadline_ms is not None and deadline_ms <= 0.0:
                # Dead on arrival: never queued, never scored.
                self.stats.shed_deadline += 1
                self.stats.failed += 1
                fut.set_exception(DeadlineExceeded(float(deadline_ms), 0.0))
                return fut
            depth = sum(len(v) for v in self._pending.values())
            limit = self.policy.max_queue_depth
            if limit is not None and depth >= limit:
                self.stats.shed_overload += 1
                raise Overloaded(depth, limit)
            flush_at = now + self.policy.max_wait_ms / 1e3
            expires_at = math.inf
            if deadline_ms is not None:
                expires_at = now + float(deadline_ms) / 1e3
                # Flush early enough that the engine call fits the budget,
                # and no earlier than now.
                budget = self._engine_seconds_estimate(db) + FLUSH_SLACK_S
                flush_at = min(flush_at, max(now, expires_at - budget))
            self._pending.setdefault(db, []).append(_Pending(
                features=feats,
                n_docs=n_docs,
                future=fut,
                flush_at=flush_at,
                expires_at=expires_at,
                deadline_ms=math.inf if deadline_ms is None else float(deadline_ms),
                enqueued_at=now,
            ))
            self.stats.max_queue_depth = max(self.stats.max_queue_depth, depth + 1)
            self._cond.notify()
        return fut

    def stop(self) -> None:
        """Drain everything queued, then stop the worker. Under the lock the
        batcher flips to not-running and takes the pending map, so a racing
        submit is either in the drain or raises."""
        with self._cond:
            self._running = False
            drain, self._pending = self._pending, {}
            self._cond.notify_all()
        if self._supervisor is not None:
            self._supervisor.stop()
            self._last_sup_health = self._supervisor.health()
            self._supervisor = None
        # Flushed on the caller's thread (the worker has stopped), in
        # engine-sized chunks: a drained bucket may hold more than
        # max_queries requests.
        step = self.policy.max_queries
        for db, reqs in sorted(drain.items()):
            for i in range(0, len(reqs), step):
                self.stats.flushes_drain += 1
                self._flush(db, reqs[i:i + step])

    def health(self) -> dict:
        """Liveness: supervisor state, queue depth, p50/p99 completion
        latency (ms) over the last :data:`LATENCY_WINDOW` requests."""
        sup = (
            self._supervisor.health() if self._supervisor is not None
            else self._last_sup_health or SupervisorHealth(STATE_NEW, 0, 0, None)
        )
        with self._cond:
            depth = sum(len(v) for v in self._pending.values())
            lat = list(self._latencies)
        p50 = p99 = 0.0
        if lat:
            arr = np.asarray(lat, np.float64) * 1e3
            p50, p99 = float(np.percentile(arr, 50)), float(np.percentile(arr, 99))
        return {
            "state": sup.state,
            "restarts": sup.restarts,
            "crashes": sup.crashes,
            "last_error": sup.last_error,
            "queue_depth": depth,
            "p50_ms": p50,
            "p99_ms": p99,
        }

    # -- supervision callbacks (guard thread) -----------------------------

    def _on_worker_crash(self, exc: BaseException) -> None:
        """The worker died mid-bucket: fail exactly the in-flight requests;
        queued ones are served after the restart."""
        with self._cond:
            inflight, self._inflight = self._inflight, []
            self.stats.worker_crashes += 1
        err = WorkerCrashed(f"serving worker died: {exc!r}")
        err.__cause__ = exc
        for r in inflight:
            self._fail(r, err)

    def _on_worker_failed(self, exc: BaseException) -> None:
        """The supervisor gave up: fail every pending and in-flight future
        and refuse new submits."""
        with self._cond:
            self._failed = True
            pending, self._pending = self._pending, {}
            inflight, self._inflight = self._inflight, []
            self._cond.notify_all()
        err = WorkerFailed(f"serving worker restart budget exhausted: {exc!r}")
        err.__cause__ = exc
        for r in [*inflight, *(r for reqs in pending.values() for r in reqs)]:
            self._fail(r, err)

    # -- worker side ------------------------------------------------------

    def _engine_seconds_estimate(self, db: int) -> float:
        """Expected wall time of one flush at doc bucket ``db``: the
        observed EMA once there is traffic, else the calibration prior."""
        ema = self._engine_s_ema.get(db)
        if ema is not None:
            return ema
        ensemble = getattr(self.service, "ensemble", None)
        if ensemble is None:
            return 0.0
        return expected_engine_seconds(self.policy.max_queries * db, ensemble.n_trees)

    def _take_ready(
        self, now: float
    ) -> tuple[int | None, list | None, str | None, float | None]:
        """Pop the bucket to flush now with its trigger, or return the
        earliest future flush time. Full buckets go first; among ripe timers
        the most urgent request wins."""
        for db, reqs in sorted(self._pending.items()):
            if len(reqs) >= self.policy.max_queries:
                self._pending[db] = reqs[self.policy.max_queries:]
                return db, reqs[: self.policy.max_queries], "full", None
        ripe_db, ripe_t = None, None
        for db, reqs in self._pending.items():
            if reqs:
                t = min(r.flush_at for r in reqs)
                if ripe_t is None or t < ripe_t:
                    ripe_db, ripe_t = db, t
        if ripe_t is not None and ripe_t <= now:
            return ripe_db, self._pending.pop(ripe_db), "deadline", None
        return None, None, None, ripe_t

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = self._clock.now()
                    db, reqs, trigger, next_t = self._take_ready(now)
                    if reqs is not None:
                        break
                    if not self._running:
                        return  # leftovers flush in stop()
                    self._clock.wait(
                        self._cond, None if next_t is None else max(next_t - now, 0.0)
                    )
                self._inflight = reqs
                queue_delay = now - min(r.enqueued_at for r in reqs)
            if trigger == "full":
                self.stats.flushes_full += 1
            else:
                self.stats.flushes_deadline += 1
            if self.degradation is not None:
                # The worker thread is the only one that steps the rungs.
                self.degradation.observe(queue_delay)
            if self.hooks is not None and self.hooks.on_flush is not None:
                # Outside _flush's containment on purpose: a failure here
                # IS a worker crash, for the supervisor.
                self.hooks.on_flush(db, len(reqs))
            t0 = self._clock.now()
            self._flush(db, reqs)
            elapsed = self._clock.now() - t0
            with self._cond:
                self._inflight = []
                prev = self._engine_s_ema.get(db)
                a = ENGINE_TIME_EMA_ALPHA
                self._engine_s_ema[db] = elapsed if prev is None else (1 - a) * prev + a * elapsed

    def _flush(self, db: int, reqs: list[_Pending]) -> None:
        """Score one padded block and scatter per-query results back.

        Containment, tightest first: an expired request fails without
        engine work; a request that cannot be packed fails alone (its row
        stays masked); an engine error fails this bucket and returns; a
        per-request scatter error fails that request. Anything escaping is
        a worker crash.
        """
        now = self._clock.now()
        live: list[_Pending | None] = []
        for r in reqs:
            if r.expires_at <= now:
                self._expire(r, now)
            else:
                live.append(r)
        if not live:
            return  # the whole bucket died in the queue: no engine call
        qb = self.policy.query_bucket(len(live))
        X = np.zeros((qb, db, self.n_features), np.float32)
        mask = np.zeros((qb, db), bool)
        for i, r in enumerate(live):
            try:
                X[i, : r.n_docs] = r.features
                mask[i, : r.n_docs] = True
            except Exception as e:  # noqa: BLE001 — a malformed request fails alone
                mask[i] = False
                self._fail(r, e)
                live[i] = None
        self.stats.padded_query_slots += qb - len(live)
        try:
            _, scores = self.service.rank_batch(X, mask, placement=self.placement)
            scores = np.asarray(scores)
        except Exception as e:  # noqa: BLE001 — engine failure: fail the bucket, keep serving
            for r in live:
                if r is not None:
                    self._fail(r, e)
            return
        for i, r in enumerate(live):
            if r is None:
                continue
            try:
                if self.hooks is not None and self.hooks.on_result is not None:
                    self.hooks.on_result(r.future)
                s = scores[i, : r.n_docs].copy()
                k = min(self.service.top_k, r.n_docs)
                # lax.top_k's order: descending score, then ascending index.
                top = np.lexsort((np.arange(r.n_docs), -s))[:k]
                r.future.set_result((top.astype(np.int32), s))
                self.stats.completed += 1
                self._latencies.append(self._clock.now() - r.enqueued_at)
            except Exception as e:  # noqa: BLE001 — poisoned scatter: this request only
                self._fail(r, e)

    # -- resolution -------------------------------------------------------

    def _fail(self, r: _Pending, exc: BaseException) -> None:
        if not r.future.done():
            r.future.set_exception(exc)
            self.stats.failed += 1

    def _expire(self, r: _Pending, now: float) -> None:
        self.stats.expired_deadline += 1
        self._fail(r, DeadlineExceeded(r.deadline_ms, (now - r.enqueued_at) * 1e3))
