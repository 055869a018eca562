"""Fault-injection helpers for the port's serving-tier tests.

The port of ``tests/faults.py``, importing nothing of ``repro``:

- :class:`FakeClock` — virtual monotonic time behind the
  :class:`repro_torch.serve.clock.Clock` protocol. ``now()`` reads it,
  ``advance()`` moves it; a condition wait is a short real wait (a few ms)
  so the worker re-reads the virtual clock often.
- :class:`FakeService` — a numpy stand-in for ``RankingService`` with the
  same ``rank_batch`` surface (per-document scores independent of block
  neighbours, like the real masked engine), injectable engine failures,
  and the rung surface the degradation controller drives.
- :class:`CrashTimes` — a ``BatcherHooks.on_flush`` payload that kills the
  worker a set number of times; :class:`PoisonOnce` — an ``on_result``
  payload that poisons one request's scatter.
- :func:`settle` — resolve futures into (results, errors) within a hard
  timeout; :func:`spike` — fire submits and keep synchronous rejections as
  failed futures.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.serve.ranking_service import ServiceStats

#: Real seconds a FakeClock condition wait blocks per poll.
POLL_S = 0.002


class InjectedCrash(RuntimeError):
    """The fault thrown to kill a worker thread."""


class InjectedEngineError(RuntimeError):
    """The fault thrown from inside the (fake) engine."""


class FakeClock:
    """Virtual time with the ``Clock`` surface; waits are short real waits."""

    def __init__(self, start: float = 1000.0) -> None:
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0.0:
            raise ValueError(seconds)
        with self._lock:
            self._now += float(seconds)
            return self._now

    def wait(self, cond: threading.Condition, timeout: float | None) -> bool:
        if timeout is not None and timeout <= 0.0:
            return False
        return cond.wait(timeout=POLL_S)

    def sleep(self, cond: threading.Condition, seconds: float) -> None:
        with cond:
            cond.wait(timeout=POLL_S)


class FakeService:
    """Engine stand-in: scores are ``features.sum(-1)`` on alive rows.
    ``fail_next(n)`` arms ``n`` engine errors; ``gate`` (an Event), when
    set, is waited on (bounded) inside ``rank_batch``, to hold a flush;
    ``entered`` is set once a flush has reached ``rank_batch``."""

    def __init__(self, top_k: int = 5) -> None:
        self.top_k = int(top_k)
        self.stats = ServiceStats()
        self.calls = 0
        self.batch_shapes: list[tuple[int, int]] = []
        self.gate: threading.Event | None = None
        self.entered = threading.Event()
        self._fail_remaining = 0
        self._lock = threading.Lock()
        self.rungs_installed: tuple | None = None
        self.rung_level = 0
        self.rung_history: list[int] = []

    @property
    def n_rungs(self) -> int:
        return 0 if self.rungs_installed is None else len(self.rungs_installed) + 1

    def install_rungs(self, rungs) -> None:
        assert self.rungs_installed is None
        self.rungs_installed = tuple(rungs)

    def set_rung(self, level: int) -> None:
        assert 0 <= level < self.n_rungs, (level, self.n_rungs)
        self.rung_level = level
        self.rung_history.append(level)

    def fail_next(self, n: int = 1) -> None:
        with self._lock:
            self._fail_remaining = int(n)

    def rank_batch(self, X, mask, placement=None):
        self.calls += 1
        x, m = np.asarray(X), np.asarray(mask)
        self.batch_shapes.append((x.shape[0], x.shape[1]))
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=30), "FakeService gate never opened"
        with self._lock:
            if self._fail_remaining > 0:
                self._fail_remaining -= 1
                raise InjectedEngineError("injected engine failure")
        return None, x.sum(axis=-1) * m

    @staticmethod
    def expected_scores(features: np.ndarray) -> np.ndarray:
        return np.asarray(features, np.float32).sum(axis=-1)


class CrashTimes:
    """``on_flush`` payload: raise :class:`InjectedCrash` ``n`` times."""

    def __init__(self, n: int = 1) -> None:
        self.remaining = int(n)
        self.fired = 0
        self._lock = threading.Lock()

    def arm(self, n: int = 1) -> None:
        with self._lock:
            self.remaining += n

    def __call__(self, doc_bucket: int, n_reqs: int) -> None:
        with self._lock:
            if self.remaining > 0:
                self.remaining -= 1
                self.fired += 1
                raise InjectedCrash("injected worker kill")


class PoisonOnce:
    """``on_result`` payload: poison exactly one scatter."""

    def __init__(self) -> None:
        self.armed = True

    def __call__(self, future: Future) -> None:
        if self.armed:
            self.armed = False
            raise InjectedEngineError("injected per-request poison")


def settle(futures: list[Future], timeout_s: float = 30.0) -> tuple[list, list[BaseException]]:
    """Wait for every future within ``timeout_s`` in all; ``(results,
    errors)`` in submission order. Fails if one is left unresolved."""
    deadline = time.monotonic() + timeout_s
    results, errors = [], []
    for fut in futures:
        remaining = deadline - time.monotonic()
        assert remaining > 0, "settle(): timed out with futures unresolved"
        try:
            results.append(fut.result(timeout=remaining))
        except Exception as e:  # noqa: BLE001 — classification, not handling
            assert fut.done(), "settle(): timed out with futures unresolved"
            errors.append(e)
    return results, errors


def spike(batcher, n: int, features: np.ndarray, deadline_ms=None) -> list[Future]:
    """Fire ``n`` submits; a synchronous rejection becomes a failed future."""
    futs: list[Future] = []
    for _ in range(n):
        try:
            futs.append(batcher.submit(features, deadline_ms=deadline_ms))
        except Exception as e:  # noqa: BLE001 — kept as the request's outcome
            f: Future = Future()
            f.set_exception(e)
            futs.append(f)
    return futs
