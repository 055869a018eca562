"""Typed failure modes of the serving tier.

The port of :mod:`repro.serve.errors` (pure Python, copied). Every way a
request can fail short of an engine bug has its own type, so callers
branch on policy (retry, shed to a fallback, serve a cached page) instead
of on messages:

- :class:`Overloaded` — admission control rejected the submit: the pending
  queue is at ``BucketPolicy.max_queue_depth``. Raised from ``submit``.
- :class:`DeadlineExceeded` — the request's end-to-end deadline expired
  before the engine would have finished it. Set on the future; also a
  ``TimeoutError``.
- :class:`BatcherStopped` — ``submit`` raced or followed ``stop()``.
- :class:`WorkerCrashed` — the worker thread died with the request in
  flight; the supervisor restarts it and later requests are served.
- :class:`WorkerFailed` — the supervisor used up its restart budget; the
  tier needs an operator.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of every typed serving-tier failure."""


class Overloaded(ServeError):
    """Admission control: the pending queue is full; the request was shed.
    ``depth`` is the depth seen at rejection, ``limit`` the bound."""

    def __init__(self, depth: int, limit: int) -> None:
        super().__init__(f"serving queue overloaded: depth {depth} >= limit {limit}")
        self.depth = depth
        self.limit = limit


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's end-to-end deadline expired before scoring."""

    def __init__(self, deadline_ms: float, waited_ms: float) -> None:
        super().__init__(
            f"request deadline of {deadline_ms:.3f} ms exceeded "
            f"(waited {waited_ms:.3f} ms)"
        )
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms


class BatcherStopped(ServeError):
    """submit() raced or followed stop(); the batcher accepts no work."""


class WorkerCrashed(ServeError):
    """The worker thread died with this request in flight; the supervisor
    restarts it. The request itself is lost."""


class WorkerFailed(ServeError):
    """The supervisor gave up restarting the worker (restart budget used
    up); the tier needs operator attention."""
