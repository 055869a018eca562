"""Worker supervision: detect thread death, restart with bounded backoff.

The port of :mod:`repro.serve.supervisor` (pure Python). The batcher's one
worker thread owns every engine call; if it died unsupervised, submits
would queue forever. :class:`WorkerSupervisor`:

- runs the worker body (``target``) in a guard thread: a normal return is
  a clean exit, any exception a crash;
- on a crash calls ``on_crash(exc)`` (the batcher fails the in-flight
  futures with :class:`~repro_torch.serve.errors.WorkerCrashed`), then
  restarts the worker after ``backoff_base_s · 2^k`` seconds, capped at
  ``backoff_max_s``;
- after ``max_restarts`` restarts gives up: state ``"failed"``,
  ``on_failed(exc)`` fires. The budget counts over the supervisor's life.

Backoff sleeps go through the injectable
:class:`~repro_torch.serve.clock.Clock` and are interruptible: ``stop()``
wakes a sleeping supervisor at once.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections.abc import Callable

from repro_torch.serve.clock import SYSTEM_CLOCK, Clock

_LOG = logging.getLogger(__name__)

STATE_NEW = "new"
STATE_RUNNING = "running"
STATE_BACKOFF = "backoff"
STATE_STOPPED = "stopped"
STATE_FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class SupervisorHealth:
    """Point-in-time snapshot of the supervised worker."""

    state: str
    restarts: int
    crashes: int
    last_error: str | None

    @property
    def healthy(self) -> bool:
        return self.state in (STATE_NEW, STATE_RUNNING)


class WorkerSupervisor:
    """Runs ``target`` in a guarded thread, restarting it on crashes.

    ``start()`` → the worker runs (restarted on a crash, after a backoff)
    → ``stop()`` joins the guard. ``target`` must return promptly once its
    owner's own stop flag is set: the supervisor never interrupts a running
    worker, it only decides what happens after it returns or raises.
    """

    def __init__(
        self,
        target: Callable[[], None],
        *,
        name: str = "repro-worker",
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        max_restarts: int = 5,
        clock: Clock | None = None,
        on_crash: Callable[[BaseException], None] | None = None,
        on_failed: Callable[[BaseException], None] | None = None,
    ) -> None:
        if not (0.0 < backoff_base_s <= backoff_max_s and max_restarts >= 0):
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s, max_restarts >= 0")
        self._target = target
        self._name = name
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._max_restarts = int(max_restarts)
        self._clock = clock or SYSTEM_CLOCK
        self._on_crash = on_crash
        self._on_failed = on_failed
        self._cond = threading.Condition()
        self._state = STATE_NEW
        self._restarts = 0
        self._crashes = 0
        self._last_error: BaseException | None = None
        self._running = False
        self._guard: threading.Thread | None = None

    def start(self) -> None:
        with self._cond:
            if self._guard is not None:
                raise RuntimeError("supervisor already started")
            self._running = True
            self._state = STATE_RUNNING
        self._guard = threading.Thread(
            target=self._guard_loop, name=f"{self._name}-guard", daemon=True
        )
        self._guard.start()

    def stop(self) -> None:
        """Stop supervising and join the guard thread. The owner has already
        told the worker body to exit (its own stop flag and notify)."""
        with self._cond:
            if self._guard is None:
                return
            self._running = False
            self._cond.notify_all()  # wake a backoff sleeper
        self._guard.join()
        self._guard = None

    def health(self) -> SupervisorHealth:
        with self._cond:
            return SupervisorHealth(
                state=self._state,
                restarts=self._restarts,
                crashes=self._crashes,
                last_error=None if self._last_error is None else repr(self._last_error),
            )

    @property
    def state(self) -> str:
        with self._cond:
            return self._state

    def _guard_loop(self) -> None:
        while True:
            exc: BaseException | None = None
            try:
                self._target()
            # The supervisor is the boundary that must keep running: any
            # escape from the worker becomes a supervised crash.
            except BaseException as e:  # noqa: BLE001  # repro: noqa(TS007) -- the supervisor IS the catch-all: crashes become restarts
                exc = e
            with self._cond:
                if exc is None or not self._running:
                    # A clean return, or a crash while stopping: done.
                    self._state = STATE_STOPPED
                    if exc is not None:
                        self._crashes += 1
                        self._last_error = exc
                    return
                self._crashes += 1
                self._last_error = exc
            self._notify(self._on_crash, exc)
            with self._cond:
                if self._restarts >= self._max_restarts:
                    self._state = STATE_FAILED
                    break
                self._restarts += 1
                self._state = STATE_BACKOFF
                delay = min(
                    self._backoff_base_s * 2.0 ** (self._restarts - 1), self._backoff_max_s
                )
            self._clock.sleep(self._cond, delay)
            with self._cond:
                if not self._running:
                    self._state = STATE_STOPPED
                    return
                self._state = STATE_RUNNING
        self._notify(self._on_failed, exc)

    @staticmethod
    def _notify(callback: Callable[[BaseException], object] | None, exc: BaseException) -> None:
        if callback is not None:
            try:
                callback(exc)
            except Exception:  # a broken callback must not kill the guard
                _LOG.exception("supervisor callback failed")
