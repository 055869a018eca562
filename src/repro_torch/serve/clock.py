"""Injectable time source of the serving tier.

The port of :mod:`repro.serve.clock` (pure Python, copied). Everything in
``serve/`` that reads the clock or waits on a condition goes through a
:class:`Clock`, so tests substitute virtual time and drive deadline and
backoff logic without sleeping (``tests/torch_faults.py``).
:class:`MonotonicClock` — ``time.perf_counter`` and real condition waits —
is the default everywhere.
"""

from __future__ import annotations

import threading
import time
import typing


@typing.runtime_checkable
class Clock(typing.Protocol):
    """Monotonic time and interruptible waiting, as one seam."""

    def now(self) -> float:
        """Seconds on a monotonic axis (``time.perf_counter`` semantics)."""
        ...

    def wait(self, cond: threading.Condition, timeout: float | None) -> bool:
        """Wait on ``cond`` (held by the caller) for up to ``timeout``
        seconds (``None`` = forever). True if notified."""
        ...

    def sleep(self, cond: threading.Condition, seconds: float) -> None:
        """Sleep up to ``seconds`` on ``cond`` (acquired here), so that a
        notify (``stop()``) wakes the sleeper early."""
        ...


class MonotonicClock:
    """The real clock: ``perf_counter`` and real condition waits."""

    def now(self) -> float:
        return time.perf_counter()

    def wait(self, cond: threading.Condition, timeout: float | None) -> bool:
        return cond.wait(timeout=timeout)

    def sleep(self, cond: threading.Condition, seconds: float) -> None:
        with cond:
            cond.wait(timeout=max(seconds, 0.0))


SYSTEM_CLOCK = MonotonicClock()
