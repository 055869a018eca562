"""Load-adaptive degradation: trade NDCG for latency with LEAR's own knobs.

The port of :mod:`repro.serve.degradation`. The paper's exit thresholds
and a finite query-exit margin are budget knobs; under overload they are
the levers a tier pulls before it sheds traffic:

- :class:`ExitRung` — one step down, as overrides of the service's exit
  knobs (LEAR ``threshold``, a :class:`QueryExitConfig` with a finite
  margin, the hybrid dense gate's ``dense_keep_frac``). ``None`` inherits
  the baseline.
- :class:`DegradationPolicy` — the rung ladder and its hysteresis band:
  degrade one rung when the queue-delay EMA is above ``degrade_above_ms``,
  recover one when it is below ``recover_below_ms`` (strictly lower), with
  at least ``dwell_flushes`` flushes between moves.
- :class:`DegradationController` — the runtime: owns the EMA and the level
  and calls :meth:`RankingService.set_rung` from the batcher's worker
  thread, the only thread that touches the engine.

Every rung is installed up front and warmed by
:func:`repro_torch.serve.warmup.warmup_service`, so stepping the ladder at
peak load meets no first-touch cost.
"""

from __future__ import annotations

import dataclasses
import threading
import typing

from repro_torch.core.strategies import QueryExitConfig
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock

if typing.TYPE_CHECKING:  # annotation-only: avoids a serve-package cycle
    from repro_torch.serve.ranking_service import RankingService


@dataclasses.dataclass(frozen=True)
class ExitRung:
    """One degradation step: overrides of the service's exit knobs.

    ``threshold`` replaces the LEAR continue threshold at every tree stage
    (higher = fewer survivors = cheaper); ``query_exit`` replaces the
    service's query-exit config; ``dense_keep_frac`` re-points the hybrid
    dense gate at
    :func:`repro_torch.core.strategies.dense_keep_fraction` with that keep
    fraction, same scorer (a smaller fraction sends fewer documents to the
    trees). Installing a ``dense_keep_frac`` rung on a service without a
    dense stage raises ``ValueError``.
    """

    name: str
    threshold: float | None = None
    query_exit: QueryExitConfig | None = None
    dense_keep_frac: float | None = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("a rung needs a name")
        if self.threshold is not None and not 0.0 <= self.threshold <= 1.0:
            raise ValueError(f"rung threshold {self.threshold} outside [0, 1]")
        if self.dense_keep_frac is not None and not 0.0 < self.dense_keep_frac <= 1.0:
            raise ValueError(f"dense_keep_frac {self.dense_keep_frac} outside (0, 1]")


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """The rung ladder (cheapest last; level 0, the baseline, is implicit)
    and when to move on it. The load signal is the EMA of each flush's
    queue delay (how long its oldest request waited)."""

    rungs: tuple[ExitRung, ...]
    degrade_above_ms: float = 10.0
    recover_below_ms: float = 2.0
    ema_alpha: float = 0.2
    dwell_flushes: int = 4

    def __post_init__(self) -> None:
        object.__setattr__(self, "rungs", tuple(self.rungs))
        if not self.rungs:
            raise ValueError("need at least one degradation rung")
        if not 0.0 <= self.recover_below_ms < self.degrade_above_ms:
            raise ValueError(
                f"hysteresis band [{self.recover_below_ms}, "
                f"{self.degrade_above_ms}] ms must be non-empty"
            )
        if not 0.0 < self.ema_alpha <= 1.0 or self.dwell_flushes < 1:
            raise ValueError(f"invalid DegradationPolicy {self}")


class DegradationController:
    """Runtime of one :class:`DegradationPolicy` over one service.

    :meth:`observe` runs on the batcher's worker thread only (it may call
    :meth:`RankingService.set_rung`); :meth:`snapshot` is safe from any
    thread.
    """

    def __init__(
        self,
        service: RankingService,
        policy: DegradationPolicy,
        clock: Clock | None = None,
    ) -> None:
        self.service = service
        self.policy = policy
        self.clock = clock or SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._level = 0
        self._delay_ema_ms: float | None = None
        self._since_move = policy.dwell_flushes  # free to move at once
        self._degrade_steps = 0
        self._recover_steps = 0

    @property
    def n_levels(self) -> int:
        return len(self.policy.rungs) + 1  # + the implicit baseline

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def install(self) -> None:
        """Install the ladder on the service (the tier does it before
        warmup, so that every rung is warmed)."""
        self.service.install_rungs(self.policy.rungs)

    def observe(self, queue_delay_s: float) -> int:
        """Fold one flush's queue delay into the EMA and move one rung if
        the band says so; returns the level. Worker thread only."""
        delay_ms = max(float(queue_delay_s), 0.0) * 1e3
        p = self.policy
        with self._lock:
            if self._delay_ema_ms is None:
                self._delay_ema_ms = delay_ms
            else:
                self._delay_ema_ms = (
                    (1.0 - p.ema_alpha) * self._delay_ema_ms + p.ema_alpha * delay_ms
                )
            self._since_move += 1
            move = 0
            if self._since_move >= p.dwell_flushes:
                if self._delay_ema_ms > p.degrade_above_ms and self._level < self.n_levels - 1:
                    move = 1
                elif self._delay_ema_ms < p.recover_below_ms and self._level > 0:
                    move = -1
            if move:
                self._level += move
                self._since_move = 0
                if move > 0:
                    self._degrade_steps += 1
                else:
                    self._recover_steps += 1
            level = self._level
        if move:
            # Outside the lock: snapshot() readers never wait on the engine.
            self.service.set_rung(level)
        return level

    def snapshot(self) -> dict:
        """Operator view: current rung, smoothed delay, transition counts."""
        with self._lock:
            level = self._level
            return {
                "level": level,
                "rung": "baseline" if level == 0 else self.policy.rungs[level - 1].name,
                "n_levels": self.n_levels,
                "queue_delay_ema_ms": self._delay_ema_ms,
                "degrade_steps": self._degrade_steps,
                "recover_steps": self._recover_steps,
                "degrade_above_ms": self.policy.degrade_above_ms,
                "recover_below_ms": self.policy.recover_below_ms,
            }
