"""The serving tier's fault contracts, the port against the reference.

The cases of the reference's ``tests/test_faults_edges.py`` and the
fake-engine cases of ``tests/test_chaos.py``. Each case is a scenario run
twice on the same inputs — once on the port's batcher, supervisor and
degradation controller, once on the reference's (``repro.serve``, pure
Python but for the batcher's ``jnp.asarray``) — with the same fake engine,
clock and fault hooks of ``tests/torch_faults.py``. The two traces must be
equal: every future's outcome (scores and top-k, or the error's type and
fields), the stats counters, supervisor states, restarts and crashes,
controller levels and ``rung_history``. The literals of the reference's
tests are then checked on the port's trace as well.

Covered: typed errors, deadlines (dead on arrival, pulled-forward flushes,
expiry in the queue), admission control at the bound, the stop/submit
handoff, the supervisor's restart/backoff/budget machine, crash
containment and restart, engine errors and poisoned scatters, load
shedding, the degradation hysteresis and the no-future-left-behind
invariant. Where a scenario races two threads on purpose (submits racing
``stop()``, random interleavings), the trace holds the invariants the
reference's test asserts, and those must hold on both.

Every threaded test runs on a virtual clock or on events, and every wait
has a timeout: nothing here polls the wall clock.
"""

from __future__ import annotations

import dataclasses
import threading
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import calibration as ref_calibration  # noqa: E402
from repro.serve import clock as ref_clock  # noqa: E402
from repro.serve import degradation as ref_degradation  # noqa: E402
from repro.serve import errors as ref_errors  # noqa: E402
from repro.serve import supervisor as ref_supervisor  # noqa: E402
from repro_torch.serve import batching, calibration, clock, degradation, errors  # noqa: E402
from repro_torch.serve import supervisor  # noqa: E402
from torch_faults import (  # noqa: E402
    CrashTimes,
    FakeClock,
    FakeService,
    PoisonOnce,
    settle,
    spike,
)

F = 12
WAIT_S = 30.0  # bound on every event wait and future in this file


def _impl(batching, calibration, clock, degradation, errors, supervisor):
    return types.SimpleNamespace(
        BatcherHooks=batching.BatcherHooks,
        BucketPolicy=batching.BucketPolicy,
        ContinuousBatcher=batching.ContinuousBatcher,
        expected_engine_seconds=calibration.expected_engine_seconds,
        clock=clock,
        DegradationController=degradation.DegradationController,
        DegradationPolicy=degradation.DegradationPolicy,
        ExitRung=degradation.ExitRung,
        errors=errors,
        WorkerSupervisor=supervisor.WorkerSupervisor,
        supervisor=supervisor,
    )


PORT = _impl(batching, calibration, clock, degradation, errors, supervisor)
REF = _impl(ref_batching, ref_calibration, ref_clock, ref_degradation, ref_errors,
            ref_supervisor)


def _both(scenario, *args):
    """Run ``scenario(impl, *args)`` on the port and on the reference and
    require equal traces; returns the port's."""
    port, ref = scenario(PORT, *args), scenario(REF, *args)
    assert port == ref, f"port trace {port!r}\n!= reference trace {ref!r}"
    return port


def _query(n_docs: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n_docs, F)).astype(np.float32)


def _batcher(impl, svc, policy=None, **kw):
    b = impl.ContinuousBatcher(svc, F, policy or impl.BucketPolicy(), **kw)
    b.start()
    return b


def _describe(exc: BaseException) -> tuple:
    """An error as plain data: its type's name and its typed fields."""
    fields = ("depth", "limit", "deadline_ms", "waited_ms")
    return (type(exc).__name__, *(getattr(exc, f) for f in fields if hasattr(exc, f)))


def _outcome(fut) -> tuple:
    """A future's outcome as plain data (waits at most WAIT_S)."""
    exc = fut.exception(timeout=WAIT_S)
    if exc is not None:
        return _describe(exc)
    top, scores = fut.result()
    return ("ok", top.dtype.name, top.tolist(), scores.dtype.name, scores.tolist())


def _raised(fn) -> tuple | None:
    """What ``fn()`` raised, as plain data, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return _describe(e)
    return None


def _rejects(fn) -> bool:
    """Whether ``fn()`` refuses its arguments. The port raises ValueError
    where the reference asserts, so both count as a rejection."""
    try:
        fn()
    except (ValueError, AssertionError):
        return True
    return False


def _stats(b) -> dict:
    return dataclasses.asdict(b.stats)


def _health(b) -> dict:
    return b.health()


def _sup_health(h) -> tuple:
    return (h.state, h.healthy, h.restarts, h.crashes, h.last_error)


def _expected(q) -> tuple:
    """The outcome of ``q`` served alone by the fake engine."""
    s = FakeService.expected_scores(q)
    top = np.lexsort((np.arange(len(s)), -s))[:min(FakeService().top_k, len(s))]
    return ("ok", "int32", top.astype(np.int32).tolist(), "float32", s.tolist())


def _join(fn) -> None:
    """Run ``fn`` on a thread and require it to return within WAIT_S."""
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive(), f"{fn} did not return within {WAIT_S} s"


# -- typed errors -------------------------------------------------------------


def _taxonomy(impl):
    e = impl.errors
    out = []
    for err in (e.Overloaded(3, 2), e.DeadlineExceeded(5.0, 9.0), e.BatcherStopped("x"),
                e.WorkerCrashed("y"), e.WorkerFailed("z")):
        out.append((
            _describe(err), str(err), [c.__name__ for c in type(err).__mro__],
            isinstance(err, e.ServeError), isinstance(err, RuntimeError),
            isinstance(err, TimeoutError),
        ))
    return out


def test_error_taxonomy():
    trace = _both(_taxonomy)
    assert all(serve and runtime for _d, _s, _mro, serve, runtime, _t in trace)
    assert trace[0][0] == ("Overloaded", 3, 2)
    assert trace[1][0] == ("DeadlineExceeded", 5.0, 9.0) and trace[1][5]  # a TimeoutError
    o, d = PORT.errors.Overloaded(1024, 1024), PORT.errors.DeadlineExceeded(5.0, 9.25)
    assert o.depth == 1024 and o.limit == 1024
    assert d.deadline_ms == 5.0 and d.waited_ms == 9.25


# -- deadlines ----------------------------------------------------------------


def _zero_deadline(impl):
    svc = FakeService()
    b = _batcher(impl, svc, clock=FakeClock())
    fut = b.submit(_query(16), deadline_ms=0.0)
    out = _outcome(fut)
    b.stop()
    return {"outcome": out, "calls": svc.calls, "stats": _stats(b),
            "miss_rate": b.stats.deadline_miss_rate}


def test_zero_deadline_is_dead_on_arrival():
    t = _both(_zero_deadline)
    assert t["outcome"] == ("DeadlineExceeded", 0.0, 0.0)
    assert t["calls"] == 0
    assert t["stats"]["shed_deadline"] == 1 and t["stats"]["failed"] == 1
    assert t["miss_rate"] == 1.0


def _flush_early(impl):
    clock = FakeClock()
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=8, max_wait_ms=10_000.0), clock=clock)
    fut = b.submit(_query(16), deadline_ms=50.0)
    clock.advance(0.046)  # past the pulled-forward flush, far inside the window
    out = _outcome(fut)
    b.stop()
    return {"outcome": out, "stats": _stats(b), "shapes": svc.batch_shapes,
            "health": _health(b)}


def test_deadline_tighter_than_flush_window_flushes_early():
    """A 10 s wait window would hold a lone query; its 50 ms deadline pulls
    the flush forward to 50 ms less the 5 ms wakeup slack."""
    t = _both(_flush_early)
    assert t["outcome"] == _expected(_query(16))
    assert t["stats"]["flushes_deadline"] == 1 and t["stats"]["expired_deadline"] == 0
    assert t["shapes"] == [(1, 16)]


def _in_queue_expiry(impl):
    clock = FakeClock()
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=8, max_wait_ms=5.0), clock=clock)
    fut = b.submit(_query(16), deadline_ms=10.0)
    clock.advance(0.020)  # ripen the flush AND blow the budget
    out = _outcome(fut)
    b.stop()
    return {"outcome": out, "calls": svc.calls, "stats": _stats(b)}


def test_in_queue_expiry_never_launches_the_engine():
    t = _both(_in_queue_expiry)
    assert t["calls"] == 0
    assert t["stats"]["expired_deadline"] == 1
    name, deadline_ms, waited_ms = t["outcome"]
    assert name == "DeadlineExceeded" and deadline_ms == 10.0 and waited_ms >= 10.0


def _expired_mate(impl):
    clock = FakeClock()
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=8, max_wait_ms=30.0), clock=clock)
    doomed = b.submit(_query(16, seed=1), deadline_ms=10.0)
    alive = b.submit(_query(16, seed=2))
    clock.advance(0.020)
    out = [_outcome(alive), _outcome(doomed)]
    b.stop()
    return {"outcomes": out, "calls": svc.calls, "shapes": svc.batch_shapes,
            "stats": _stats(b)}


def test_expired_request_does_not_drag_down_bucket_mates():
    t = _both(_expired_mate)
    assert t["outcomes"][0] == _expected(_query(16, seed=2))
    assert t["outcomes"][1][0] == "DeadlineExceeded"
    assert t["calls"] == 1 and t["shapes"] == [(1, 16)]
    assert t["stats"]["completed"] == 1 and t["stats"]["expired_deadline"] == 1


def _calibration_prior(impl):
    return [impl.expected_engine_seconds(n, trees) >= 0.0
            for n, trees in ((8 * 64, 900), (0, 0))]


def test_deadline_schedule_uses_the_calibration_prior():
    assert _both(_calibration_prior) == [True, True]


# -- admission control ----------------------------------------------------------


def _max_depth(impl):
    svc = FakeService()
    b = _batcher(
        impl, svc,
        impl.BucketPolicy(max_queries=64, max_wait_ms=1000.0, max_queue_depth=4),
        clock=FakeClock(),  # frozen: nothing flushes while the queue fills
    )
    futs = [b.submit(_query(16, seed=i)) for i in range(4)]
    shed = _raised(lambda: b.submit(_query(16, seed=99)))
    before = _stats(b)
    b.stop()  # the drain serves everything admitted
    return {"shed": shed, "before_stop": before, "outcomes": [_outcome(f) for f in futs],
            "shapes": svc.batch_shapes, "stats": _stats(b)}


def test_queue_at_exactly_max_depth_sheds_the_next_submit():
    t = _both(_max_depth)
    assert t["shed"] == ("Overloaded", 4, 4)
    assert t["before_stop"]["shed_overload"] == 1 and t["before_stop"]["max_queue_depth"] == 4
    assert t["outcomes"] == [_expected(_query(16, seed=i)) for i in range(4)]
    assert t["stats"]["flushes_drain"] >= 1 and t["shapes"] == [(4, 16)]


def _unbounded(impl):
    b = _batcher(
        impl, FakeService(),
        impl.BucketPolicy(max_queries=64, max_wait_ms=1000.0, max_queue_depth=None),
        clock=FakeClock(),
    )
    futs = [b.submit(_query(8, seed=i)) for i in range(64)]
    shed = b.stats.shed_overload
    b.stop()
    return {"shed": shed, "outcomes": [_outcome(f) for f in futs], "stats": _stats(b)}


def test_unbounded_policy_never_sheds():
    t = _both(_unbounded)
    assert t["shed"] == 0
    assert t["outcomes"] == [_expected(_query(8, seed=i)) for i in range(64)]


def _load_spike(impl):
    svc = FakeService()
    svc.gate = threading.Event()
    b = _batcher(impl, svc,
                 impl.BucketPolicy(max_queries=8, max_wait_ms=1.0, max_queue_depth=8),
                 clock=FakeClock())
    q = _query(16)
    futs = spike(b, 8, q)  # a full bucket: the worker takes it into the held engine
    assert svc.entered.wait(timeout=WAIT_S), "the worker never reached the engine"
    futs += spike(b, 300, q)  # 8 more fit under the bound, the rest are shed
    svc.gate.set()
    settle(futs)
    b.stop()
    return {"outcomes": [_outcome(f) for f in futs], "stats": _stats(b),
            "shed_rate": b.stats.shed_rate, "queue_depth": b.health()["queue_depth"],
            "shapes": svc.batch_shapes}


def test_load_spike_sheds_and_queue_stays_bounded():
    """The engine is held shut on a full bucket while 300 submits arrive:
    8 are admitted (the bound), the rest are shed typed, and the admitted
    ones are served once the engine opens."""
    t = _both(_load_spike)
    ok = [o for o in t["outcomes"] if o[0] == "ok"]
    shed = [o for o in t["outcomes"] if o[0] != "ok"]
    assert len(ok) == 16 and ok == [_expected(_query(16))] * 16
    assert shed == [("Overloaded", 8, 8)] * 292
    assert t["stats"]["shed_overload"] == 292 and t["stats"]["max_queue_depth"] == 8
    assert 0.0 < t["shed_rate"] < 1.0
    assert t["queue_depth"] == 0 and t["shapes"] == [(8, 16), (8, 16)]


# -- stop/submit handoff ----------------------------------------------------------


def _after_stop(impl):
    b = impl.ContinuousBatcher(FakeService(), F, impl.BucketPolicy())
    never_started = _raised(lambda: b.submit(_query(8)))
    b.start()
    b.stop()
    return [never_started, _raised(lambda: b.submit(_query(8)))]


def test_submit_after_stop_raises_typed():
    assert _both(_after_stop) == [("BatcherStopped",), ("BatcherStopped",)]


def _drain(impl):
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=64, max_wait_ms=1000.0),
                 clock=FakeClock())
    futs = [b.submit(_query(16, seed=i)) for i in range(5)]
    b.stop()
    return {"outcomes": [_outcome(f) for f in futs], "shapes": svc.batch_shapes,
            "stats": _stats(b)}


def test_stop_drains_admitted_requests():
    t = _both(_drain)
    assert t["outcomes"] == [_expected(_query(16, seed=i)) for i in range(5)]
    assert t["shapes"] == [(8, 16)] and t["stats"]["padded_query_slots"] == 3


def _submit_racing_stop(impl):
    """Submits race stop(): the trace is the reference test's invariants."""
    out = []
    for seed in range(5):
        b = _batcher(impl, FakeService(), impl.BucketPolicy(max_queries=4, max_wait_ms=0.5))
        q = _query(16, seed=seed)
        futs: list = []
        started, stop_now = threading.Event(), threading.Event()

        def hammer(b=b, q=q, futs=futs, started=started, stop_now=stop_now):
            # Spikes until told to stop, then one more: that one follows
            # stop() and must be rejected.
            while True:
                done = stop_now.wait(timeout=0.0005)
                futs.extend(spike(b, 5, q))
                started.set()
                if done:
                    return

        t = threading.Thread(target=hammer)
        t.start()
        assert started.wait(timeout=WAIT_S)
        b.stop()
        stop_now.set()
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
        outcomes = [_outcome(f) for f in futs]
        served = [o for o in outcomes if o[0] == "ok"]
        names = {o[0] for o in outcomes if o[0] != "ok"}
        out.append({
            "errors_typed": names <= {"BatcherStopped", "Overloaded"},
            "some_rejected_after_stop": "BatcherStopped" in names,
            "served_exact": all(o == _expected(q) for o in served),
            "completed_counted": b.stats.completed == len(served),
        })
    return out


def test_submit_during_drain_is_never_lost():
    """Each future resolves with a result or a typed rejection; none is
    dropped into a map nobody flushes."""
    for case in _both(_submit_racing_stop):
        assert all(case.values()), case


# -- supervisor -------------------------------------------------------------------


def _clean_exit(impl):
    ran = threading.Event()
    sup = impl.WorkerSupervisor(ran.set, backoff_base_s=0.001)
    sup.start()
    assert ran.wait(timeout=WAIT_S)
    _join(sup.stop)
    return _sup_health(sup.health())


def test_supervisor_clean_exit_is_not_a_crash():
    assert _both(_clean_exit) == (PORT.supervisor.STATE_STOPPED, False, 0, 0, None)


def _restart_budget(impl):
    runs, crashes = [], []
    failed = threading.Event()

    def target():
        runs.append(len(runs))
        raise RuntimeError(f"boom {len(runs)}")

    sup = impl.WorkerSupervisor(
        target, backoff_base_s=0.001, backoff_max_s=0.002, max_restarts=3,
        clock=FakeClock(), on_crash=crashes.append, on_failed=lambda exc: failed.set(),
    )
    sup.start()
    assert failed.wait(timeout=WAIT_S)
    before = _sup_health(sup.health())
    _join(sup.stop)
    return {"runs": len(runs), "crashes": [repr(c) for c in crashes], "health": before,
            "after_stop": sup.health().state}


def test_supervisor_restarts_until_budget_then_fails():
    t = _both(_restart_budget)
    assert t["runs"] == 4 and len(t["crashes"]) == 4  # the first run + 3 restarts
    state, healthy, restarts, crashes, last_error = t["health"]
    assert state == PORT.supervisor.STATE_FAILED and not healthy
    assert restarts == 3 and crashes == 4 and "boom 4" in last_error
    assert t["after_stop"] == PORT.supervisor.STATE_FAILED  # failure is terminal


def _stop_in_backoff(impl):
    crashed = threading.Event()

    def target():
        if not crashed.is_set():
            crashed.set()
            raise RuntimeError("one crash, then a 60 s backoff")

    sup = impl.WorkerSupervisor(target, backoff_base_s=60.0, backoff_max_s=60.0)
    sup.start()
    assert crashed.wait(timeout=WAIT_S)
    _join(sup.stop)  # wakes the sleeping guard instead of waiting 60 s
    return sup.health().state


def test_supervisor_stop_interrupts_backoff():
    assert _both(_stop_in_backoff) == PORT.supervisor.STATE_STOPPED


def _while_running(impl):
    release = threading.Event()
    sup = impl.WorkerSupervisor(lambda: release.wait(timeout=WAIT_S))
    sup.start()
    running = (sup.state, sup.health().healthy)
    release.set()
    _join(sup.stop)
    return [running, sup.state]


def test_supervisor_state_while_running():
    running, stopped = _both(_while_running)
    assert running == (PORT.supervisor.STATE_RUNNING, True)
    assert stopped == PORT.supervisor.STATE_STOPPED


def _broken_callback(impl):
    restarted, release = threading.Event(), threading.Event()
    calls = []

    def target():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("crash once")
        restarted.set()
        release.wait(timeout=WAIT_S)

    def bad_callback(exc):
        raise ValueError("observer bug")

    sup = impl.WorkerSupervisor(target, backoff_base_s=0.001, on_crash=bad_callback)
    sup.start()
    assert restarted.wait(timeout=WAIT_S)
    while_restarted = _sup_health(sup.health())
    release.set()
    _join(sup.stop)
    return [while_restarted, sup.health().state]


def test_broken_crash_callback_does_not_kill_the_guard():
    """The restarted worker blocks on an event until the state has been
    read, so ``running`` is observed while it is true (no timing race)."""
    (state, healthy, restarts, crashes, _err), after = _both(_broken_callback)
    assert state == PORT.supervisor.STATE_RUNNING and healthy
    assert crashes == 1 and restarts == 1
    assert after == PORT.supervisor.STATE_STOPPED


def _bad_backoff(impl):
    return [
        _rejects(lambda: impl.WorkerSupervisor(lambda: None, backoff_base_s=0.0)),
        _rejects(lambda: impl.WorkerSupervisor(
            lambda: None, backoff_base_s=2.0, backoff_max_s=1.0)),
        _rejects(lambda: impl.WorkerSupervisor(lambda: None, max_restarts=-1)),
        _rejects(lambda: impl.WorkerSupervisor(
            lambda: None, backoff_base_s=1.0, backoff_max_s=1.0)),
    ]


def test_supervisor_rejects_bad_backoff():
    assert _both(_bad_backoff) == [True, True, True, False]
    with pytest.raises(ValueError):
        PORT.WorkerSupervisor(lambda: None, backoff_base_s=0.0)


# -- crashes, engine errors, poison -------------------------------------------------


def _crash_restart(impl):
    svc = FakeService()
    crash = CrashTimes(1)
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=1),
                 hooks=impl.BatcherHooks(on_flush=crash), backoff_base_s=0.002,
                 clock=FakeClock())
    q = _query(16)
    lost = _outcome(b.submit(q))
    served = _outcome(b.submit(q))
    h = _health(b)
    b.stop()
    return {"outcomes": [lost, served], "fired": crash.fired, "health": h,
            "stats": _stats(b)}


def test_worker_crash_restarts_and_serves_again():
    t = _both(_crash_restart)
    assert t["outcomes"] == [("WorkerCrashed",), _expected(_query(16))]
    assert t["fired"] == 1
    h = t["health"]
    assert h["state"] == "running" and h["crashes"] == 1 and h["restarts"] == 1
    assert "InjectedCrash" in h["last_error"]
    s = t["stats"]
    assert s["worker_crashes"] == 1 and s["completed"] == 1 and s["failed"] == 1


def _crash_spares_queue(impl):
    clock = FakeClock()
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=8, max_wait_ms=5.0), clock=clock,
                 hooks=impl.BatcherHooks(on_flush=CrashTimes(1)), backoff_base_s=0.002)
    survivor = b.submit(_query(16, seed=7))  # bucket 16; its timer is frozen
    doomed = [b.submit(_query(8, seed=i)) for i in range(8)]  # a full bucket-8 flush
    lost = [_outcome(f) for f in doomed]
    clock.advance(10.0)
    served = _outcome(survivor)
    b.stop()
    return {"lost": lost, "served": served, "shapes": svc.batch_shapes, "stats": _stats(b)}


def test_queued_requests_survive_a_crash():
    """A crash fails exactly the in-flight bucket; a request queued in
    another bucket is served after the restart."""
    t = _both(_crash_spares_queue)
    assert t["lost"] == [("WorkerCrashed",)] * 8
    assert t["served"] == _expected(_query(16, seed=7))
    assert t["shapes"] == [(1, 16)]
    s = t["stats"]
    assert s["worker_crashes"] == 1 and s["completed"] == 1 and s["failed"] == 8


def _budget_exhausted(impl):
    b = _batcher(impl, FakeService(), impl.BucketPolicy(max_queries=1),
                 hooks=impl.BatcherHooks(on_flush=CrashTimes(10)), max_restarts=1,
                 backoff_base_s=0.002, clock=FakeClock())
    outcomes = [_outcome(f) for f in spike(b, 4, _query(16))]
    after = _raised(lambda: b.submit(_query(16)))
    state = b.health()["state"]
    b.stop()
    return {"outcomes": outcomes, "after": after, "state": state,
            "state_after_stop": b.health()["state"]}


def test_restart_budget_exhaustion_fails_everything_typed():
    t = _both(_budget_exhausted)
    names = [o[0] for o in t["outcomes"]]
    assert set(names) <= {"WorkerCrashed", "WorkerFailed"} and "WorkerFailed" in names
    assert t["after"] == ("WorkerFailed",)
    assert t["state"] == "failed" and t["state_after_stop"] == "failed"  # survives stop()


def _engine_error(impl):
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=2), clock=FakeClock())
    svc.fail_next(1)
    failed = [_outcome(f) for f in [b.submit(_query(8, seed=i)) for i in range(2)]]
    fut = b.submit(_query(8, seed=9))
    b.submit(_query(8, seed=10))  # fills the bucket: flushes without a timer
    served = _outcome(fut)
    crashes = b.health()["crashes"]
    b.stop()
    return {"failed": failed, "served": served, "crashes": crashes, "stats": _stats(b)}


def test_engine_error_fails_bucket_and_loop_survives():
    t = _both(_engine_error)
    assert t["failed"] == [("InjectedEngineError",)] * 2
    assert t["served"] == _expected(_query(8, seed=9))
    assert t["crashes"] == 0 and t["stats"]["worker_crashes"] == 0


def _poisoned(impl):
    svc = FakeService()
    b = _batcher(impl, svc, impl.BucketPolicy(max_queries=4), clock=FakeClock(),
                 hooks=impl.BatcherHooks(on_result=PoisonOnce()))
    futs = [b.submit(_query(16, seed=i)) for i in range(4)]
    outcomes = [_outcome(f) for f in futs]
    b.stop()
    return {"outcomes": outcomes, "calls": svc.calls, "stats": _stats(b)}


def test_poisoned_batch_fails_one_request_only():
    t = _both(_poisoned)
    assert t["outcomes"] == [("InjectedEngineError",)] + [
        _expected(_query(16, seed=i)) for i in range(1, 4)
    ]
    assert t["calls"] == 1
    s = t["stats"]
    assert s["completed"] == 3 and s["failed"] == 1 and s["worker_crashes"] == 0


def _interleaving(impl, ops):
    svc = FakeService()
    clock = FakeClock()
    crash = CrashTimes(0)
    b = _batcher(impl, svc,
                 impl.BucketPolicy(max_queries=2, max_wait_ms=0.5, max_queue_depth=16),
                 hooks=impl.BatcherHooks(on_flush=crash), max_restarts=3,
                 backoff_base_s=0.001, clock=clock)
    futs = []
    for item in ops:
        if item[0] == "submit":
            futs.extend(spike(b, 1, _query(item[1]), item[2]))
        elif item[0] == "crash":
            crash.arm()
        elif item[0] == "engine_fail":
            svc.fail_next(1)
        else:
            clock.advance(0.001)
    b.stop()
    settle(futs)  # fails if one is left unresolved
    # spike() gives one future per submit, in order.
    queries = [_query(op[1]) for op in ops if op[0] == "submit"]
    served = [(q, f.result()[1]) for q, f in zip(queries, futs) if f.exception() is None]
    return {"all_resolved": all(f.done() for f in futs),
            "served_exact": all(
                np.array_equal(s, FakeService.expected_scores(q)) for q, s in served
            )}


def test_no_future_unresolved_across_random_interleavings():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    op = st.one_of(
        st.tuples(st.just("submit"), st.integers(1, 40),
                  st.sampled_from([None, 0.0, 5.0, 1000.0])),
        st.just(("crash",)),
        st.just(("engine_fail",)),
        st.just(("advance",)),
    )

    @hypothesis.settings(max_examples=15, deadline=None, derandomize=True,
                         suppress_health_check=list(hypothesis.HealthCheck))
    @hypothesis.given(ops=st.lists(op, min_size=1, max_size=30))
    def run(ops):
        assert _both(_interleaving, ops) == {"all_resolved": True, "served_exact": True}

    run()


# -- degradation ------------------------------------------------------------------


def _controller(impl, dwell):
    svc = FakeService()
    policy = impl.DegradationPolicy(
        rungs=(impl.ExitRung("a", threshold=0.8), impl.ExitRung("b", threshold=0.9)),
        degrade_above_ms=10.0, recover_below_ms=2.0, ema_alpha=1.0, dwell_flushes=dwell,
    )
    ctrl = impl.DegradationController(svc, policy)
    ctrl.install()
    return svc, ctrl


def _dwell_steps(impl):
    svc, ctrl = _controller(impl, dwell=2)
    levels = [ctrl.observe(0.050) for _ in range(5)]
    return {"n_levels": ctrl.n_levels, "levels": levels, "rung_history": svc.rung_history,
            "snapshot": ctrl.snapshot()}


def test_controller_steps_one_rung_per_dwell_window():
    t = _both(_dwell_steps)
    assert t["n_levels"] == 3
    assert t["levels"] == [1, 1, 2, 2, 2]
    assert t["rung_history"] == [1, 2]  # set_rung only on actual moves


def _hysteresis(impl):
    svc, ctrl = _controller(impl, dwell=1)
    delays = [0.050, *[0.005] * 5, 0.001, 0.001]
    levels = [ctrl.observe(d) for d in delays]
    return {"levels": levels, "rung_history": svc.rung_history, "snapshot": ctrl.snapshot()}


def test_controller_hysteresis_band_holds_level():
    t = _both(_hysteresis)
    assert t["levels"] == [1, 1, 1, 1, 1, 1, 0, 0]  # the band holds level 1
    snap = t["snapshot"]
    assert snap["degrade_steps"] == 1 and snap["recover_steps"] == 1
    assert snap["rung"] == "baseline"


def _snapshot(impl):
    _svc, ctrl = _controller(impl, dwell=1)
    ctrl.observe(0.050)
    return ctrl.snapshot()


def test_controller_snapshot_names_the_active_rung():
    snap = _both(_snapshot)
    assert snap["level"] == 1 and snap["rung"] == "a" and snap["n_levels"] == 3
    assert snap["queue_delay_ema_ms"] == pytest.approx(50.0)
    assert snap["degrade_above_ms"] == 10.0 and snap["recover_below_ms"] == 2.0


def _policy_validation(impl):
    rungs = (impl.ExitRung("a", threshold=0.8),)
    return [
        _rejects(lambda: impl.DegradationPolicy(
            rungs=rungs, degrade_above_ms=2.0, recover_below_ms=5.0)),
        _rejects(lambda: impl.DegradationPolicy(rungs=())),
        _rejects(lambda: impl.DegradationPolicy(rungs=rungs, ema_alpha=0.0)),
        _rejects(lambda: impl.DegradationPolicy(rungs=rungs, dwell_flushes=0)),
        _rejects(lambda: impl.ExitRung("bad", threshold=1.5)),
        _rejects(lambda: impl.ExitRung("bad", dense_keep_frac=0.0)),
        _rejects(lambda: impl.ExitRung("")),
        _rejects(lambda: impl.DegradationPolicy(rungs=rungs)),
        _rejects(lambda: impl.ExitRung("ok", threshold=1.0, dense_keep_frac=1.0)),
    ]


def test_degradation_policy_validates():
    assert _both(_policy_validation) == [True] * 7 + [False] * 2
    with pytest.raises(ValueError):
        PORT.ExitRung("")


def _degrade_recover(impl):
    clock = FakeClock()
    svc = FakeService()
    policy = impl.DegradationPolicy(
        rungs=(impl.ExitRung("tight", threshold=0.9), impl.ExitRung("tighter", threshold=0.95)),
        degrade_above_ms=5.0, recover_below_ms=2.0, ema_alpha=1.0, dwell_flushes=1,
    )
    ctrl = impl.DegradationController(svc, policy, clock=clock)
    ctrl.install()
    n_rungs = svc.n_rungs
    b = _batcher(impl, svc,
                 impl.BucketPolicy(max_queries=8, max_wait_ms=1.0, max_queue_depth=None),
                 degradation=ctrl, clock=clock)
    q = _query(16)
    outcomes, levels = [], []
    for _ in range(2):  # two flushes whose oldest request waited 50 ms
        fut = b.submit(q)
        clock.advance(0.050)
        outcomes.append(_outcome(fut))
        levels.append(ctrl.level)
    for _ in range(2):  # full-bucket flushes with no queue delay
        outcomes += [_outcome(f) for f in spike(b, 8, q)]
        levels.append(ctrl.level)
    snap = ctrl.snapshot()
    b.stop()
    return {"n_rungs": n_rungs, "levels": levels, "rung_history": svc.rung_history,
            "snapshot": snap, "outcomes": outcomes, "stats": _stats(b), "health": _health(b)}


def test_load_spike_degrades_then_recovers():
    """Queue delay on the virtual clock walks the ladder down; flushes with
    no delay walk it back. The controller moves only from the worker."""
    t = _both(_degrade_recover)
    assert t["n_rungs"] == 3
    assert t["levels"] == [1, 2, 1, 0]
    assert t["rung_history"] == [1, 2, 1, 0]
    snap = t["snapshot"]
    assert snap["level"] == 0 and snap["rung"] == "baseline"
    assert snap["degrade_steps"] == 2 and snap["recover_steps"] == 2
    assert t["outcomes"] == [_expected(_query(16))] * 18


# -- clocks -------------------------------------------------------------------------


def _clocks(impl):
    c = impl.clock.MonotonicClock()
    t0 = c.now()
    cond = threading.Condition()
    with cond:
        timed_out = c.wait(cond, 0.005) is False  # a timeout, not a notify
    c.sleep(cond, 0.001)
    return [
        isinstance(impl.clock.SYSTEM_CLOCK, impl.clock.Clock),
        isinstance(c, impl.clock.Clock),
        isinstance(FakeClock(), impl.clock.Clock),
        timed_out,
        c.now() > t0,
    ]


def test_clocks_satisfy_the_protocol():
    assert _both(_clocks) == [True] * 5
