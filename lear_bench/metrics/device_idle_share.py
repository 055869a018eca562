"""Share of the measured (untraced) window in which no kernel ran on the
device, in %: one less the kernel time a request of the traced segment
(the union of its kernels' intervals, over the traced requests) times the
window's requests, over the window's seconds. Kernel durations do not move
under the profiler, while the traced segment's own idle time does (the
profiler's runtime callbacks cost the host some tens of microseconds a
launch); copies are left out, since a pageable copy's span on the device
waits on the host. None where no kernel ran (off the card)."""


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if tr is None or tr.kernel_busy_s <= 0:
        return None
    per_request = tr.kernel_busy_s / ctx["traced_requests"]
    return 100.0 * (1.0 - per_request * len(ctx["latencies_s"]) / ctx["window_s"])
