"""Peak device memory allocated in the window (``max_memory_allocated``
after a reset at its start, on the fullest card) less what the benchmark's
own input pool holds on the device, in GiB. None off the card."""


def read(ctx: dict) -> float | None:
    if not ctx["window_peak_bytes"]:
        return None
    return (ctx["window_peak_bytes"] - ctx["pool_bytes"]) / 2**30
