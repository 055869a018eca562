"""Device time a request of every kernel that is not a forest kernel, in
the traced segment (the profiler's kernel intervals by name)."""


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if tr is None or not tr.kernels:
        return None
    return tr.glue_s * 1e3 / ctx["traced_requests"]
