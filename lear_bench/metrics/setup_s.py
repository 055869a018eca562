"""Process start to the first timed request: imports, the kernel library's
build or load, weights, the input pool, the service's start with its
calibration probe, and the warm-up passes."""


def read(ctx: dict) -> float:
    return ctx["setup_s"]
