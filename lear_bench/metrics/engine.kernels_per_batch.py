"""Device kernels a request in the traced segment (copies and memsets left
out): the eager glue's launches and the forest kernels'."""


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["traced_requests"]
