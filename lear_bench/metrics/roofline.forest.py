"""The least time of the forest work the traced requests need
(:mod:`lear_bench.work`: root-to-leaf node tests of the real documents and
the reference's survivors, each byte once, at the H100's peaks) over the
summed device time of every forest kernel launch in the traced segment,
in %. None where no forest kernel ran."""


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if tr is None or tr.forest_s <= 0:
        return None
    return 100.0 * ctx["traced_work"].least_s / tr.forest_s
