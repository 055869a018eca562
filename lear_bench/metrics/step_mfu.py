"""The operations the window's requests need (:mod:`lear_bench.work`) over
the card's ALU peak, against the measured window's wall time, in %. It
bounds a gain however the kernels are split or merged. Read in a traced
run (which checks every pool batch), and only where the device ran."""

from lear_bench.work import ALU_OPS


def read(ctx: dict) -> float | None:
    tr, work = ctx["trace"], ctx["window_work"]
    if tr is None or tr.busy_s <= 0 or work is None:
        return None
    return 100.0 * work.ops / ALU_OPS / ctx["window_s"]
